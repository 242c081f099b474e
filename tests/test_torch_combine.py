"""Port's final model combination (``train/combine.py``) against the JAX
package: the candidate-set formula over a grid, the convex combination of
trees, and the fitted combination weights on the same numpy checkpoints
and minibatches in f32 (1e-4: both run Adam at lr 0.25 with ε after the
bias correction, so only summation order differs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xvector_tpu.models import tdnn as jt
from xvector_tpu.train import combine as JC
from xvector_tpu_torch.models.convert import params_from_numpy, tree_leaves
from xvector_tpu_torch.train import combine as TC

from port_helpers import model_pair, port_cfg


@pytest.mark.parametrize("num_iters,num_archives,max_models", [
    (1, 1, 20), (6, 3, 20), (10, 6, 20), (7, 2, 3), (40, 12, 20),
    (100, 80, 5), (100, 80, 20), (300, 250, 20), (9, 30, 4)])
def test_combine_iterations_matches_jax(num_iters, num_archives, max_models):
    got = TC.combine_iterations(num_iters, num_archives, max_models)
    assert got == JC.combine_iterations(num_iters, num_archives, max_models)
    assert got[-1] == num_iters


def test_combine_pytrees_weights():
    trees = [{"a": torch.full((3,), float(i)), "b": [torch.ones(2) * i]}
             for i in range(4)]
    out = TC.combine_pytrees(trees, [0.5, 0.5, 0.0, 0.0])
    torch.testing.assert_close(out["a"], torch.full((3,), 0.5))
    torch.testing.assert_close(out["b"][0], torch.full((2,), 0.5))


def test_optimize_combination_matches_jax():
    cfg = jt.MODEL_ZOO["tiny"]
    models = [model_pair(cfg, seed=s, num_classes=5) for s in range(3)]
    rng = np.random.RandomState(0)
    batches = []
    for t_len, n_rows in ((40, 6), (33, 5)):
        f = rng.randn(6, 40, 23).astype(np.float16)
        batches.append((f, rng.randint(0, 5, 6).astype(np.int32), t_len,
                        n_rows))
    _, _, jinfo = JC.optimize_combination(
        cfg, [m[0] for m in models], [m[1] for m in models], batches,
        steps=12)
    tp, ts, tinfo = TC.optimize_combination(
        port_cfg(cfg), [m[2] for m in models], [m[3] for m in models],
        batches, steps=12)
    np.testing.assert_allclose(tinfo["weights"], jinfo["weights"],
                               rtol=1e-4, atol=1e-4)
    for k in ("final_model_loss", "combined_loss"):
        np.testing.assert_allclose(tinfo[k], jinfo[k], rtol=1e-4)
    assert (tinfo["fell_back"], tinfo["steps"], tinfo["num_models"]) == \
        (jinfo["fell_back"], jinfo["steps"], jinfo["num_models"])
    # the returned trees are the weighted sums of the candidates
    w = np.asarray(tinfo["weights"], np.float32)
    want = JC.combine_pytrees([m[0] for m in models], jnp.asarray(w))
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="minibatch"):
        TC.optimize_combination(port_cfg(cfg), [models[0][2]],
                                [models[0][3]], [])


def test_optimize_combination_keeps_the_final_model_when_it_is_best():
    """Identical candidates: every combination equals the final model, so
    the fit cannot beat the baseline and the weights stay a softmax."""
    cfg = jt.MODEL_ZOO["tiny"]
    jp, js, _, _ = model_pair(cfg, num_classes=5)
    rng = np.random.RandomState(1)
    batches = [(rng.randn(4, 30, 23).astype(np.float16),
                rng.randint(0, 5, 4).astype(np.int32), 30, 4)]
    pairs = [params_from_numpy(jp, js, device="cpu") for _ in range(2)]
    _, _, info = TC.optimize_combination(
        port_cfg(cfg), [p for p, _ in pairs], [s for _, s in pairs], batches,
        steps=5)
    assert abs(sum(info["weights"]) - 1.0) < 1e-6
    assert info["combined_loss"] <= info["final_model_loss"] + 1e-6
