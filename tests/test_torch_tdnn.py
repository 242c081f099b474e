"""Port's eval-mode TDNN (xvector_tpu_torch.models.tdnn) against the JAX
reference (xvector_tpu.models.tdnn) on the same numpy weights and inputs,
in f32 with frame masks.  Tolerance 1e-4 (rtol and atol)."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xvector_tpu.models import tdnn as jt
from xvector_tpu_torch.models import tdnn as tt

from port_helpers import model_pair, port_cfg

TOL = dict(rtol=1e-4, atol=1e-4)

MINI = dict(channels=(8, 8, 8, 8, 24), embed_dims=(12, 12))
CONFIGS = {
    "tiny": {},
    "dilated_mini": dict(kernel_sizes=(5, 3, 3, 1, 1),
                         dilations=(1, 2, 3, 1, 1), **MINI),
    "prelu_mini": dict(activation="prelu", **MINI),
    "lrelu_mini": dict(activation="lrelu", **MINI),
}


def _cfg(name):
    return replace(jt.MODEL_ZOO["tiny"], name=name, **CONFIGS[name])


def inputs(b=3, t=41, f=23, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, t, f).astype(np.float32)
    mask = np.ones((b, t), np.float32)
    mask[1, 30:] = 0.0                       # padded tail
    mask[2, rng.rand(t) < 0.2] = 0.0         # scattered masked frames
    return x, mask


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_frame_stack_and_xvector_match_jax(name):
    cfg = _cfg(name)
    jp, js, tp, ts = model_pair(cfg)
    x, mask = inputs()
    x_j, m_j = jnp.asarray(x), jnp.asarray(mask)
    want_h = np.asarray(jax.jit(jt.frame_stack, static_argnums=0)(
        cfg, jp, js, x_j, m_j))
    want_xv = np.asarray(jax.jit(jt.extract_xvector, static_argnums=0)(
        cfg, jp, js, x_j, m_j))
    pcfg = port_cfg(cfg)
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    got_h = tt.frame_stack(pcfg, tp, ts, xt, mt).numpy()
    got_xv = tt.extract_xvector(pcfg, tp, ts, xt, mt).numpy()
    assert got_xv.dtype == np.float32 and got_xv.shape == want_xv.shape
    np.testing.assert_allclose(got_h, want_h, **TOL)
    np.testing.assert_allclose(got_xv, want_xv, **TOL)


@pytest.mark.parametrize("k,cin,dil", [(1, 16, 1), (5, 23, 1), (3, 40, 2),
                                       (7, 24, 1)])
def test_conv1d_same_both_lowerings(k, cin, dil):
    """k·Cin ≤ 160 takes the unfold-to-one-matmul lowering, wider inputs
    the k shifted matmuls."""
    rng = np.random.RandomState(k * 100 + cin)
    x = rng.randn(2, 19, cin).astype(np.float32)
    w = (0.1 * rng.randn(k, cin, 6)).astype(np.float32)
    want = np.asarray(jt._conv1d_same(jnp.asarray(x), jnp.asarray(w), dil))
    got = tt._conv1d_same(torch.from_numpy(x), torch.from_numpy(w),
                          dil).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_stats_pooling_with_masked_row():
    rng = np.random.RandomState(3)
    h = (rng.randn(3, 17, 5) * 2 + 1).astype(np.float32)
    mask = np.ones((3, 17, 1), np.float32)
    mask[0] = 0.0                     # fully masked row: count clamps to 1
    mask[2, 9:] = 0.0
    want = np.asarray(jt.stats_pooling(jnp.asarray(h), jnp.asarray(mask)))
    got = tt.stats_pooling(torch.from_numpy(h),
                           torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(
        tt.stats_pooling(torch.from_numpy(h)).numpy(),
        np.asarray(jt.stats_pooling(jnp.asarray(h))), **TOL)


@pytest.mark.parametrize("cfg", [
    jt.MODEL_ZOO["tiny"],
    replace(jt.MODEL_ZOO["tiny"], init="he", activation="prelu"),
    replace(jt.MODEL_ZOO["l2_lrelu_attention"], channels=(8, 8, 8, 8, 16),
            embed_dims=(12, 12)),
], ids=["tiny", "he_prelu", "attention"])
def test_init_params_shapes_match_jax(cfg):
    jp, js = jt.init_params(jax.random.PRNGKey(0), cfg, 9)
    tp, ts = tt.init_params(torch.Generator().manual_seed(0), port_cfg(cfg),
                            9, device="cpu")
    shapes = lambda tree: [tuple(np.shape(a)) for a in jax.tree.leaves(tree)]
    torch_shapes = lambda tree: [tuple(a.shape) for a in jax.tree.leaves(tree)]
    assert torch_shapes(tp) == shapes(jp)
    assert torch_shapes(ts) == shapes(js)
    w0 = tp["frame"][0]["w"]
    std = float(np.std(np.asarray(jp["frame"][0]["w"])))
    assert abs(float(w0.std()) - std) < 0.2 * std   # same distribution
    assert float(w0.abs().max()) <= 2 * (0.1 if cfg.init != "he" else
                                         np.sqrt(2.0 / (5 * 23))) + 1e-6


def test_extract_xvector_rejects_attention_pooling():
    cfg = replace(tt.MODEL_ZOO["l2_lrelu_attention"],
                  channels=(8, 8, 8, 8, 16), embed_dims=(12, 12))
    tp, ts = tt.init_params(torch.Generator().manual_seed(0), cfg, 3,
                            device="cpu")
    with pytest.raises(NotImplementedError):
        tt.extract_xvector(cfg, tp, ts, torch.zeros(1, 30, 23))
