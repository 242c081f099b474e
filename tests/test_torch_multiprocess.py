"""Multi-process training in the port: gloo ranks in separate processes,
each feeding its own rows, over one shared work dir, against one process
and against the JAX package's mesh runs.

The first five tests mirror ``tests/test_multiprocess.py`` with the port's
``parallel/mc_harness``; then one SGD iteration at 4 ranks against 1 rank
and against upstream's ``Trainer`` on a data = 4 mesh, data 2 × model 2
with the sharded head against data 4 with the dense one
(``tests/test_scaling.py``'s bounds), and the sharded run's checkpoint
read by one process; last, who deletes in a shared work dir, and a trainer
built without a mesh inside a process group.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as W
from port_helpers import model_pair
from xvector_tpu.models import tdnn as jt
from xvector_tpu.parallel import mesh as jmesh
from xvector_tpu.train import trainer as JT
from xvector_tpu_torch.models.convert import params_to_numpy, tree_leaves
from xvector_tpu_torch.parallel import mc_harness
from xvector_tpu_torch.train import checkpoints as C
from xvector_tpu_torch.train import trainer as TR

LR = 1e-3


@pytest.fixture(scope="module")
def weights():
    jp, js, _, _ = model_pair(jt.MODEL_ZOO["tiny"], seed=0,
                              num_classes=W.NUM_SPK)
    return jp, js


def _port_trainer(tmp, weights, **fields):
    tr = TR.Trainer(TR.TrainConfig(num_targets=W.NUM_SPK, model="tiny",
                                   compute_dtype="float32", block_size=2,
                                   **fields), str(tmp), device="cpu")
    tr._place_all(*W.params_from_numpy(*weights, device="cpu"))
    return tr


def test_two_process_training_matches_single(tmp_path, weights):
    res = W.run("two", 2, {"tiny": weights, "work": str(tmp_path)},
                tmp_path)
    assert res[0] == res[1]          # both ranks see the same global state
    tr = _port_trainer(tmp_path / "single", weights)
    stats = tr.train_one_iteration(0, iter(W.scaling_batches(mb=8)), lr=LR,
                                   dropout=0.0, shrink=1.0)
    w = tr.params["embed"][0]["w"].detach().numpy()
    assert abs(stats["loss"] - res[0]["loss"]) < 5e-3
    assert abs(float(np.sum(np.abs(w))) - res[0]["checksum"]) < 1e-2


def test_multicontroller_full_contract(tmp_path):
    """Kill-and-resume at two ranks is exact against an uninterrupted
    two-rank run, and lands near the one-process run."""
    interrupted = mc_harness.run_two_process(str(tmp_path / "mc"),
                                             interrupt=True)
    straight = mc_harness.run_two_process(str(tmp_path / "mc2"),
                                          interrupt=False)
    assert interrupted["params_sha"] == straight["params_sha"]
    assert interrupted["state_sha"] == straight["state_sha"]
    assert interrupted["checksum"] == straight["checksum"]
    assert interrupted["w00"] == straight["w00"]
    assert interrupted["final_iterations"] == 4
    for u, a in interrupted["xv"].items():
        np.testing.assert_array_equal(a, straight["xv"][u])

    single = mc_harness.run_single_controller(str(tmp_path / "sc"))
    assert single["final_iterations"] == 4
    assert set(interrupted["xv"]) == set(single["xv"])
    # The drift bound of tests/test_multiprocess.py's reasoning: the runs
    # differ only in the order of the f32 sums (two ranks' halves against
    # one batch), and Adam turns that into <= ~lr steps on elements whose
    # gradient is near 0, a random walk over the run's 52 steps; a
    # semantic divergence rides the whole path (~52 lr).  The port
    # measured 10.9 lr at worst (median 0.1-0.8 lr per tensor), against
    # upstream's 4.5 lr with 8-row minibatches (ROADMAP Queue C: Adam
    # trajectories part at 8-16 rows); the exact checks are the ones above
    # and the one-step SGD test below.
    assert single["params_flat"].keys() == interrupted["params_flat"].keys()
    assert single["params_flat"]
    for name, b in single["params_flat"].items():
        a = interrupted["params_flat"][name]
        assert a.size > 0 and float(np.abs(b).max()) > 0.0, name
        assert float(np.abs(a - b).max()) / LR < 20.0, name


def test_multicontroller_final_combination(tmp_path):
    res = mc_harness.run_group(str(tmp_path / "mcc"), interrupt=False,
                               n_procs=2, final_combine=True)
    assert res["final_iterations"] == 4
    assert res["final_target"] == "model_combined"
    with open(tmp_path / "mcc" / "exp" / "metrics.jsonl") as f:
        records = [json.loads(ln) for ln in f]
    kinds = [r.get("kind") for r in records]
    assert "combine_skipped" not in kinds
    # one writer of the global records: rank 0, tagged
    assert {r.get("process") for r in records} == {0}
    assert {"valid", "train"} <= set(kinds)
    [combine] = [r for r in records if r.get("kind") == "combine"]
    n_models = combine["num_models"]
    assert n_models >= 2
    w = np.asarray(combine["weights"], np.float64)
    assert w.shape == (n_models,) and abs(w.sum() - 1.0) < 1e-5 \
        and (w >= 0).all()
    assert combine["combined_loss"] <= combine["final_model_loss"] + 1e-6
    assert len(res["xv"]) == 50
    for v in res["xv"].values():
        assert np.isfinite(v).all()
    assert os.path.exists(tmp_path / "mcc" / "exp" / "model_combined"
                          / C.CKPT)
    assert os.path.exists(tmp_path / "mcc" / "exp" / "model_combined"
                          / "done")


def test_multicontroller_empty_diag_combine_fallback(tmp_path):
    """Rank 0's diagnostics yield nothing: it signals the skip through the
    broadcast, and every rank falls back to the last iteration."""
    res = mc_harness.run_group(str(tmp_path / "mce"), interrupt=False,
                               n_procs=2, final_combine=True,
                               empty_diag=True)
    assert res["final_iterations"] == 4
    assert res["final_target"] == "model_4"
    with open(tmp_path / "mce" / "exp" / "metrics.jsonl") as f:
        records = [json.loads(ln) for ln in f]
    [skip] = [r for r in records if r.get("kind") == "combine_skipped"]
    assert skip["reason"] == "diagnostics batches yielded no data"
    assert not any(r.get("kind") == "combine" for r in records)


def test_multicontroller_four_process_contract(tmp_path):
    """Four ranks, 3 archives (one rank materialises none and still passes
    every barrier), 50 utterances in shards of 13/13/12/12; kill-and-resume
    exact against a straight four-rank run."""
    interrupted = mc_harness.run_group(str(tmp_path / "mc4"),
                                       interrupt=True, n_procs=4,
                                       num_archives=3)
    straight = mc_harness.run_group(str(tmp_path / "mc4s"),
                                    interrupt=False, n_procs=4,
                                    num_archives=3)
    assert interrupted["final_iterations"] == 6       # 2 epochs x 3
    assert interrupted["params_sha"] == straight["params_sha"]
    assert interrupted["checksum"] == straight["checksum"]
    assert interrupted["w00"] == straight["w00"]
    assert sorted(interrupted["shard_sizes"]) == [12, 12, 13, 13]
    assert len(interrupted["xv"]) == 50
    for u, a in interrupted["xv"].items():
        np.testing.assert_array_equal(a, straight["xv"][u])


# ---------------------------------------------------------------------------
# one SGD step, the sharded head, its checkpoint
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def steps(tmp_path_factory, weights):
    tmp = tmp_path_factory.mktemp("steps")
    return tmp, W.run("steps", 4, {"tiny": weights, "work": str(tmp)}, tmp)


def _leaves(tree):
    return [np.asarray(a) for a in tree_leaves(tree)]


def test_one_sgd_step_four_ranks_matches_one(steps, weights, tmp_path):
    """The strict check of tests/test_scaling.py: one SGD iteration (two
    minibatch updates), 4 ranks against 1, at 1e-6 (a mis-scaled
    collective shows 5+ orders of magnitude above)."""
    _, res = steps
    for r in res[1:]:               # every rank holds the same bits
        for a, b in zip(_leaves(r["sgd"][1]), _leaves(res[0]["sgd"][1])):
            np.testing.assert_array_equal(a, b)
    tr = _port_trainer(tmp_path, weights, optimizer="sgd", momentum=0.5)
    stats = tr.train_one_iteration(0, iter(W.scaling_batches(n=2)), lr=LR,
                                   dropout=0.0, shrink=1.0)
    loss, params, state = res[0]["sgd"]
    assert abs(stats["loss"] - loss) < 2e-5
    p1, s1 = params_to_numpy(tr.params, tr.state)
    for a, b in zip(_leaves(params) + _leaves(state),
                    _leaves(p1) + _leaves(s1)):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6)


def test_one_sgd_step_matches_jax_data4_mesh(steps, weights, tmp_path):
    """The same iteration against upstream's Trainer on a data = 4 mesh,
    from the same numpy weights, at 1e-5."""
    _, res = steps
    jp, js = weights
    jtr = JT.Trainer(JT.TrainConfig(num_targets=W.NUM_SPK, model="tiny",
                                    compute_dtype="float32", block_size=2,
                                    optimizer="sgd", momentum=0.5),
                     str(tmp_path), mesh=jmesh.make_mesh(data=4, model=1),
                     feat_dim=W.FEAT)
    jtr.params = jax.tree.map(jnp.asarray, jp)
    jtr.state = jax.tree.map(jnp.asarray, js)
    jtr.opt_state = jtr.optimizer.init(jtr.params)
    jtr._place_all()
    stats = jtr.train_one_iteration(0, iter(W.scaling_batches(n=2)), lr=LR,
                                    dropout=0.0, shrink=1.0)
    loss, params, state = res[0]["sgd"]
    assert abs(stats["loss"] - loss) < 1e-5
    # jax.tree.leaves sorts keys on both sides
    for a, b in zip(jax.tree.leaves((params, state)),
                    jax.tree.leaves((jtr.params, jtr.state))):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=1e-5)


def test_dp_vs_model_parallel_equivalence(steps):
    """data 2 × model 2 with the head's columns split against data 4 with
    the dense head: upstream's bounds (tests/test_scaling.py)."""
    _, res = steps
    loss_dp, p_dp = res[0]["dp"]
    loss_mp, p_mp = res[0]["mp"]
    assert abs(loss_dp - loss_mp) < 5e-3
    np.testing.assert_allclose(p_mp["output"]["w"], p_dp["output"]["w"],
                               atol=1e-2)
    for r in res[1:]:               # the gathered model is the same
        for a, b in zip(_leaves(r["mp"][1]), _leaves(p_mp)):
            np.testing.assert_array_equal(a, b)


def test_sharded_checkpoint_restores_in_one_process(steps):
    """The sharded run's checkpoint has the single-process layout: one
    process restores it, the head is the model ranks' blocks side by side
    and the trunk is every rank's."""
    tmp, res = steps
    tr = TR.Trainer(TR.TrainConfig(num_targets=W.NUM_SPK, model="tiny",
                                   compute_dtype="float32",
                                   head="sharded_softmax"),
                    str(tmp / "restore"), device="cpu")
    C.restore_into(tr, C.iteration_path(str(tmp / "mp"), 3))
    got, _ = params_to_numpy(tr.params, tr.state)
    blocks = [res[r]["mp_local"]["output"] for r in (0, 1)]  # model 0, 1
    np.testing.assert_array_equal(
        got["output"]["w"], np.concatenate([b["w"] for b in blocks], 1))
    np.testing.assert_array_equal(
        got["output"]["b"], np.concatenate([b["b"] for b in blocks]))
    for r in res:
        for a, b in zip(_leaves(got["frame"]),
                        _leaves(r["mp_local"]["frame"])):
            np.testing.assert_array_equal(a, b)
    # the optimizer moments came back whole too: a step runs
    st = tr.train_one_iteration(0, iter(W.scaling_batches(n=1)), lr=LR,
                                dropout=0.0, shrink=1.0)
    assert np.isfinite(st["loss"])
    assert torch.isfinite(tr.params["output"]["w"]).all()


# ---------------------------------------------------------------------------
# the coordinator in a shared work dir; a trainer without a mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def coord(tmp_path_factory, weights):
    tmp = tmp_path_factory.mktemp("coord")
    return W.run("coord", 2, {"tiny": weights, "work": str(tmp)}, tmp)


def test_only_the_coordinator_collects_garbage(coord):
    """Two ranks call ``collect_garbage`` on one work dir: rank 0 alone
    deletes (the JAX package's "one deleter"), and both then see the same
    directory."""
    assert coord[0]["deleted"] == ["model_1", "model_2", "model_3"]
    assert coord[1]["deleted"] == []
    for r in coord:
        assert r["left"] == ["model_4", "model_5", "model_final"]
        assert r["final"] == "model_5"


def test_trainer_without_mesh_in_a_group_is_one_process(coord, weights,
                                                        tmp_path):
    """Inside a two-rank group, rank 0 alone builds a ``Trainer`` with no
    mesh: it trains, saves and marks ``model_final`` as one process (a
    collective would hang it: rank 1 joins none), with one process's
    numbers."""
    solo = coord[0]["solo"]
    assert (solo["size"], solo["done"], solo["final"]) == (1, True,
                                                           "model_1")
    tr = _port_trainer(tmp_path, weights, optimizer="sgd", momentum=0.5)
    st = tr.train_one_iteration(0, iter(W.scaling_batches(n=2, mb=8)),
                                lr=LR, dropout=0.0, shrink=1.0)
    assert solo["loss"] == pytest.approx(st["loss"], rel=1e-6)
    got, _ = params_to_numpy(tr.params, tr.state)
    for a, b in zip(_leaves(solo["params"]), _leaves(got)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
