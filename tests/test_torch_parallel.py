"""The port's multi-GPU pieces held to the JAX package on the CPU: gloo
ranks in separate processes, joined through a file store, against the JAX
package's virtual 8-device mesh on the same numpy inputs.

* ``models/heads.sharded_softmax_ce`` on model = 4 against upstream's on a
  (data 2, model 4) mesh (``tests/test_sharded_head.py``'s four cases);
* global batch-norm moments and a train-mode ``apply`` forward and
  backward, 4 ranks against one process;
* ``parallel/seqshard`` at 4 ranks against upstream's at data = 4 and the
  unsharded x-vector (``tests/test_seqshard.py``'s five cases);
* ``parallel/launch``'s row and archive shares against upstream's;
* ``parallel/mesh``: NCCL with two ranks on one device refused, layouts
  and collectives, the head's columns split and gathered, a group joined
  through a ``tcp://`` address.

Each group of ranks runs once per module and its cases are read by the
tests below; a group that hangs is killed at its timeout.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as W
from port_helpers import model_pair, port_cfg
from xvector_tpu.models import heads as JH
from xvector_tpu.models import tdnn as jt
from xvector_tpu.parallel import launch as jlaunch
from xvector_tpu.parallel import mesh as jmesh
from xvector_tpu.parallel.seqshard import seq_sharded_xvector as j_seq
from xvector_tpu_torch.models import heads as TH
from xvector_tpu_torch.models import tdnn as tt
from xvector_tpu_torch.models.convert import params_from_numpy, tree_leaves
from xvector_tpu_torch.parallel import mc_harness

WORLD = 4
TIMEOUT_S = 100


def _seqshard_inputs():
    """``tests/test_seqshard.py``'s models and inputs (numpy)."""
    cfg = jt.MODEL_ZOO["tiny"]
    p, s = jt.init_params(jax.random.PRNGKey(0), cfg, 7)
    s = jax.tree.map(lambda a: a + 0.05 * np.random.RandomState(1)
                     .rand(*a.shape).astype(np.float32), s)
    tiny = (jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, s))
    out = {}
    rng = np.random.RandomState(0)
    out["full"] = (cfg, *tiny, rng.randn(800, 23).astype(np.float32), None)
    rng = np.random.RandomState(2)
    x = np.zeros((800, 23), np.float32)
    x[:700] = rng.randn(700, 23)
    out["padded"] = (cfg, *tiny, x, 700)
    dil = replace(jt.MODEL_ZOO["tdnn_dilated"], channels=(8, 8, 8, 8, 24),
                  embed_dims=(16, 16), feat_dim=23)
    p, s = jt.init_params(jax.random.PRNGKey(3), dil, 5)
    out["dilated"] = (dil, jax.tree.map(np.asarray, p),
                      jax.tree.map(np.asarray, s),
                      np.random.RandomState(4).randn(400, 23)
                      .astype(np.float32), None)
    att = replace(jt.MODEL_ZOO["l2_lrelu_attention"],
                  channels=(8, 8, 8, 8, 48), embed_dims=(16, 16))
    p, s = jt.init_params(jax.random.PRNGKey(5), att, 5)
    rng = np.random.RandomState(6)
    x = np.zeros((800, 23), np.float32)
    x[:750] = rng.randn(750, 23)
    out["attention"] = (att, jax.tree.map(np.asarray, p),
                        jax.tree.map(np.asarray, s), x, 750)
    out["indivisible"] = (cfg, *tiny, np.zeros((801, 23), np.float32),
                          None)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each group's per-rank results, and the inputs they were made from."""
    tmp = tmp_path_factory.mktemp("parallel")
    jp, js, _, _ = model_pair(jt.MODEL_ZOO["tiny"], seed=0,
                              num_classes=W.NUM_SPK)
    seq = _seqshard_inputs()
    inputs = {"tiny": (jp, js),
              "seqshard": {k: ({**{f: getattr(c, f) for f in (
                  "kernel_sizes", "dilations", "channels", "embed_dims",
                  "feat_dim")}, "preset": c.name}, p, s, x, v)
                  for k, (c, p, s, x, v) in seq.items()}}
    out = {"inputs": inputs, "seq": seq}
    for group, world in (("heads", WORLD), ("data", WORLD), ("nccl", 2)):
        out[group] = W.run(group, world, inputs, tmp, timeout=TIMEOUT_S)
    return out


# ---------------------------------------------------------------------------
# the sharded head (tests/test_sharded_head.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_head():
    mesh = jmesh.make_mesh(data=2, model=4)
    h, w, b, y = (jnp.asarray(a) for a in W.head_inputs())
    return mesh, h, w, b, y


def test_sharded_ce_matches_dense(runs, jax_head):
    mesh, h, w, b, y = jax_head
    ce, acc = JH.sharded_softmax_ce(h, w, b, y, mesh)
    for r in runs["heads"]:
        assert r["ce"] == pytest.approx(float(ce), rel=1e-5)
        assert r["acc"] == float(acc)
        assert r["ce"] == pytest.approx(
            float(JH.softmax_ce(h @ w + b, y)), rel=1e-5)


def test_sharded_ce_row_weights(runs, jax_head):
    mesh, h, w, b, y = jax_head
    rw = jnp.asarray([1.0] * 12 + [0.0] * 4, jnp.float32)
    ce, acc = JH.sharded_softmax_ce(h, w, b, y, mesh, row_weight=rw)
    for r in runs["heads"]:
        assert r["ce_rw"] == pytest.approx(float(ce), rel=1e-5)
        assert r["acc_rw"] == float(acc)


@pytest.mark.parametrize("arg", [0, 1, 2], ids=["hidden", "weight", "bias"])
def test_sharded_ce_gradients_match(runs, jax_head, arg):
    """dL/dhidden is whole on every rank; each rank's weight and bias
    gradients fill its own columns, side by side the JAX gradients."""
    mesh, h, w, b, y = jax_head
    want = jax.jit(jax.grad(lambda *a: JH.sharded_softmax_ce(
        *a, y, mesh)[0], argnums=(0, 1, 2)))(h, w, b)[arg]
    grads = [r["grads"][arg] for r in runs["heads"]]
    if arg == 0:
        for g in grads:
            np.testing.assert_allclose(g, np.asarray(want), atol=1e-5)
        return
    cols = np.asarray(want).shape[-1] // WORLD
    for i, g in enumerate(grads):
        mine = np.zeros_like(g)
        sl = (..., slice(i * cols, (i + 1) * cols))
        mine[sl] = g[sl]
        np.testing.assert_array_equal(g, mine)    # nothing outside its block
    np.testing.assert_allclose(sum(grads), np.asarray(want), atol=1e-5)


def test_sharded_ce_rejects_indivisible(runs, jax_head):
    mesh, h, w, b, y = jax_head
    with pytest.raises(ValueError):
        JH.sharded_softmax_ce(h, w[:, :63], b[:63], y, mesh)
    for r in runs["heads"]:
        assert "not divisible by model=4" in r["indivisible"]


def test_head_columns_split_and_gathered(runs):
    params, _ = runs["inputs"]["tiny"]
    for i, r in enumerate(runs["heads"]):
        np.testing.assert_array_equal(r["local_head"]["w"],
                                      params["output"]["w"][:, 2 * i:2 * i + 2])
        np.testing.assert_array_equal(r["local_head"]["b"],
                                      params["output"]["b"][2 * i:2 * i + 2])
        for a, b in zip(jax.tree.leaves(r["regathered"]),
                        jax.tree.leaves(params)):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# global batch-norm moments, train-mode apply
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("centered", [True, False])
def test_global_bn_moments(runs, centered):
    x, mask, a, wv = W.bn_inputs()
    xt = torch.from_numpy(x).requires_grad_(True)
    mean, var = tt._masked_moments(xt, torch.from_numpy(mask)[..., None],
                                   (0, 1), centered=centered)
    ((mean * torch.from_numpy(a)).sum()
     + (var * torch.from_numpy(wv)).sum()).backward()
    per = x.shape[0] // WORLD
    for i, r in enumerate(runs["data"]):
        m, v, gx = r[f"moments_{centered}"]
        np.testing.assert_allclose(m, mean.detach().numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(v, var.detach().numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(gx, xt.grad[i * per:(i + 1) * per],
                                   rtol=1e-6, atol=1e-6)
    # the JAX package's moments (E[x²]−mean²) on the same rows
    jm, jv = jt._masked_moments(jnp.asarray(x), jnp.asarray(mask)[..., None],
                                (0, 1))
    np.testing.assert_allclose(runs["data"][0][f"moments_{centered}"][0],
                               np.asarray(jm), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(runs["data"][0][f"moments_{centered}"][1],
                               np.asarray(jv), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("masked", [True, False])
def test_train_apply_forward_backward_global(runs, masked):
    """W ranks' train-mode forward (hidden rows, the new BN state, the
    global CE) and backward (input rows, gradients summed over ranks)
    equal one process's on the whole batch at 1e-6, in float64 (a lost or
    doubled collective shows at O(1))."""
    cfg = tt.MODEL_ZOO["tiny"]
    params, state = params_from_numpy(*runs["inputs"]["tiny"], device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    x, y, m, wt = W.train_inputs()
    xt = torch.from_numpy(x.astype(np.float64)).requires_grad_(True)
    res = tt.apply(cfg, params, state, xt,
                   mask=torch.from_numpy(m) if masked else None,
                   row_weight=torch.from_numpy(wt) if masked else None,
                   train=True, compute_dtype=torch.float64)
    loss = TH.softmax_ce(res["logits"], torch.from_numpy(y),
                         torch.from_numpy(wt) if masked else None)
    grads = torch.autograd.grad(loss, [xt] + tree_leaves(params))
    per = x.shape[0] // WORLD
    for i, r in enumerate(runs["data"]):
        r_loss, hidden, new_state, gx, pg = r[f"apply_{masked}"]
        assert r_loss == pytest.approx(loss.item(), rel=1e-6, abs=1e-6)
        np.testing.assert_allclose(
            hidden, res["hidden"][i * per:(i + 1) * per].detach().numpy(),
            rtol=1e-6, atol=1e-6)
        for a, b in zip(tree_leaves(new_state),
                        tree_leaves(res["state"])):
            np.testing.assert_allclose(a, b.detach().numpy(), rtol=1e-6,
                                       atol=1e-6)
        np.testing.assert_allclose(gx, grads[0][i * per:(i + 1) * per],
                                   rtol=1e-6, atol=1e-6)
        for a, b in zip(pg, grads[1:]):
            np.testing.assert_allclose(a, b.numpy(), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# sequence-sharded extraction (tests/test_seqshard.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["full", "padded", "dilated", "attention"])
def test_seq_sharded_xvector(runs, case):
    cfg, p, s, x, valid = runs["seq"][case]
    got = [r[f"seq_{case}"] for r in runs["data"]]
    for g in got[1:]:
        np.testing.assert_array_equal(g, got[0])   # the same on every rank
    # jitted: upstream's shard_map run eagerly takes ~15 s a call here
    fn = jax.jit(j_seq, static_argnums=(0, 4), static_argnames=("valid_len",))
    want_sharded = np.asarray(fn(cfg, p, s, x, jmesh.make_mesh(data=4),
                                 valid_len=valid))
    n = len(x) if valid is None else valid
    want_full = np.asarray(jt.extract_xvector(cfg, p, s, x[None, :n]))[0]
    np.testing.assert_allclose(got[0], want_sharded, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[0], want_full, rtol=1e-4, atol=1e-4)
    # and the port's own unsharded x-vector
    tp, ts = params_from_numpy(p, s, device="cpu")
    mine = tt.extract_xvector(port_cfg(cfg), tp, ts,
                              torch.from_numpy(x[None, :n]))[0]
    np.testing.assert_allclose(got[0], mine.numpy(), rtol=1e-4, atol=1e-4)


def test_seq_sharded_rejects_indivisible(runs):
    cfg, p, s, x, _ = runs["seq"]["indivisible"]
    with pytest.raises(ValueError):
        j_seq(cfg, p, s, x, jmesh.make_mesh(data=4))
    for r in runs["data"]:
        assert "not divisible by data=4" in r["seq_indivisible"]


# ---------------------------------------------------------------------------
# launch and mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rank", range(WORLD))
def test_launch_shares_match_jax(runs, monkeypatch, rank):
    """Each rank's rows and archives are upstream's for the same process
    index and count."""
    monkeypatch.setattr(jax, "process_index", lambda: rank)
    monkeypatch.setattr(jax, "process_count", lambda: WORLD)
    got = runs["data"][rank]["launch"]
    assert got["slice64"] == jlaunch.host_local_batch_slice(64)
    assert got["slice64_mesh"] == jlaunch.host_local_batch_slice(64)
    assert got["archives5"] == jlaunch.shard_archives(5)
    assert got["archives3"] == jlaunch.shard_archives(3)
    assert got["coordinator"] == jlaunch.is_coordinator()
    with pytest.raises(ValueError):
        jlaunch.host_local_batch_slice(63)
    assert "not divisible" in got["slice63"]


def test_mesh_layouts_and_collectives(runs):
    xb = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    for i, r in enumerate(runs["data"]):
        assert r["coords"] == (i, 0, WORLD)
        np.testing.assert_array_equal(r["put_batch"], xb[2 * i:2 * i + 2])
        assert not r["put_global"]["a"].any()      # rank 0's zeros
        assert not r["put_global"]["b"][0].any()
        np.testing.assert_array_equal(r["gather"],
                                      np.arange(WORLD)[None].repeat(2, 0))
        np.testing.assert_array_equal(r["max"], [WORLD - 1, 0])


def test_nccl_two_ranks_on_one_device_raise(runs):
    for r in runs["nccl"]:
        assert "several ranks on one device" in r["raised"]


def test_tcp_rendezvous(tmp_path):
    """``init_distributed`` joins a group through a ``tcp://`` address as
    through a store file."""
    res = W.run("tcp", 2, {}, tmp_path, timeout=TIMEOUT_S,
                init=f"tcp://localhost:{mc_harness._free_port()}")
    assert [(r["sum"], r["world"]) for r in res] == [(3.0, 2), (3.0, 2)]
