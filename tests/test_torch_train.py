"""Port's training slice (train-mode ``apply``, ``fold_bn_state``, heads,
loss gradients, optimizers, schedules, the block step, one training
iteration, XTA archives) against the JAX package, on the same numpy
weights and inputs, in f32 on the CPU.

Tolerances.  Forward values, BN states, gradients and parameters after
SGD steps: max |port − JAX| ≤ 1e-4 · max |JAX| for each tensor (a fixed
ceiling per tensor, ROADMAP C2: it does not scale with the error).  Train
-mode batch norm over a few rows amplifies f32 summation-order noise: at
these sizes both packages sit 1e-4-4e-4 (elementwise, relative) from an f64
evaluation of the same model, so an elementwise 1e-4 would test the noise.
1e-6 relative for the optimizers' own arithmetic.  After Adam steps a
parameter may move by O(lr) where its gradient is ulp-level noise (one
Adam step turns the noise's sign into ±lr), so the Adam block is run at
lr 1e-3 and compared at atol = 2·lr·steps, with all but 1% of elements
within 1e-4."""

import os
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from xvector_tpu.data import archives as JA
from xvector_tpu.models import heads as JH
from xvector_tpu.models import tdnn as jt
from xvector_tpu.train import schedules as JS
from xvector_tpu.train import trainer as JT
from xvector_tpu.train.tf_adam import tf_adam
from xvector_tpu_torch.data import archives as TA
from xvector_tpu_torch.models import heads as TH
from xvector_tpu_torch.models import tdnn as tt
from xvector_tpu_torch.models.convert import (params_from_numpy,
                                              params_to_numpy, tree_leaves)
from xvector_tpu_torch.train import optim as TO
from xvector_tpu_torch.train import schedules as TS
from xvector_tpu_torch.train import trainer as TR

from port_helpers import model_pair, port_cfg

NORM_TOL = 1e-4
NUM_CLASSES = 7

# an L2 preset at a narrow width (layer 1: k·Cin = 5·40 > 160)
L2_MINI = replace(jt.MODEL_ZOO["l2_lrelu"], name="l2_lrelu_mini",
                  channels=(40, 40, 40, 40, 64), embed_dims=(24, 24))
CONFIGS = {"tiny": jt.MODEL_ZOO["tiny"], "l2_lrelu_mini": L2_MINI}


def _batch(b=16, t=30, seed=0, num_classes=NUM_CLASSES):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, t, 23).astype(np.float32),
            rng.randint(0, num_classes, b).astype(np.int32))


def _close(got, want, **tol):
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


def _close_norm(got, want, tol=NORM_TOL):
    """max |got − want| ≤ tol · max |want| for every leaf pair."""
    got, want = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-3), \
            (np.abs(a - b).max(), np.abs(b).max())


def _np(tree):
    return jax.tree.map(lambda t: t.detach().numpy(), tree)


@pytest.mark.parametrize("stats_out", [False, True])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_train_apply_matches_jax(name, stats_out):
    cfg = CONFIGS[name]
    jp, js, tp, ts = model_pair(cfg, num_classes=NUM_CLASSES)
    x, _ = _batch()
    mask = np.ones(x.shape[:2], np.float32)
    mask[1, 20:] = 0.0
    row_weight = np.ones(x.shape[0], np.float32)
    row_weight[-2:] = 0.0
    want = jt.apply(cfg, jp, js, jnp.asarray(x), mask=jnp.asarray(mask),
                    row_weight=jnp.asarray(row_weight), train=True,
                    bn_stats_out=stats_out)
    got = tt.apply(port_cfg(cfg), tp, ts, torch.from_numpy(x),
                   mask=torch.from_numpy(mask),
                   row_weight=torch.from_numpy(row_weight), train=True,
                   bn_stats_out=stats_out, fused_conv_bwd=True)
    _close_norm([got[k].numpy() for k in ("logits", "xvector", "pooled",
                                          "l2_loss")],
                [want[k] for k in ("logits", "xvector", "pooled", "l2_loss")])
    _close_norm(_np(got["state"]), want["state"])
    if cfg.l2_beta:
        assert float(got["l2_loss"]) > 0.0


def test_eval_apply_matches_jax():
    cfg = L2_MINI
    jp, js, tp, ts = model_pair(cfg, num_classes=NUM_CLASSES)
    x, _ = _batch(seed=1)
    want = jt.apply(cfg, jp, js, jnp.asarray(x))
    got = tt.apply(port_cfg(cfg), tp, ts, torch.from_numpy(x))
    _close_norm(got["logits"].numpy(), want["logits"])
    assert got["state"] is not None


def test_fold_bn_state_matches_jax():
    rng = np.random.RandomState(0)
    state0 = {"frame": [{"mean": rng.randn(5).astype(np.float32),
                         "var": rng.rand(5).astype(np.float32)}],
              "embed": [{"mean": rng.randn(3).astype(np.float32),
                         "var": rng.rand(3).astype(np.float32)}]}
    stacked = jax.tree.map(
        lambda a: rng.randn(6, *a.shape).astype(np.float32), state0)
    want = jt.fold_bn_state(state0, stacked, 0.95)
    got = tt.fold_bn_state(jax.tree.map(torch.from_numpy, state0),
                           jax.tree.map(torch.from_numpy, stacked), 0.95)
    _close(_np(got), want, rtol=1e-6, atol=1e-6)


def test_heads_match_jax():
    rng = np.random.RandomState(0)
    logits = (3 * rng.randn(6, 9)).astype(np.float32)
    labels = rng.randint(0, 9, 6).astype(np.int32)
    labels[:3] = logits[:3].argmax(-1)
    weight = np.array([1, 1, 0, 1, 0, 1], np.float32)
    for w in (None, weight):
        jw = None if w is None else jnp.asarray(w)
        tw = None if w is None else torch.from_numpy(w)
        args_j = (jnp.asarray(logits), jnp.asarray(labels), jw)
        args_t = (torch.from_numpy(logits), torch.from_numpy(labels), tw)
        np.testing.assert_allclose(float(TH.softmax_ce(*args_t)),
                                   float(JH.softmax_ce(*args_j)), rtol=1e-6)
        assert float(TH.accuracy(*args_t)) == float(JH.accuracy(*args_j))


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_loss_gradients_match_jax(name, dense):
    cfg = CONFIGS[name]
    jp, js, tp, ts = model_pair(cfg, num_classes=NUM_CLASSES)
    x, y = _batch()
    t_len, n_rows = (30, 16) if dense else (24, 13)
    jcfg = JT.TrainConfig(model=name, num_targets=NUM_CLASSES,
                          compute_dtype="float32")
    tcfg = TR.TrainConfig(model=name, num_targets=NUM_CLASSES,
                          compute_dtype="float32")

    def jloss(p):
        return JT._loss_fn(cfg, jcfg, p, js, jnp.asarray(x), jnp.asarray(y),
                           jnp.int32(t_len), jnp.int32(n_rows),
                           jnp.float32(1.0), jax.random.PRNGKey(0),
                           dense=dense)[0]

    want_loss, want = jax.value_and_grad(jloss)(jp)
    for p in tree_leaves(tp):
        p.requires_grad_(True)
    loss, _ = TR._loss_fn(port_cfg(cfg), tcfg, tp, ts, torch.from_numpy(x),
                          torch.from_numpy(y), t_len, n_rows, 1.0, None,
                          dense=dense)
    grads = torch.autograd.grad(loss, tree_leaves(tp))
    _close_norm(loss.detach().numpy(), want_loss)
    _close_norm([g.numpy() for g in grads], want)


OPTIMIZERS = {
    "adam": optax.adam,
    "tf_adam": tf_adam,
    "sgd": lambda learning_rate: optax.sgd(learning_rate, momentum=0.5),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizers_match_optax(name):
    rng = np.random.RandomState(0)
    params = {"a": rng.randn(4, 3).astype(np.float32),
              "b": [rng.randn(5).astype(np.float32)]}
    # ulp-scale gradients in one row pin Adam's ε placement
    grads = [jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32),
                          params) for _ in range(4)]
    for g in grads:
        g["a"][0] *= 1e-9
    lrs = [1e-2, 5e-3, 2e-3, 1e-3]
    opt = optax.inject_hyperparams(OPTIMIZERS[name])(learning_rate=lrs[0])
    jp, state = params, opt.init(params)
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), params)
    topt = TO.make_optimizer(name, tree_leaves(tp), lrs[0], momentum=0.5)
    for g, lr in zip(grads, lrs):
        state.hyperparams["learning_rate"] = lr
        upd, state = opt.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, gl in zip(tree_leaves(tp), jax.tree.leaves(g)):
            p.grad = torch.from_numpy(gl)
        TO.set_learning_rate(topt, lr)
        topt.step()
    _close(_np(tp), jp, rtol=1e-6, atol=1e-7)


def test_adam_moments_dtype_not_ported():
    """adam_moments_dtype="bfloat16" against ``optax.adam(mu_dtype=
    bfloat16)``: the first moment stored in bf16, the second in f32, the
    update from the f32 first moment (1e-6, the optimizers' bound)."""
    rng = np.random.RandomState(1)
    params = {"a": rng.randn(4, 3).astype(np.float32),
              "b": [rng.randn(5).astype(np.float32)]}
    grads = [jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32),
                          params) for _ in range(5)]
    lrs = [1e-2, 5e-3, 2e-3, 1e-3, 1e-3]
    opt = optax.inject_hyperparams(
        lambda learning_rate: optax.adam(learning_rate,
                                         mu_dtype=jnp.bfloat16))(
        learning_rate=lrs[0])
    jp, state = params, opt.init(params)
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), params)
    topt = TO.make_optimizer("adam", tree_leaves(tp), lrs[0],
                             moments_dtype="bfloat16")
    for g, lr in zip(grads, lrs):
        state.hyperparams["learning_rate"] = lr
        upd, state = opt.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, gl in zip(tree_leaves(tp), jax.tree.leaves(g)):
            p.grad = torch.from_numpy(gl)
        TO.set_learning_rate(topt, lr)
        topt.step()
    _close(_np(tp), jp, rtol=1e-6, atol=1e-7)
    mus = [topt.state[p]["mu"] for p in tree_leaves(tp)]
    assert all(m.dtype == torch.bfloat16 for m in mus)
    _close([m.float().numpy() for m in mus],
           [np.asarray(m, np.float32)
            for m in jax.tree.leaves(state.inner_state[0].mu)],
           rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="adam_moments_dtype"):
        TO.make_optimizer("adam", tree_leaves(tp), 1e-3,
                          moments_dtype="float16")


def test_schedules_match_jax():
    for n in range(0, 25, 3):
        for final in (False, True):
            args = (n, 24, 1e-3, 1e-4, 2, final)
            assert TS.learning_rate(*args) == JS.learning_rate(*args)
    for spec in ("0,0@0.10,0.1@0.50,0", "0.2", "0,0.1,0", "",
                 "0,0.1@0.5,0.2@0.5,0"):
        points = TS.parse_dropout_schedule(spec)
        assert points == JS.parse_dropout_schedule(spec)
        for f in np.linspace(0.0, 1.0, 21):
            assert TS.dropout_proportion(points, float(f)) == \
                JS.dropout_proportion(points, float(f))
    assert TS.shrink_value(10.0, 1e-3) == JS.shrink_value(10.0, 1e-3)
    with pytest.raises(ValueError):
        TS.shrink_value(1000.0, 1e-3)


def _block_inputs(n=4, b=16, t=24, seed=3):
    rng = np.random.RandomState(seed)
    xs = rng.randn(n, b, t, 23).astype(np.float32)
    ys = rng.randint(0, NUM_CLASSES, (n, b)).astype(np.int32)
    return xs, ys


@pytest.mark.parametrize("optimizer,dense", [("sgd", False), ("sgd", True),
                                             ("adam", False)])
def test_block_step_matches_jax(optimizer, dense):
    cfg = jt.MODEL_ZOO["tiny"]
    jp, js, tp, ts = model_pair(cfg, num_classes=NUM_CLASSES)
    xs, ys = _block_inputs()
    t_lens = [24, 20, 24, 17] if not dense else [24] * 4
    n_rows = [16, 13, 16, 16] if not dense else [16] * 4
    # Adam at 1e-2 lets the ±lr moves of noise-driven parameters revive
    # dead units and the two trajectories part; at 1e-3 they stay O(lr)
    lr = 1e-2 if optimizer == "sgd" else 1e-3
    kw = dict(model="tiny", num_targets=NUM_CLASSES, compute_dtype="float32",
              optimizer=optimizer)
    jcfg, tcfg = JT.TrainConfig(**kw), TR.TrainConfig(**kw)
    jopt = optax.inject_hyperparams(
        lambda learning_rate: optax.sgd(learning_rate, momentum=0.5)
        if optimizer == "sgd" else optax.adam(learning_rate))(
            learning_rate=lr)
    block = JT.make_block_train_step(cfg, jcfg, jopt, dense=dense)
    jp2, _, js2, jm = block(
        jax.tree.map(jnp.asarray, jp), jopt.init(jp), js, jnp.asarray(xs),
        jnp.asarray(ys), jnp.asarray(t_lens, jnp.int32),
        jnp.asarray(n_rows, jnp.int32), jnp.float32(lr), jnp.float32(1.0),
        jnp.float32(1.0), jax.random.PRNGKey(0))
    for p in tree_leaves(tp):
        p.requires_grad_(True)
    topt = TO.make_optimizer(optimizer, tree_leaves(tp), lr, momentum=0.5)
    ts2, tm = TR.make_block_train_step(port_cfg(cfg), tcfg, dense=dense)(
        tp, topt, ts, torch.from_numpy(xs), torch.from_numpy(ys), t_lens,
        n_rows, lr, 1.0, 1.0, None)
    _close_norm(tm["loss"].numpy(), jm["loss"])
    if optimizer == "sgd":
        _close_norm(_np(ts2), js2)
        _close_norm(_np(tp), jp2)
        return
    # Adam: all but O(lr) outliers agree tightly.  tiny's embed-0 layer has
    # dead ReLU units whose weight and bias gradients are ulp-level noise;
    # their ±lr moves shift the later steps' batch moments by O(lr) too.
    for got, want in ((_np(tp), jp2), (_np(ts2), js2)):
        _close(got, want, rtol=1e-4, atol=2 * lr * 4)
        diffs = np.concatenate([
            np.abs(np.asarray(a) - np.asarray(b)).ravel()
            for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want))])
        assert np.mean(diffs > 1e-4) < 0.01


def _archive_minibatches():
    """Shape (4, 24): two full (a dense block at block_size 2), a full and
    a ragged one (a masked block), one full leftover; shape (3, 24): one
    leftover."""
    rng = np.random.RandomState(5)

    def mb(b, true_len):
        x = np.zeros((b, 24, 23), np.float16)
        x[:, :true_len] = rng.randn(b, true_len, 23)
        return x, rng.randint(0, NUM_CLASSES, b).astype(np.int32), true_len

    return [mb(4, 24), mb(4, 24), mb(4, 24), mb(4, 17), mb(3, 24),
            mb(4, 24)]


def test_train_one_iteration_buckets_blocks_and_leftovers(tmp_path):
    path = str(tmp_path / "egs.1.xta")
    TA.write_archive(path, _archive_minibatches())
    cfg = TR.TrainConfig(model="tiny", num_targets=NUM_CLASSES,
                         compute_dtype="float32", block_size=2,
                         optimizer="sgd")
    tr = TR.Trainer(cfg, str(tmp_path / "a"), device="cpu")
    ref = TR.Trainer(cfg, str(tmp_path / "b"), device="cpu")
    with TA.ArchiveReader(path) as reader:
        stats = tr.train_one_iteration(0, TA.PrefetchLoader(reader), 1e-2,
                                       0.0, 1.0)
        mbs = list(reader)
    assert (stats["minibatches"], stats["dense_blocks"],
            stats["masked_blocks"], stats["single_steps"]) == (6, 1, 1, 2)
    assert np.isfinite(stats["loss"]) and "dispatch_mean_ms" in stats

    # the same updates replayed by hand: dense block, masked block, then
    # the leftovers in sorted shape order
    def stacked(items):
        return (torch.from_numpy(np.stack([m[0] for m in items])),
                torch.from_numpy(np.stack([m[1] for m in items])),
                [m[2] for m in items], [m[0].shape[0] for m in items])

    for fn, items in ((ref._block_dense_fn, mbs[0:2]),
                      (ref._block_fn, mbs[2:4])):
        xs, ys, tl, nr = stacked(items)
        ref.state, _ = fn(ref.params, ref.optimizer, ref.state, xs, ys, tl,
                          nr, 1e-2, 1.0, 1.0, None)
    for f, l, t in (mbs[4], mbs[5]):
        ref.state, _ = ref._step_fn(
            ref.params, ref.optimizer, ref.state, torch.from_numpy(f.copy()),
            torch.from_numpy(l.copy()), t, f.shape[0], 1e-2, 1.0, 1.0, None)
    _close(_np(tr.params), _np(ref.params), rtol=1e-6, atol=1e-6)
    _close(_np(tr.state), _np(ref.state), rtol=1e-6, atol=1e-6)


def test_evaluate_matches_jax_eval_step(tmp_path):
    cfg = jt.MODEL_ZOO["tiny"]
    jp, js, _, _ = model_pair(cfg, num_classes=NUM_CLASSES)
    tr = TR.Trainer(TR.TrainConfig(model="tiny", num_targets=NUM_CLASSES,
                                   compute_dtype="float32"),
                    str(tmp_path), device="cpu")
    tr.set_params(*params_from_numpy(jp, js, device="cpu"))
    x, y = _batch(seed=7)
    got = tr.evaluate([(x.astype(np.float16), y, 21)])
    want = JT.make_eval_step(cfg, JT.TrainConfig(
        model="tiny", num_targets=NUM_CLASSES, compute_dtype="float32"))(
        jp, js, jnp.asarray(x.astype(np.float16)), jnp.asarray(y),
        jnp.int32(21), jnp.int32(16))
    np.testing.assert_allclose(got["loss"], float(want[0]), rtol=1e-5)
    assert got["accuracy"] == float(want[1])


def test_xta_archives_cross_packages(tmp_path):
    mbs = _archive_minibatches()
    for write, read in ((TA.write_archive, JA.ArchiveReader),
                        (JA.write_archive, TA.ArchiveReader)):
        path = str(tmp_path / f"{write.__module__}.xta")
        write(path, mbs)
        with read(path) as reader:
            back = list(reader)
        assert len(back) == len(mbs)
        for (f, l, t), (f2, l2, t2) in zip(mbs, back):
            assert t == t2 and f2.dtype == np.float16
            np.testing.assert_array_equal(f, f2)
            np.testing.assert_array_equal(l, l2)
    with TA.ArchiveReader(path) as reader:
        loader = TA.PrefetchLoader(reader, queue_size=2)
        assert [t for _, _, t in loader] == [m[2] for m in mbs]


@pytest.mark.parametrize("field,value", [("head", "am_softmax"),
                                         ("spmd_step", "shard_map"),
                                         ("final_combine", True),
                                         ("head", "sharded_softmax")])
def test_trainer_refuses_what_is_not_ported(tmp_path, field, value):
    """The shard_map step raises; the AM-softmax head, the sharded head
    (on a one-rank mesh, the dense softmax) and final combination train."""
    cfg = replace(TR.TrainConfig(model="tiny", num_targets=3, num_epochs=1,
                                 compute_dtype="float32", block_size=2,
                                 combine_opt_steps=3),
                  **{field: value})
    if (field, value) == ("spmd_step", "shard_map"):
        with pytest.raises(NotImplementedError):
            TR.Trainer(cfg, str(tmp_path), device="cpu")
        return
    tr = TR.Trainer(cfg, str(tmp_path), device="cpu")
    rng = np.random.RandomState(2)
    mbs = [(rng.randn(4, 24, 23).astype(np.float16),
            rng.randint(0, 3, 4).astype(np.int32), 24) for _ in range(2)]
    assert tr.train(lambda i: iter(mbs), 2,
                    valid_batches=lambda: iter(mbs[:1])) == 2
    final = os.readlink(os.path.join(str(tmp_path), "model_final"))
    assert final == ("model_combined" if field == "final_combine"
                     else "model_2")


def test_bf16_fused_path_agrees_with_matmul_path():
    """bf16 on CPU tensors: the Function's plain versions (one rounding per
    conv) against the shifted matmuls (one rounding per tap), through one
    train step's loss and gradients."""
    cfg = L2_MINI
    _, _, tp, ts = model_pair(cfg, num_classes=NUM_CLASSES)
    x, y = _batch(seed=9)
    out = {}
    for fused in (True, False):
        tcfg = TR.TrainConfig(model="l2_lrelu", num_targets=NUM_CLASSES,
                              compute_dtype="bfloat16",
                              fused_conv_bwd=fused)
        p = jax.tree.map(lambda t: t.clone().requires_grad_(True), tp)
        loss, _ = TR._loss_fn(port_cfg(cfg), tcfg, p, ts,
                              torch.from_numpy(x), torch.from_numpy(y), 30,
                              4, 1.0, None)
        out[fused] = (float(loss), torch.autograd.grad(loss,
                                                       tree_leaves(p)))
    assert abs(out[True][0] - out[False][0]) <= 1e-2 * abs(out[False][0])
    # each bf16 path's worst leaf sits at a cosine of ~0.92 from the f32
    # gradient here (BN over 4 rows amplifies the roundings); the two
    # paths agree with each other to ~0.986
    for a, b in zip(out[True][1], out[False][1]):
        cos = float(torch.nn.functional.cosine_similarity(
            a.flatten().double(), b.flatten().double(), dim=0))
        assert cos >= 0.98


def test_params_survive_a_round_trip_through_the_trainer(tmp_path):
    cfg = jt.MODEL_ZOO["tiny"]
    jp, js, _, _ = model_pair(cfg, num_classes=NUM_CLASSES)
    tr = TR.Trainer(TR.TrainConfig(model="tiny", num_targets=NUM_CLASSES),
                    str(tmp_path), device="cpu")
    tr.set_params(*params_from_numpy(jp, js, device="cpu"))
    back_p, back_s = params_to_numpy(tr.params, tr.state)
    _close(back_p, jp, rtol=0, atol=0)
    _close(back_s, js, rtol=0, atol=0)
