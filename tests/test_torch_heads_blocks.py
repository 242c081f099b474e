"""Port's AM-softmax head, building blocks, attention pooling, presets,
score utilities, reference tars and device forensics against the JAX
package, on the same numpy inputs, on the CPU.

Tolerances: 1e-5 for the AM-softmax loss, logits and gradient and 1e-6 for
the elementwise blocks (rtol and atol; both packages run the same f32
operations); attention pooling and the attention model's forward at 1e-4
in f32 (ROADMAP "Parity before speed": the model forward's bound), 5e-2
normalised in bf16 (the bf16 fused stack's bound)."""

from dataclasses import asdict, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xvector_tpu import presets as JP
from xvector_tpu.data import reference_tar as JRT
from xvector_tpu.models import blocks as JB
from xvector_tpu.models import heads as JH
from xvector_tpu.models import tdnn as jt
from xvector_tpu.utils import scores as JSC
from xvector_tpu_torch import presets as TP
from xvector_tpu_torch.data import reference_tar as TRT
from xvector_tpu_torch.models import blocks as TB
from xvector_tpu_torch.models import heads as TH
from xvector_tpu_torch.models import tdnn as tt
from xvector_tpu_torch.models.convert import tree_leaves
from xvector_tpu_torch.train import trainer as TR
from xvector_tpu_torch.utils import scores as TSC
from xvector_tpu_torch.utils.profiling import device_forensics

from port_helpers import model_pair, port_cfg

TOL = dict(rtol=1e-4, atol=1e-4)
ATT_MINI = replace(jt.MODEL_ZOO["l2_lrelu_attention"], name="att_mini",
                   channels=(16, 16, 16, 16, 24), embed_dims=(12, 12))


@pytest.mark.parametrize("weighted", [False, True])
def test_am_softmax_matches_jax(weighted):
    rng = np.random.RandomState(0)
    hidden = rng.randn(6, 10).astype(np.float32)
    w = rng.randn(10, 7).astype(np.float32)
    labels = rng.randint(0, 7, 6).astype(np.int32)
    rw = np.array([1, 1, 0, 1, 1, 0], np.float32) if weighted else None
    cot = rng.randn(6, 7).astype(np.float32)

    def jfn(h, w):
        loss, logits = JH.am_softmax(h, w, jnp.asarray(labels), 30.0, 0.2,
                                     row_weight=None if rw is None
                                     else jnp.asarray(rw))
        return loss + jnp.sum(logits * cot) * 1e-3, (loss, logits)

    (_, (jl, jlog)), (jgh, jgw) = jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True)(jnp.asarray(hidden),
                                           jnp.asarray(w))
    th = torch.from_numpy(hidden).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    loss, logits = TH.am_softmax(th, tw, torch.from_numpy(labels), 30.0, 0.2,
                                 row_weight=None if rw is None
                                 else torch.from_numpy(rw))
    (loss + (logits * torch.from_numpy(cot)).sum() * 1e-3).backward()
    kw = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(jl), **kw)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlog),
                               **kw)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgh), **kw)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), **kw)


def _vjp_pair(jfn, tfn, args, cot):
    """(JAX value, JAX VJPs, port value, port grads) of fn at args."""
    jv, pull = jax.vjp(jfn, *[jnp.asarray(a) for a in args])
    jg = pull(jnp.asarray(cot))
    targs = [torch.from_numpy(np.array(a)).requires_grad_(True) for a in args]
    tv = tfn(*targs)
    tg = torch.autograd.grad(tv, targs, torch.from_numpy(cot))
    return jv, jg, tv.detach(), tg


@pytest.mark.parametrize("block", ["selu", "zrelu", "flip_gradient"])
def test_blocks_match_jax(block):
    rng = np.random.RandomState(1)
    x = (2 * rng.randn(5, 7)).astype(np.float32)
    cot = rng.randn(5, 7).astype(np.float32)
    if block == "selu":
        args, jfn, tfn = (x,), JB.selu, TB.selu
    elif block == "zrelu":
        args = (x, np.full((), 1.3, np.float32), np.full((), 0.1, np.float32))
        jfn, tfn = JB.zrelu, TB.zrelu
    else:
        args = (x,)
        jfn = lambda a: JB.flip_gradient(a, 0.7)          # noqa: E731
        tfn = lambda a: TB.flip_gradient(a, 0.7)          # noqa: E731
    jv, jg, tv, tg = _vjp_pair(jfn, tfn, args, cot)
    kw = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **kw)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **kw)
    if block == "flip_gradient":
        np.testing.assert_array_equal(tv.numpy(), x)
        np.testing.assert_allclose(tg[0].numpy(), -0.7 * cot, rtol=1e-6)


def _att_inputs(seed=0, b=3, t=17, c=16):
    rng = np.random.RandomState(seed)
    h = rng.randn(b, t, c).astype(np.float32)
    att = {"w": (0.3 * rng.randn(c // 2, c // 2)).astype(np.float32),
           "b": (0.1 * rng.randn(c // 2)).astype(np.float32),
           "v": (0.5 * rng.randn(c // 2)).astype(np.float32)}
    mask = np.ones((b, t, 1), np.float32)
    mask[1, 10:] = 0.0
    mask[2, rng.rand(t) < 0.3] = 0.0
    return h, att, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_attention_pooling_matches_jax(masked, dtype):
    h, att, mask = _att_inputs()
    m = mask if masked else None
    want = np.asarray(jt.attention_pooling(
        jnp.asarray(h).astype(dtype), jax.tree.map(jnp.asarray, att),
        None if m is None else jnp.asarray(m)))
    got = tt.attention_pooling(
        torch.from_numpy(h).to(getattr(torch, dtype)),
        {k: torch.from_numpy(v) for k, v in att.items()},
        None if m is None else torch.from_numpy(m))
    assert got.dtype == torch.float32 and got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    else:
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= 5e-2, err


@pytest.mark.parametrize("train", [False, True])
def test_attention_model_apply_matches_jax(train):
    jp, js, tp, ts = model_pair(ATT_MINI)
    rng = np.random.RandomState(4)
    x = rng.randn(4, 29, 23).astype(np.float32)
    mask = np.ones((4, 29), np.float32)
    mask[3, 20:] = 0.0
    want = jt.apply(ATT_MINI, jp, js, jnp.asarray(x), mask=jnp.asarray(mask),
                    train=train)
    got = tt.apply(port_cfg(ATT_MINI), tp, ts, torch.from_numpy(x),
                   mask=torch.from_numpy(mask), train=train)
    for k in ("logits", "xvector", "pooled", "l2_loss"):
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), **TOL)


def test_presets_match_jax():
    assert set(TP.BENCHMARK_CONFIGS) == set(JP.BENCHMARK_CONFIGS)
    for name, cfg in TP.BENCHMARK_CONFIGS.items():
        want = asdict(JP.BENCHMARK_CONFIGS[name])
        got = asdict(cfg)
        for field in set(want) & set(got):
            if field != "fused_conv_bwd":       # the port's default is on
                assert got[field] == want[field], (name, field)


def test_sharded_preset_is_refused(tmp_path):
    """``sre16_full`` is no longer refused: its sharded head trains, and on
    a one-rank mesh (the whole head on the one rank) it takes the dense
    softmax's steps."""
    # SGD: the update is linear in the gradient, so the two heads' f32
    # round-off stays at its own size (Adam turns it into ±lr steps)
    cfg = replace(TP.BENCHMARK_CONFIGS["sre16_full"], model="tiny",
                  compute_dtype="float32", block_size=2, optimizer="sgd")
    rng = np.random.RandomState(3)
    mbs = [(rng.randn(4, 24, 23).astype(np.float16),
            rng.randint(0, cfg.num_targets, 4).astype(np.int32), 24)
           for _ in range(3)]
    runs = []
    for head in ("sharded_softmax", "softmax"):
        tr = TR.Trainer(replace(cfg, head=head), str(tmp_path / head),
                        device="cpu")
        stats = tr.train_one_iteration(0, iter(mbs), 1e-3, 0.0, 1.0)
        runs.append((stats["loss"], stats["accuracy"], tr.params))
    (la, aa, pa), (lb, ab, pb) = runs
    assert np.isfinite(la) and la == pytest.approx(lb, rel=1e-5)
    assert aa == ab
    for x, y in zip(tree_leaves(pa), tree_leaves(pb)):
        np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_scores_match_jax(tmp_path):
    lines = ["m1 seg1 0.5", "m1 seg1-1 0.9", "m1 seg1-2 0.1", "m2 seg2 -1.0",
             "bad line"]
    for merge in (False, True):
        assert TSC.kaldi_scores_to_nist_tsv(lines, "b", merge) == \
            JSC.kaldi_scores_to_nist_tsv(lines, "b", merge)
    trials = [("e1", "t1", 1), ("e2", "t2", 0), ("e3", "t3", 1)]
    utt2cond = {"t1": "tgl", "t3": "yue"}
    assert TSC.partition_trials(trials, utt2cond) == \
        JSC.partition_trials(trials, utt2cond)
    path = tmp_path / "metrics.jsonl"
    path.write_text(
        '{"iteration": 0, "kind": "train", "loss": 2.5, "accuracy": 0.1, '
        '"lr": 0.001, "seconds": 1.5}\n'
        '{"iteration": 0, "kind": "valid", "loss": 2.7, "accuracy": 0.05}\n'
        '{"kind": "combine", "weights": [1.0]}\n'
        '{"iteration": 1, "kind": "train", "loss": 2.1, "accuracy": 0.2}\n')
    assert TSC.generate_report(str(path)) == JSC.generate_report(str(path))


def test_reference_tar_crosses_packages(tmp_path):
    rng = np.random.RandomState(2)
    mbs = [(rng.randn(4, 9, 23).astype(np.float16),
            rng.randint(0, 5, 4).astype(np.int32)) for _ in range(3)]
    for write, read in ((TRT.write_reference_tar, JRT.read_reference_tar),
                        (JRT.write_reference_tar, TRT.read_reference_tar)):
        path = str(tmp_path / f"{write.__module__}.tar")
        write(path, mbs)
        back = list(read(path))
        assert len(back) == 3
        for (f, l), (f2, l2) in zip(mbs, back):
            np.testing.assert_array_equal(f, f2)
            np.testing.assert_array_equal(l, l2)
    assert [t for _, _, t in TRT.reference_tar_minibatches(path)] == [9] * 3
    with pytest.raises(ValueError, match="uniform"):
        TRT.write_reference_tar(str(tmp_path / "r.tar"),
                                [mbs[0], (mbs[1][0][:3], mbs[1][1][:3])])


def test_device_forensics_on_the_cpu(monkeypatch):
    assert device_forensics() == {"backend": "cpu"}

    def broken():
        raise RuntimeError("runtime unreachable")

    monkeypatch.setattr(torch.cuda, "is_available", broken)
    snap = device_forensics()
    assert "runtime unreachable" in snap["runtime_error"]
