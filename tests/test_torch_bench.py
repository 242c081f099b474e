"""The port's measurement tooling (``xvector_tpu_torch/bench/``) against the
JAX package's ``bench.py`` and ``tools/``, on the CPU at small sizes.

What the CPU can say about a bench: that it feeds the same inputs to the
same computation as its JAX twin, that its checks hold and refuse, and
that it refuses to run without a card.  Times are the card's alone.

Tolerances.  The bench's block step against the JAX block step from the
same weights (``tiny``, 7,185 classes, f32, Adam at 1e-3, the bench's
draws cut to a block of 4 minibatches of 64 x 32 frames): the loss at
1e-4 relative, the BN state within 1e-4, and every updated parameter
within 1e-4, leaf by leaf, except where the reference's first-step
gradient is at rounding level (nonzero and at most ``GRAD_ROUNDING`` of
its leaf's largest): Adam turns such a gradient's sign, which either
package's rounding may flip, into a ±lr move (ROADMAP Queue C), so those
elements are held only within 2·lr·steps.  Extraction 1e-4 in f32 (the model
forward's bound) and 5e-2 for the bf16 fused stack
(``tests/test_tdnn_kernel.py``); the front end rtol 1e-4, atol 2e-3 with
equal VAD decisions (the wave front end's bounds)."""

import ast
import importlib.util
import os
import re
import shutil
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from xvector_tpu.models import tdnn as jt
from xvector_tpu.ops import features as JF
from xvector_tpu.train import trainer as JT
from xvector_tpu_torch.bench import adam_mu, common, dense, extract_sweep
from xvector_tpu_torch.bench import headline as H
from xvector_tpu_torch.bench import scale_sre16 as S
from xvector_tpu_torch.models import tdnn as tt
from xvector_tpu_torch.models.convert import params_to_numpy

from port_helpers import model_pair, port_cfg

ROOT = Path(__file__).resolve().parent.parent
LR = H.LR
# a first-step gradient at most this share of its leaf's largest is at
# rounding level: about eight f32 ulps (the bias before ``tiny``'s first
# embedding BN: noise up to 1.3e-8 of a 4.9e-2 leaf, real gradients from
# 3.7e-4 up)
GRAD_ROUNDING = 1e-6


def _load_tool(name):
    """A JAX-package tool by path (``tools/`` is not a package)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _norm_close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-3), \
        (np.abs(got - want).max(), np.abs(want).max())


# ---------------------------------------------------------------------------
# (a) the training harness against the JAX block step
# ---------------------------------------------------------------------------

def test_measure_train_step_matches_jax_block_step():
    cfg = jt.MODEL_ZOO["tiny"]
    block, rows, frames = 4, H.MINIBATCH, 32
    jp, js = jt.init_params(jax.random.PRNGKey(0), cfg, H.NUM_SPEAKERS)
    jp, js = jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js)
    from xvector_tpu_torch.models.convert import params_from_numpy
    tp, ts = params_from_numpy(jp, js, device="cpu")

    xs, ys = H.train_inputs(block, rows, frames)
    jcfg = JT.TrainConfig(model="tiny", num_targets=H.NUM_SPEAKERS,
                          compute_dtype="float32", block_size=block)
    opt = optax.inject_hyperparams(optax.adam)(learning_rate=LR)
    step = JT.make_block_train_step(cfg, jcfg, opt, dense=True)
    jp2, _, js2, jm = step(
        jax.tree.map(jnp.asarray, jp), opt.init(jp), js, jnp.asarray(xs),
        jnp.asarray(ys), jnp.full((block,), frames, jnp.int32),
        jnp.full((block,), rows, jnp.int32), jnp.float32(LR),
        jnp.float32(1.0), jnp.float32(1.0), jax.random.PRNGKey(1))

    d = H.measure_train_step("tiny", rounds=0, device="cpu", params=tp,
                             state=ts, return_detail=True,
                             compute_dtype="float32", block=block,
                             minibatch=rows, frames=frames)
    assert d["steps"] == block and len(d["losses"]) == 1
    assert d["params"] is tp and d["step_ms"] is None
    assert abs(d["losses"][0] - float(jm["loss"])) <= 1e-4 * abs(
        float(jm["loss"]))
    got_p, got_s = params_to_numpy(d["params"], d["state"])
    for a, b in zip(jax.tree.leaves(got_s), jax.tree.leaves(js2)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    # the reference's gradient of the block's first step
    g1, _ = jax.grad(JT._loss_fn, argnums=2, has_aux=True)(
        cfg, jcfg, jax.tree.map(jnp.asarray, jp), js, jnp.asarray(xs[0]),
        jnp.asarray(ys[0]), frames, rows, 1.0,
        jax.random.split(jax.random.PRNGKey(1), block)[0], True, None, True)
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(jp2)[0]]
    for path, a, b, g in zip(paths, jax.tree.leaves(got_p),
                             jax.tree.leaves(jp2), jax.tree.leaves(g1)):
        diff = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
        g = np.abs(np.asarray(g, np.float64))
        noise = (g > 0) & (g <= GRAD_ROUNDING * g.max())
        assert not noise.all(), path
        held = diff[~noise]
        assert held.max() <= 1e-4, (path, held.max(),
                                    int((held > 1e-4).sum()))
        assert diff.max() <= 2 * LR * block, (path, diff.max())
    # every parameter moved: the update was applied in place
    moved = [np.abs(np.asarray(a) - np.asarray(b)).max()
             for a, b in zip(jax.tree.leaves(got_p), jax.tree.leaves(jp))]
    assert min(moved) > 0


def test_train_inputs_are_bench_py_draws():
    """The harness draws bench.py's block: RandomState(0), float16
    features, then int32 labels in [0, 7185)."""
    xs, ys = H.train_inputs(2, 3, 5)
    rng = np.random.RandomState(0)
    np.testing.assert_array_equal(
        xs, rng.randn(2, 3, 5, H.FEAT_DIM).astype(np.float16))
    np.testing.assert_array_equal(
        ys, rng.randint(0, 7185, (2, 3)).astype(np.int32))
    assert (H.NUM_SPEAKERS, H.MINIBATCH, H.FRAMES, H.BLOCK) == (
        7185, 64, 304, 16)
    assert H.AUDIO_PER_MINIBATCH == pytest.approx(194.56)


@pytest.mark.parametrize("key,model,head,calls", [
    ("train", "no_dropout", "softmax", 6),
    *[(k, m, h, 9 if m == "etdnn" else 6) for k, m, h in H.VARIANTS]])
def test_kernel_calls_per_step(key, model, head, calls, monkeypatch):
    """Three K2/K3/K4 calls per wide k>1 layer: 9 for etdnn (its k=3
    layers at d=2, 3, 4; layer 0's k·Cin = 115 stays off), 6 for the
    rest; and the count is the layers the model's own rule sends to the
    kernels' autograd Function."""
    cfg = tt.MODEL_ZOO[model]
    assert 3 * H.wide_conv_layers(cfg) == calls
    fused = []
    orig = H.CB.conv1d_same_fused_bwd
    monkeypatch.setattr(H.CB, "conv1d_same_fused_bwd",
                        lambda *a: (fused.append(a[1].shape), orig(*a))[1])
    cin = cfg.feat_dim
    for k, c, d in zip(cfg.kernel_sizes, cfg.channels, cfg.dilations):
        tt._conv1d_same(torch.zeros(1, 8, cin, dtype=torch.bfloat16),
                        torch.zeros(k, cin, c, dtype=torch.bfloat16), d,
                        fused_bwd=True)
        cin = c
    assert len(fused) == H.wide_conv_layers(cfg)


def _detail(losses, calls_per_route, device="cuda", steps=32):
    return {"losses": losses, "steps": steps, "device": device,
            "conv_calls": {r: calls_per_route.get(r, 0)
                           for r in H.CONV_ROUTES}}


@pytest.mark.parametrize("case", ["ok", "nan", "flat", "sm80", "missing",
                                  "cpu"])
def test_check_train_holds_and_refuses(case):
    steps = 32
    good = {"fwd_sm90": 2 * steps, "dw_sm90": 2 * steps,
            "dx_sm90": 2 * steps}
    details = {
        "ok": _detail([9.0, 8.0], good),
        "nan": _detail([9.0, float("nan")], good),
        "flat": _detail([9.0, 9.0], good),
        "sm80": _detail([9.0, 8.0], {**good, "dw_sm90": 2 * steps - 1,
                                     "dw_sm80": 1}),
        "missing": _detail([9.0, 8.0], {**good, "dx_sm90": 0}),
        # on the CPU the wrappers launch nothing
        "cpu": _detail([9.0, 8.0], {}, device="cpu"),
    }
    if case in ("ok", "cpu"):
        assert H.check_train(case, "no_dropout", details[case]) == 6
    else:
        with pytest.raises(common.CheckFailed):
            H.check_train(case, "no_dropout", details[case])


def test_dense_and_masked_steps_agree_on_full_blocks():
    """bench/dense.py's premise: on full blocks the mask-free twin and
    the masked step give the same losses."""
    out = dense.compare(1, 1, device="cpu", model="tiny", block=2,
                        minibatch=8, frames=32, num_targets=20)
    assert out["loss_dense"] == pytest.approx(out["loss_masked"], rel=1e-6)
    assert np.isfinite(out["gain_pct"])
    assert out["step_ms_dense_spread"]["n"] == 1


def test_adam_mu_runs_both_moment_dtypes():
    out = adam_mu.compare(1, 1, device="cpu", model="tiny", block=2,
                          minibatch=8, frames=32, num_targets=20)
    # bf16 first moments round the update a little differently
    assert out["loss_mu_bfloat16"] != out["loss_mu_float32"]
    assert out["loss_mu_bfloat16"] == pytest.approx(out["loss_mu_float32"],
                                                    rel=5e-2)
    assert np.isfinite(out["gain_pct"])


# ---------------------------------------------------------------------------
# (b) extraction and (c) the front end against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,fused,tol", [("float32", False, 1e-4),
                                             ("bfloat16", True, 5e-2)])
def test_extract_bench_matches_jax(dtype, fused, tol):
    cfg = jt.MODEL_ZOO["tiny"]
    jp, js, tp, ts = model_pair(cfg, num_classes=H.EXTRACT_CLASSES)
    x, mask = H.extract_inputs(4, 64)
    want = np.asarray(jt.extract_xvector(cfg, jp, js, jnp.asarray(x),
                                         jnp.asarray(mask)))
    ex = H.extractor(port_cfg(cfg), tp, ts, "cpu", fused, dtype)
    got = H.extract_batch(ex, torch.from_numpy(x), torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == want.shape
    _norm_close(got.numpy(), want, tol)
    if fused:
        unfused = H.extract_batch(
            H.extractor(port_cfg(cfg), tp, ts, "cpu", False, dtype),
            torch.from_numpy(x), torch.from_numpy(mask))
        assert H.min_cosine(got, unfused) >= H.COSINE_BOUND


def test_features_bench_matches_jax():
    waves, lens = H.feature_inputs(2, 1)
    feats, mask, vad = H.features_batch(torch.from_numpy(waves),
                                        torch.from_numpy(lens))
    jfeats, jmask = JF.mfcc_batch(jnp.asarray(waves), jnp.asarray(lens),
                                  JF.MfccConfig(dither=0.0))
    jvad = JF.energy_vad_batch(jfeats, jmask)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), rtol=1e-4,
                               atol=2e-3)
    np.testing.assert_array_equal(vad.numpy(), np.asarray(jvad))
    assert feats.shape == (2, 100, 23) and float(vad.sum()) > 0


def test_sweep_shapes_are_the_tools():
    src = (ROOT / "tools" / "bench_extract_sweep.py").read_text()
    listed = re.search(r"for b, t in (\[.*?\]):", src, re.S).group(1)
    assert tuple(ast.literal_eval(listed)) == extract_sweep.SHAPES
    assert len(extract_sweep.SHAPES) == 11
    assert extract_sweep.DEFAULT_OUT.endswith(
        os.path.join("docs", "extract_sweep_h100.json"))


def test_spread():
    s = common.spread([4.0, 1.0, 3.0, 2.0, 5.0])
    assert s == {"median": 3.0, "q1": 2.0, "q3": 4.0, "best": 1.0, "n": 5,
                 "window": 3.0}
    rates = common.spread([4.0, 1.0, 2.0], max)
    assert rates["best"] == 4.0
    # the window of rates is all the work over all the time: three equal
    # units in 1/4 + 1 + 1/2 of a second
    assert rates["window"] == pytest.approx(3 / 1.75)
    assert common.spread([7.0]) == {"median": 7.0, "q1": 7.0, "q3": 7.0,
                                    "best": 7.0, "n": 1, "window": 7.0}
    with pytest.raises(ValueError):
        common.spread([])


# ---------------------------------------------------------------------------
# (d), (e) the scale run
# ---------------------------------------------------------------------------

def _tree_bytes(root):
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            p = os.path.join(d, name)
            out[os.path.relpath(p, root)] = Path(p).read_bytes()
    return out


def test_build_corpus_is_the_tools_byte_for_byte(tmp_path):
    # one root for both: wav.scp names each file by its path
    root = tmp_path / "corpus"
    _load_tool("scale_sre16").build_corpus(str(root), 4, 2, 2, 8)
    want = _tree_bytes(root)
    shutil.rmtree(root)
    S.build_corpus(str(root), 4, 2, 2, 8)
    got = _tree_bytes(root)
    assert len(want) > 60 and sorted(got) == sorted(want)
    assert all(got[k] == want[k] for k in want)


def test_run_variant_streamed_trains_as_materialised(tmp_path):
    S.build_corpus(str(tmp_path / "corpus"), 4, 2, 2, 8)
    runs = {stream: S.run_variant(
        str(tmp_path / "corpus"), str(tmp_path / f"work_{stream}"), stream,
        5e4, model="tiny", device="cpu", compute_dtype="float32",
        num_repeats=3, lda_dim=4) for stream in (False, True)}
    a, b = runs[False], runs[True]
    S.check_same(a, b)
    assert Counter(a["records"]) == Counter(b["records"])
    kinds = Counter(r[0] for r in a["records"])
    assert kinds["train"] == a["num_iterations"] == 2 * a["num_archives"]
    assert kinds["valid"] > 0 and kinds["train_subset"] > 0
    assert a["eer"] == b["eer"] and set(a["eer"]) == {"out_of_domain",
                                                      "adapted"}
    assert a["final_loss"] < a["first_loss"]
    assert not a["stream"] and b["stream"]
    # a streamed run that differs in one record is refused
    bad = dict(b, records=b["records"][:-1] + [
        b["records"][-1][:2] + (b["records"][-1][2] + 1e-3,
                                b["records"][-1][3])])
    with pytest.raises(common.CheckFailed):
        S.check_same(a, bad)
    with pytest.raises(common.CheckFailed):
        S.check_same(a, dict(b, eer={"out_of_domain": 0.5, "adapted": 0.5}))


# ---------------------------------------------------------------------------
# (f) no card: every main refuses, writes nothing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module", ["headline", "extract_sweep", "dense",
                                    "adam_mu", "scale_sre16"])
def test_bench_main_refuses_without_a_card(module, monkeypatch, tmp_path,
                                           capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mods = {"headline": H, "extract_sweep": extract_sweep, "dense": dense,
            "adam_mu": adam_mu, "scale_sre16": S}
    argv = {"scale_sre16": ["--out", str(tmp_path / "scale")],
            "headline": ["--quick"]}.get(module, [])
    baseline = ROOT / "BENCH_BASELINE.json"
    before = (baseline.read_bytes() if baseline.exists() else None,
              sorted(os.listdir(ROOT / "docs")))
    with pytest.raises(SystemExit) as exc:
        mods[module].main(argv)
    assert exc.value.code not in (0, None)
    out = capsys.readouterr()
    assert out.out == "" and "is_available() is False" in out.err
    assert (baseline.read_bytes() if baseline.exists() else None,
            sorted(os.listdir(ROOT / "docs"))) == before
    assert not (tmp_path / "scale").exists()
