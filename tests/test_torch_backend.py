"""The port's scoring back end (``xvector_tpu_torch/backend/``) and bulk
vector reader against the JAX package's on the same numpy inputs.

Bounds: the host modules (``metrics``, ``plda``) are float64 numpy copies,
held to 1e-12 (keys and integers exactly); the device functions run float32
on the CPU here and are held at ``tests/test_backend.py``'s bounds:
projection rtol/atol 2e-4, scores 1e-3 × span, the device EM 5e-3 / 5e-4
on sorted ``psi`` and 2e-2 × span on LLRs."""

import os

import numpy as np
import pytest
import torch

from xvector_tpu.backend import metrics as JM
from xvector_tpu.backend import plda as JP
from xvector_tpu.backend import plda_device as JPD
from xvector_tpu.io import kaldi_ark as jkio
from xvector_tpu_torch.backend import metrics as TM
from xvector_tpu_torch.backend import plda as TP
from xvector_tpu_torch.backend import plda_device as TPD
from xvector_tpu_torch.io import kaldi_ark as tkio

EXACT = dict(rtol=0, atol=1e-12)


def _speakers(n_spk, dim, seed, counts=(6,), between=4.0, within=0.5):
    """Planted two-covariance speakers; utterance counts cycle ``counts``."""
    rng = np.random.RandomState(seed)
    return {f"s{s}": rng.randn(dim) * np.sqrt(between)
            + rng.randn(counts[s % len(counts)], dim) * np.sqrt(within)
            for s in range(n_spk)}


def _trial_set(dim, seed, m=5, p=8):
    rng = np.random.RandomState(seed)
    enroll = {f"e{i}": rng.randn(dim) * 2.0 for i in range(m)}
    test = {f"t{j}": rng.randn(dim) * 2.0 for j in range(p)}
    trials = [(f"e{i}", f"t{j}") for j in range(p) for i in range(m)
              if (i + j) % 3]
    num_utts = {f"e{i}": 1 + i % 3 for i in range(m)}
    return enroll, test, trials, num_utts


def _as_jax(plda):
    return JP.Plda(plda.mean, plda.transform, plda.psi)


def _assert_plda_equal(a, b):
    for name in ("mean", "transform", "psi"):
        np.testing.assert_allclose(getattr(a, name), getattr(b, name),
                                   **EXACT)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["gauss", "ties", "perfect", "one_class"])
def test_metrics_match_jax(case):
    rng = np.random.RandomState(3)
    labels = (rng.rand(4000) < 0.05).astype(np.int64)
    if case == "gauss":
        scores = rng.randn(4000) + 2.5 * labels
    elif case == "ties":
        scores = np.round(rng.randn(4000) + 1.5 * labels, 1)
    elif case == "perfect":
        scores = labels * 10.0 + rng.rand(4000)
    else:
        labels[:] = 0
        scores = rng.randn(4000)
    for a, b in zip(TM.roc_points(scores, labels),
                    JM.roc_points(scores, labels)):
        np.testing.assert_array_equal(a, b)
    assert TM.eer(scores, labels) == pytest.approx(JM.eer(scores, labels),
                                                   abs=1e-12)
    for p_target in (0.01, 0.005):
        assert TM.min_dcf(scores, labels, p_target=p_target) == \
            pytest.approx(JM.min_dcf(scores, labels, p_target=p_target),
                          abs=1e-12)


# ---------------------------------------------------------------------------
# host LDA and PLDA
# ---------------------------------------------------------------------------

def test_lda_and_length_norm_match_jax():
    spk = _speakers(12, 10, seed=1, counts=(3, 5, 7))
    rows = list(np.concatenate(list(spk.values())))
    np.testing.assert_allclose(TP.global_mean(rows), JP.global_mean(rows),
                               **EXACT)
    v = np.random.RandomState(2).randn(6, 10)
    np.testing.assert_allclose(TP.length_normalize(v),
                               JP.length_normalize(v), **EXACT)
    np.testing.assert_allclose(TP.length_normalize(v[0]),
                               JP.length_normalize(v[0]), **EXACT)
    for factor in (0.0, 0.3):
        t = TP.train_lda(spk, dim=4, total_covariance_factor=factor)
        j = JP.train_lda(spk, dim=4, total_covariance_factor=factor)
        np.testing.assert_allclose(t.transform, j.transform, **EXACT)
        np.testing.assert_allclose(t.mean, j.mean, **EXACT)
        np.testing.assert_allclose(t(v), j(v), **EXACT)


def test_plda_train_project_score_adapt_match_jax():
    spk = _speakers(16, 8, seed=4, counts=(2, 4, 5, 9))
    t = TP.train_plda(spk, num_em_iters=6)
    j = JP.train_plda(spk, num_em_iters=6)
    _assert_plda_equal(t, j)
    v = np.random.RandomState(5).randn(7, 8) * 2.0
    for kw in ({}, {"simple_length_norm": True}, {"num_examples": 3}):
        np.testing.assert_allclose(t.project(v, **kw), j.project(v, **kw),
                                   **EXACT)
    e, p = t.project(v[:4]), t.project(v[3:])
    np.testing.assert_allclose(t.llr(e, p, np.array([1, 2, 3, 1])),
                               j.llr(e, p, np.array([1, 2, 3, 1])), **EXACT)
    enroll, test, trials, num_utts = _trial_set(8, seed=6)
    np.testing.assert_allclose(
        t.score_trials(enroll, test, trials, num_utts),
        j.score_trials(enroll, test, trials, num_utts), **EXACT)
    shifted = np.random.RandomState(7).randn(40, 8) * 3.0 + 1.0
    _assert_plda_equal(t.adapt(shifted), j.adapt(shifted))
    _assert_plda_equal(t.adapt(shifted, 0.5, 0.5),
                       j.adapt(shifted, 0.5, 0.5))


def test_plda_save_load_across_packages(tmp_path):
    t = TP.train_plda(_speakers(10, 6, seed=8, counts=(3, 4)))
    t.save(str(tmp_path / "port.npz"))
    j = JP.Plda.load(str(tmp_path / "port.npz"))
    for name in ("mean", "transform", "psi"):
        np.testing.assert_array_equal(getattr(j, name), getattr(t, name))
    j.save(str(tmp_path / "jax.npz"))
    back = TP.Plda.load(str(tmp_path / "jax.npz"))
    for name in ("mean", "transform", "psi"):
        np.testing.assert_array_equal(getattr(back, name), getattr(t, name))


# ---------------------------------------------------------------------------
# device functions, on the CPU
# ---------------------------------------------------------------------------

def test_project_and_score_device_match_jax():
    t = TP.train_plda(_speakers(12, 10, seed=9, counts=(6,)))
    j = _as_jax(t)
    rng = np.random.RandomState(10)
    v = rng.randn(4, 10)
    for kw in ({}, {"simple_length_norm": True},
               {"num_examples": np.array([1.0, 2.0, 3.0, 1.0])}):
        got = TPD.project_device(t, v, device="cpu", **kw)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(JPD.project_device(j, v, **kw)),
                                   rtol=2e-4, atol=2e-4)
        host_kw = ({"num_examples": 2} if "num_examples" in kw else kw)
        np.testing.assert_allclose(
            TPD.project_device(t, v, device="cpu", **host_kw).numpy(),
            t.project(v, **host_kw), rtol=2e-4, atol=2e-4)

    e = t.project(rng.randn(5, 10))
    p = t.project(rng.randn(8, 10))
    n = np.array([1, 2, 3, 1, 2], np.float32)
    got = TPD.score_matrix(t, e, p, n, device="cpu")
    want = np.asarray(JPD.score_matrix(j, e, p, n))
    host = t.llr(np.repeat(e, 8, 0), np.tile(p, (5, 1)),
                 np.repeat(n, 8)).reshape(5, 8)
    span = host.max() - host.min()
    assert got.shape == (5, 8)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3 * max(span, 1.0))
    np.testing.assert_allclose(got.numpy(), host, atol=1e-3 * max(span, 1.0))

    enroll, test, trials, num_utts = _trial_set(10, seed=11)
    got = TPD.score_trials_device(t, enroll, test, trials, num_utts,
                                  device="cpu")
    host = t.score_trials(enroll, test, trials, num_utts)
    span = host.max() - host.min()
    assert got.dtype == np.float32 and got.shape == (len(trials),)
    np.testing.assert_allclose(
        got, JPD.score_trials_device(j, enroll, test, trials, num_utts),
        atol=1e-3 * max(span, 1.0))
    np.testing.assert_allclose(got, host, atol=1e-3 * max(span, 1.0))


def test_train_plda_device_matches_jax_and_host():
    """Counts 2..6 (and a lone 11) exercise the unique-count grouping."""
    spk = _speakers(30, 10, seed=12, counts=(2, 3, 4, 5, 6, 2, 11),
                    within=0.49)
    t = TPD.train_plda_device(spk, num_em_iters=10, device="cpu")
    j = JPD.train_plda_device(spk, num_em_iters=10)
    h = JP.train_plda(spk, num_em_iters=10)
    np.testing.assert_allclose(t.mean, h.mean, rtol=0, atol=1e-10)
    for other in (j, h):
        np.testing.assert_allclose(np.sort(t.psi), np.sort(other.psi),
                                   rtol=5e-3, atol=5e-4)
    enroll, test, trials, num_utts = _trial_set(10, seed=13, m=6, p=9)
    s_t = t.score_trials(enroll, test, trials, num_utts)
    for other in (j, h):
        s_o = other.score_trials(enroll, test, trials, num_utts)
        span = s_o.max() - s_o.min()
        np.testing.assert_allclose(s_t, s_o, atol=2e-2 * max(span, 1.0))


def test_device_functions_leave_the_callers_precision():
    t = TP.train_plda(_speakers(6, 4, seed=14, counts=(3,)))
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        TPD.score_matrix(t, t.project(np.ones((2, 4))),
                         t.project(np.eye(4)), device="cpu")
        assert torch.get_float32_matmul_precision() == "high"
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.set_float32_matmul_precision(before)


# ---------------------------------------------------------------------------
# bulk vector reads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["path", "ark", "pipe"])
def test_read_vec_flt_matrix_matches_jax(tmp_path, spec):
    rng = np.random.RandomState(15)
    ark = str(tmp_path / "xv.ark")
    want = {f"u{i:03d}": rng.randn(12).astype(np.float32) for i in range(37)}
    with tkio.ArkWriter(ark, ark.replace(".ark", ".scp")) as w:
        for k, v in want.items():
            w.write(k, v)
    rx = {"path": ark, "ark": f"ark:{ark}", "pipe": f"ark:cat {ark} |"}[spec]
    keys, mat = tkio.read_vec_flt_matrix(rx, dim_hint=12)
    jkeys, jmat = jkio.read_vec_flt_matrix(rx, dim_hint=12)
    assert keys == list(jkeys) == list(want)
    assert mat.dtype == np.float32 and mat.shape == (37, 12)
    np.testing.assert_array_equal(mat, jmat)
    np.testing.assert_array_equal(mat, np.stack(list(want.values())))
    fast = list(tkio.read_vec_flt_ark_fast(rx))
    assert [k for k, _ in fast] == keys
    np.testing.assert_array_equal(np.stack([v for _, v in fast]), mat)


def test_read_vec_flt_matrix_empty_ark(tmp_path):
    ark = tmp_path / "empty.ark"
    ark.write_bytes(b"")
    keys, mat = tkio.read_vec_flt_matrix(str(ark), dim_hint=7)
    jkeys, jmat = jkio.read_vec_flt_matrix(str(ark), dim_hint=7)
    assert keys == list(jkeys) == []
    assert mat.shape == jmat.shape == (0, 7) and mat.dtype == np.float32
    assert os.path.getsize(ark) == 0
