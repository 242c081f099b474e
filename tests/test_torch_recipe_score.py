"""The port's back-end recipe stages (``xvector_tpu_torch/cli/run.py``:
``Recipe.score``, ``Recipe.score_sre16``) against the JAX package's on
the same vectors.

Below 2,000 training speakers both packages take the float64 host EM, and
the LLRs agree to 1e-9.  At 2,000 speakers both switch to their device EM
(float32; the port's runs on the CPU here), held at
``tests/test_backend.py``'s device-EM bound, 2e-2 × span on LLRs, with the
EER within one target trial's share."""

import numpy as np
import pytest

from xvector_tpu.cli import run as JR
from xvector_tpu.io.datadir import DataDir as JDataDir
from xvector_tpu_torch.cli import run as TR
from xvector_tpu_torch.io.datadir import DataDir as TDataDir


def _domain(rng, n_spk, n_utt, dim, shift=0.0, scale=1.0, tag="s"):
    """Speaker means plus within-speaker noise; utterance counts cycle
    through ``n_utt`` (an int or a tuple)."""
    counts = n_utt if isinstance(n_utt, tuple) else (n_utt,)
    out, utt2spk = {}, {}
    for s in range(n_spk):
        mu = rng.randn(dim) * 2.0 * scale + shift
        for u in range(counts[s % len(counts)]):
            utt = f"{tag}{s}_u{u}"
            out[utt] = (mu + rng.randn(dim) * 0.7).astype(np.float32)
            utt2spk[utt] = f"{tag}{s}"
    return out, utt2spk


def _workload(n_train_spk, train_utts, dim, seed):
    rng = np.random.RandomState(seed)
    train_xv, train_u2s = _domain(rng, n_train_spk, train_utts, dim)
    eval_xv, eval_u2s = _domain(rng, 14, 5, dim, shift=1.5, scale=1.6,
                                tag="e")
    major_xv, _ = _domain(rng, 30, 3, dim, shift=1.5, scale=1.6, tag="m")
    enroll, num_utts, test = {}, {}, {}
    for s in range(14):
        k = 1 if s % 3 == 0 else 3
        enroll[f"e{s}"] = np.mean([eval_xv[f"e{s}_u{u}"] for u in range(k)],
                                  axis=0)
        num_utts[f"e{s}"] = k
        for u in (3, 4):
            test[f"e{s}_u{u}"] = eval_xv[f"e{s}_u{u}"]
    trials = [(m, t, int(eval_u2s[t] == m)) for t in test for m in enroll]
    utt2cond = {t: ("tgl" if int(t[1:].split("_")[0]) % 2 else "yue")
                for t in test}
    return dict(train_xv=train_xv, train_u2s=train_u2s, major_xv=major_xv,
                enroll=enroll, test=test, trials=trials, num_utts=num_utts,
                utt2cond=utt2cond)


def _recipes(tmp_path, lda_dim=0):
    j = JR.Recipe(JR.RecipeConfig(work_dir=str(tmp_path / "jax"),
                                  lda_dim=lda_dim))
    t = TR.Recipe(TR.RecipeConfig(work_dir=str(tmp_path / "port"),
                                  lda_dim=lda_dim, device="cpu"))
    return j, t


def _run_score(recipe, w, data_dir, adapt):
    return recipe.score(w["train_xv"], data_dir(utt2spk=w["train_u2s"]),
                        w["enroll"], w["test"], w["trials"],
                        adapt_xv=w["major_xv"] if adapt else None,
                        num_utts=w["num_utts"])


def _run_sre16(recipe, w, data_dir, lda_dim):
    return recipe.score_sre16(w["train_xv"], data_dir(utt2spk=w["train_u2s"]),
                              w["major_xv"], w["enroll"], w["test"],
                              w["trials"], num_utts=w["num_utts"],
                              utt2cond=w["utt2cond"], lda_dim=lda_dim)


def _assert_result_close(t, j, atol, eer_tol):
    assert t["num_trials"] == j["num_trials"]
    np.testing.assert_allclose(t["scores"], j["scores"], rtol=0, atol=atol)
    for key in ("eer", "min_dcf"):
        assert abs(t[key] - j[key]) <= eer_tol, (key, t[key], j[key])
    assert set(t.get("per_condition", {})) == set(j.get("per_condition", {}))
    for cond, res in j.get("per_condition", {}).items():
        assert t["per_condition"][cond]["num_trials"] == res["num_trials"]


@pytest.mark.parametrize("lda_dim,adapt", [(0, False), (0, True), (6, True)])
def test_score_host_path_matches_jax(tmp_path, lda_dim, adapt):
    w = _workload(40, (4, 6, 7), 12, seed=0)
    j, t = _recipes(tmp_path, lda_dim)
    rj = _run_score(j, w, JDataDir, adapt)
    rt = _run_score(t, w, TDataDir, adapt)
    assert set(rt) == set(rj)
    _assert_result_close(rt, rj, atol=1e-9, eer_tol=1e-12)


def test_score_sre16_host_path_matches_jax(tmp_path):
    w = _workload(40, 6, 12, seed=1)
    j, t = _recipes(tmp_path)
    rj = _run_sre16(j, w, JDataDir, lda_dim=8)
    rt = _run_sre16(t, w, TDataDir, lda_dim=8)
    assert set(rt) == set(rj) == {"out_of_domain", "adapted"}
    for variant in rj:
        _assert_result_close(rt[variant], rj[variant], atol=1e-9,
                             eer_tol=1e-12)
        for cond, res in rj[variant]["per_condition"].items():
            for key in ("eer", "min_dcf"):
                assert abs(rt[variant]["per_condition"][cond][key]
                           - res[key]) <= 1e-12
    assert np.abs(rt["adapted"]["scores"]
                  - rt["out_of_domain"]["scores"]).max() > 1e-3


def test_recipe_device_em_path_matches_jax(tmp_path, monkeypatch):
    """2,000 speakers × 2 utterances × dim 12: both packages take their
    device EM, in Recipe.score and in Recipe.score_sre16."""
    w = _workload(2000, 2, 12, seed=2)
    calls = []
    real = TR.train_plda_device
    monkeypatch.setattr(TR, "train_plda_device",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    j, t = _recipes(tmp_path)
    n_tgt = sum(l for _, _, l in w["trials"])
    bound = 1.0 / n_tgt                     # one target trial's share
    pairs = [(_run_score(t, w, TDataDir, adapt=True),
              _run_score(j, w, JDataDir, adapt=True))]
    sre_t = _run_sre16(t, w, TDataDir, lda_dim=8)
    sre_j = _run_sre16(j, w, JDataDir, lda_dim=8)
    pairs += [(sre_t[v], sre_j[v]) for v in ("out_of_domain", "adapted")]
    assert [c["device"] for c in calls] == ["cpu", "cpu"]
    for rt, rj in pairs:
        span = rj["scores"].max() - rj["scores"].min()
        np.testing.assert_allclose(rt["scores"], rj["scores"], rtol=0,
                                   atol=2e-2 * max(span, 1.0))
        assert abs(rt["eer"] - rj["eer"]) <= bound

