"""The port's SRE16 recipe (xvector_tpu_torch/cli/run_sre16.py) on
the CPU, against the JAX package's, on tests/test_run_sre16.py's
synthetic LDC tree (its ``corpus`` fixture): SWBD-cellular training audio
(two-channel PCM SPHERE + callstats table), a pre-built SRE data dir (the
PLDA pool), SRE16 eval enrollment/test with the evaluation key in the
reference's layout, and unlabeled majors.

- ``make_sre16_eval_full`` and ``build_train_corpus`` equal the JAX package's
  exactly, the no-corpus ``SystemExit`` included;
- ``--stage N`` maps onto the same recipe artifacts in both;
- the port alone, end to end at ``tiny`` f32 (tests/test_run_sre16.py's
  assertions: both variants per language, EER bounds, the 30-utterance
  PLDA pool, the logged egs filter, the derived archive count);
- both packages' ``main`` on the same corpus with the same weights
  carried across (``Recipe.train`` patched in the test to hand back a
  fixed trainer; dither off in both, since the two draw it from other
  generators): equal ``egs_info.json``, archive plans and labels;
  x-vectors of every split within 1e-4 by the feature and the wave
  route; EER within 1e-6 and minDCF within 1e-4 per variant and
  language; per-trial scores within 1e-3."""

import io
import json
import os
import shutil
import types

import jax
import numpy as np
import pytest
import torch

from xvector_tpu.cli import run as JR
from xvector_tpu.cli import run_sre16 as JS
from xvector_tpu.data import corpora as JC
from xvector_tpu.models import tdnn as JT
from xvector_tpu_torch.cli import run as PR
from xvector_tpu_torch.cli import run_sre16 as PS
from xvector_tpu_torch.data import archives as PAR
from xvector_tpu_torch.io import kaldi_ark as PK
from xvector_tpu_torch.models import tdnn as PT
from xvector_tpu_torch.models.convert import params_from_numpy

from test_run_sre16 import _sphere_pcm, _speaker_wave, corpus  # noqa: F401
from test_torch_corpora import assert_same

XV_TOL = 1e-4
EER_TOL = 1e-6
DCF_TOL = 1e-4
SCORE_TOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module: ``tiny``'s ops gain nothing from
    more, and a full pool in each of the suite's parallel workers
    oversubscribes the cores (the end-to-end run was over ten times
    slower that way than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _eval_args(corpus):
    return ["--sre16-eval-root", str(corpus / "R149_0_1"),
            "--sre16-key-root",
            str(corpus / "download" / "sre16_evaluation_key"),
            "--sre16-major-root", str(corpus / "major")]


def _small(epochs="2"):
    return ["--model", "tiny", "--num-epochs", epochs,
            "--min-chunk", "40", "--max-chunk", "80",
            "--min-utt-frames", "39", "--min-spk-utts", "2",
            "--minibatch-size", "8", "--compute-dtype", "float32",
            "--lda-dim", "8"]


# ---- stage 0: the eval corpus and the training pool -----------------------

def test_sre16_eval_full_builder(corpus):
    kw = dict(key_root=str(corpus / "download" / "sre16_evaluation_key"))
    full = PS.corpora.make_sre16_eval_full(str(corpus / "R149_0_1"), **kw)
    assert_same(full, JS.corpora.make_sre16_eval_full(
        str(corpus / "R149_0_1"), **kw))
    assert len(full["trials"]) == 8 * 4
    assert set(full["utt2lang"].values()) == {"tgl", "yue"}
    assert set(full["trials_by_lang"]) == {"tgl", "yue"}
    assert sum(l for _, _, l in full["trials"]) == 8
    assert len(full["enroll"]) == 8 and len(full["test"]) == 8


def test_sre16_key_found_in_root_docs_layout(corpus, tmp_path):
    """Post-eval LDC trees merge the evaluation key into <root>/docs +
    <root>/metadata, with one segment key carrying subjectid and callid."""
    merged = tmp_path / "merged_root"
    shutil.copytree(corpus / "R149_0_1", merged)
    key = corpus / "download" / "sre16_evaluation_key"
    shutil.copy(key / "docs" / "sre16_eval_trial_key.tsv", merged / "docs")
    (merged / "metadata").mkdir()
    shutil.copy(key / "metadata" / "calls.tsv", merged / "metadata")
    seg2call = dict(
        line.split()[:2]
        for line in (key / "docs" / "sre16_eval_segment_key.tsv")
        .read_text().splitlines()[1:])
    rows = ["segmentid\tsubjectid\tcallid"]
    for line in (merged / "docs" / "sre16_eval_segment_key.tsv") \
            .read_text().splitlines()[1:]:
        seg, subj = line.split("\t")
        rows.append(f"{seg}\t{subj}\t{seg2call[seg]}")
    (merged / "docs" / "sre16_eval_segment_key.tsv").write_text(
        "\n".join(rows) + "\n")
    full = PS.corpora.make_sre16_eval_full(str(merged))
    assert_same(full, JS.corpora.make_sre16_eval_full(str(merged)))
    assert len(full["trials"]) == 32
    assert set(full["utt2lang"].values()) == {"tgl", "yue"}


def _train_data_dir(corpus, tmp_path):
    """A pre-built non-SRE data dir: the SWBD corpus saved as Kaldi."""
    from xvector_tpu_torch.data import corpora as PC
    path = tmp_path / "swbd_dd"
    PC.make_swbd_cellular(str(corpus / "LDC2001S13"), 1).save(str(path))
    return str(path)


@pytest.mark.parametrize("flags", [
    ("swbd",), ("swbd", "sre"), ("train",), ("sre", "train"),
    ("swbd", "sre", "train")])
def test_build_train_corpus_matches_jax(corpus, tmp_path, flags):
    argv = {"swbd": ["--swbd-cell1-root", str(corpus / "LDC2001S13")],
            "sre": ["--sre-data-dir", str(corpus / "sre_datadir")],
            "train": ["--train-data-dir", _train_data_dir(corpus, tmp_path)]}
    args = types.SimpleNamespace(**{k: "" for k in (
        "swbd_cell1_root", "swbd_cell2_root", "swbd2_phase1_root",
        "swbd2_phase2_root", "swbd2_phase3_root", "sre_data_root",
        "sre_speaker_list", "sre08_train_root", "sre08_test_root",
        "sre08_key_root", "sre10_root", "mx6_root", "sre_data_dir",
        "train_data_dir")})
    for f in flags:
        name, value = argv[f]
        setattr(args, name[2:].replace("-", "_"), value)
    got, got_sre = PS.build_train_corpus(args)
    want, want_sre = JS.build_train_corpus(args)
    assert_same(got, want)
    assert got_sre == want_sre
    assert bool(got_sre) == ("sre" in flags)
    if "sre" in flags:
        assert got_sre == {f"srespk{s:02d}" for s in range(10)}


def test_build_train_corpus_from_every_ldc_builder(tmp_path):
    """Every LDC root flag at once (SWBD cellular 1-2, SWBD2 phases 1-3,
    SRE04-06, SRE08, SRE10, Mixer 6) on a randomised tree: the same pool
    and the same SRE speakers as the JAX package's."""
    from test_torch_corpora import _random_tree
    p = _random_tree(tmp_path, np.random.RandomState(7))
    args = types.SimpleNamespace(
        swbd_cell1_root=p["swbdc1"], swbd_cell2_root=p["swbdc2"],
        swbd2_phase1_root=p["swbd2p1"], swbd2_phase2_root=p["swbd2p2"],
        swbd2_phase3_root=p["swbd2p3"], sre_data_root=p["sre_root"],
        sre_speaker_list=p["speaker_list"], sre08_key_root=p["sre08"][0],
        sre08_test_root=p["sre08"][1], sre08_train_root=p["sre08"][2],
        sre10_root=p["sre10"], mx6_root=p["mx6"], sre_data_dir="",
        train_data_dir="")
    got, got_sre = PS.build_train_corpus(args)
    # the JAX package appends make_sre_04_to_06's dict of partitions as
    # if it were one DataDir and fails on it (ROADMAP C9); the port
    # appends each partition.  So the referee is the JAX package's pool
    # without --sre-data-root, combined with its SRE04-06 partitions.
    with pytest.raises(AttributeError, match="speakers"):
        JS.build_train_corpus(args)
    sre0406 = list(JC.make_sre_04_to_06(p["sre_root"],
                                        p["speaker_list"]).values())
    assert sre0406
    want, want_sre = JS.build_train_corpus(types.SimpleNamespace(
        **{**vars(args), "sre_data_root": ""}))
    want = want.combine(*sre0406)
    want_sre |= {s for dd in sre0406 for s in dd.speakers}
    assert_same(got, want)
    assert got_sre == want_sre and got_sre
    assert not got_sre & {s for s in got.speakers if s.startswith("sw_")}


def test_no_corpus_is_a_system_exit(corpus, tmp_path):
    argv = ["--work-dir", str(tmp_path / "w"), *_eval_args(corpus)]
    for mod, dev in ((PS, ["--device", "cpu"]), (JS, [])):
        with pytest.raises(SystemExit, match="no training corpora"):
            mod.main(argv + dev)


def test_wav_provider_resamples_like_jax(tmp_path):
    """16 kHz audio comes back at the recipe's 8 kHz, as the JAX
    package's provider gives it; 8 kHz audio is passed through."""
    from xvector_tpu.io.datadir import DataDir as JDataDir
    from xvector_tpu_torch.io.datadir import DataDir
    rng = np.random.RandomState(4)
    wide = tmp_path / "wide.sph"
    head = ("NIST_1A\n   1024\nsample_count -i 16000\nchannel_count -i 1\n"
            "sample_rate -i 16000\nsample_n_bytes -i 2\n"
            "sample_byte_format -s2 01\nsample_coding -s3 pcm\nend_head\n")
    wide.write_bytes(head.encode().ljust(1024, b" ")
                     + (rng.randn(16000) * 1000).astype("<i2").tobytes())
    narrow = tmp_path / "narrow.sph"
    narrow.write_bytes(_sphere_pcm(_speaker_wave(rng, 3, 0.5)))
    wav = {"w": str(wide), "n": str(narrow)}
    u2s = {"w": "s", "n": "s"}
    got = PS.wav_provider_for(DataDir(utt2spk=u2s, wav=wav))
    want = JS.wav_provider_for(JDataDir(utt2spk=u2s, wav=wav))
    assert got("w").shape == (8000,)
    np.testing.assert_allclose(got("w"), np.asarray(want("w")), rtol=1e-5,
                               atol=1e-2)
    np.testing.assert_array_equal(got("n"), np.asarray(want("n")))


# ---- stage gating -----------------------------------------------------------

_ARTIFACTS = ["feats_train.ark", "feats_train.ark.done", "vad_train.ark",
              "egs_feats.ark", "egs.0.xta", "egs.1.ranges", "pdf2num",
              "egs_info.json", "valid_egs.xta", "train_subset_egs.xta",
              "exp/model_0/ckpt.pt", "xvector_sre16_test.ark",
              "xvector_sre16_test.scp.done", "xvector_wav_sre16_enroll.scp"]


def test_stage_map_is_the_jax_packages():
    assert PS._STAGE_TO_RECIPE == JS._STAGE_TO_RECIPE


@pytest.mark.parametrize("stage", list(range(11)))
def test_stage_clears_the_same_artifacts(tmp_path, stage):
    """``--stage N`` (run.sh's 0-10) clears the same artifacts in both
    packages: those of recipe stage ``_STAGE_TO_RECIPE[N]`` and later."""
    kept = {}
    for name, mod, run in (("port", PS, PR), ("jax", JS, JR)):
        work = tmp_path / name
        for a in _ARTIFACTS:
            os.makedirs(os.path.dirname(work / a), exist_ok=True)
            (work / a).write_text("x")
        cfg = (run.RecipeConfig(str(work), device="cpu") if run is PR
               else run.RecipeConfig(str(work)))
        run.Recipe(cfg).force_from_stage(mod._STAGE_TO_RECIPE.get(stage, 99))
        kept[name] = [a for a in _ARTIFACTS if (work / a).exists()]
    assert kept["port"] == kept["jax"]
    recipe_stage = PS._STAGE_TO_RECIPE.get(stage, 99)
    assert ("egs.0.xta" in kept["port"]) == (recipe_stage > 2)
    assert ("xvector_sre16_test.ark" in kept["port"]) == (recipe_stage > 4)


def test_stage_gating_maps_to_recipe_artifacts(corpus, tmp_path):
    """Forcing stage 7 clears the extraction artifacts but keeps the
    features, egs and checkpoints."""
    work = tmp_path / "exp"
    args = ["--work-dir", str(work), "--device", "cpu",
            "--swbd-cell1-root", str(corpus / "LDC2001S13"),
            *_eval_args(corpus), *_small("1"),
            "--num-archives", "2", "--num-repeats", "4"]
    PS.main(args)
    feats_done = work / "feats_train.ark.done"
    xv_done = work / "xvector_sre_combined.scp.done"
    assert feats_done.exists() and xv_done.exists()
    kept = {p: (work / p).stat().st_mtime_ns
            for p in ("feats_train.ark", "egs_feats.ark", "egs.0.xta",
                      "exp/model_final/ckpt.pt")}
    os.utime(xv_done, (0, 0))
    PS.main(args + ["--stage", "7"])
    assert {p: (work / p).stat().st_mtime_ns for p in kept} == kept
    assert xv_done.exists() and xv_done.stat().st_mtime > 0


# ---- end to end ----------------------------------------------------------

def test_run_sre16_end_to_end(corpus, tmp_path, capsys):
    """tests/test_run_sre16.py's run and assertions, on the port."""
    work = tmp_path / "exp"
    res = PS.main([
        "--work-dir", str(work), "--device", "cpu",
        "--swbd-cell1-root", str(corpus / "LDC2001S13"),
        "--sre-data-dir", str(corpus / "sre_datadir"),
        *_eval_args(corpus), *_small(),
        "--frames-per-iter", "25000",   # derive num_archives (get_egs:120)
        "--num-repeats", "6",
    ])
    out = capsys.readouterr().out
    assert "out_of_domain" in res and "adapted" in res
    for variant in ("out_of_domain", "adapted"):
        r = res[variant]
        assert r["num_trials"] == 32
        # the adapted variant degrades on this toy corpus by construction
        # (the majors share speakers and domain with eval), see
        # tests/test_run_sre16.py
        bound = 0.30 if variant == "out_of_domain" else 0.50
        assert r["eer"] <= bound, f"{variant} EER {r['eer']}"
        assert set(r["per_condition"]) == {"tgl", "yue"}
        assert sum(c["num_trials"] for c in r["per_condition"].values()) \
            == 32
        scores = (work / f"scores_{variant}.txt").read_text().splitlines()
        assert len(scores) == 32
        tsv = (work / f"scores_{variant}.tsv").read_text().splitlines()
        assert len(tsv) == 33 and tsv[0].split("\t")[0] == "modelid"
    results = json.load(open(work / "sre16_results.json"))
    assert set(results) == {"out_of_domain", "adapted"}
    walls = json.load(open(work / "stage_walls.json"))
    assert set(walls) == {"prep_augment", "features", "egs", "train",
                          "extract", "backend", "total"}
    assert "EER" in out

    assert "sre_combined (SRE-speaker subset" in out
    pool = dict(PK.read_vec_flt_scp(str(work / "xvector_sre_combined.scp")))
    assert len(pool) == 30 and all(u.startswith("sre") for u in pool)
    assert "egs filter:" in out
    info = json.load(open(work / "egs_info.json"))
    assert info["num_archives"] == \
        info["num_train_frames"] * 6 // 25000 + 1
    assert info["num_archives"] >= 2


def test_full_pool_fallback_and_no_majors(corpus, tmp_path, capsys):
    """No SRE corpus: the PLDA pool falls back to the whole training list
    and says so; no majors: single out-of-domain scoring."""
    work = tmp_path / "exp"
    args = ["--work-dir", str(work), "--device", "cpu",
            "--swbd-cell1-root", str(corpus / "LDC2001S13"),
            "--sre16-eval-root", str(corpus / "R149_0_1"),
            "--sre16-key-root",
            str(corpus / "download" / "sre16_evaluation_key"),
            *_small("1"), "--num-archives", "1", "--num-repeats", "2"]
    res = PS.main(args)
    out = capsys.readouterr().out
    assert "FULL training pool — no SRE corpora given" in out
    assert set(res) == {"out_of_domain"}
    assert res["out_of_domain"]["num_trials"] == 32
    assert "per_condition" not in res["out_of_domain"]
    pool = dict(PK.read_vec_flt_scp(str(work / "xvector_sre_combined.scp")))
    assert len(pool) == 30 and all(u.startswith("sw_") for u in pool)
    # no evaluation key anywhere: extraction only, no scores, {}
    alone = tmp_path / "alone" / "R149_0_1"
    shutil.copytree(corpus / "R149_0_1", alone)
    at = args.index("--sre16-eval-root")
    res = PS.main(args[:at] + ["--sre16-eval-root", str(alone)]
                  + args[at + 4:])
    assert res == {}
    assert "no scorable trials" in capsys.readouterr().out
    assert (work / "stage_walls.json").exists()


# ---- the port against the JAX package, with the same weights -------------

_SPLITS = ("sre_combined", "sre16_enroll", "sre16_test", "sre16_major")


def _fixed_trainer(mod, num_targets):
    """tiny with weights from one JAX key, numpy in the JAX package's
    trainer and carried across for the port's."""
    cfg = JT.MODEL_ZOO["tiny"]
    jp, js = JT.init_params(jax.random.PRNGKey(3), cfg, num_targets)
    jp, js = jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js)
    if mod is JR:
        return types.SimpleNamespace(model_cfg=cfg, params=jp, state=js)
    tp, ts = params_from_numpy(jp, js, device="cpu")
    return types.SimpleNamespace(model_cfg=PT.MODEL_ZOO["tiny"], params=tp,
                                 state=ts)


def _read_xvectors(work, route):
    prefix = "xvector_wav_" if route == "wav" else "xvector_"
    out = {}
    for split in _SPLITS:
        # the PLDA pool is extracted from the feature arks in both routes
        name = ("xvector_" if split == "sre_combined" else prefix) + split
        out[split] = dict(PK.read_vec_flt_scp(str(work / f"{name}.scp")))
    return out


@pytest.fixture(scope="module")
def carried(corpus, tmp_path_factory):
    """Both packages' ``main`` with --extract-from-wav (the wave route),
    then --stage 7 without it (the feature route) in the same work dirs.
    Training is replaced by the fixed weights; dither is off in both;
    the feature arks are stored uncompressed (make_mfcc.sh
    --compress=false), so that the x-vectors compare the front ends and
    not CompressedMatrix rounding (ROADMAP C10,
    test_compressed_arks_round_front_end_noise_to_whole_steps)."""
    from functools import partial
    from xvector_tpu.runtime import native as JN
    base = tmp_path_factory.mktemp("carried")
    argv = ["--swbd-cell1-root", str(corpus / "LDC2001S13"),
            "--sre-data-dir", str(corpus / "sre_datadir"),
            *_eval_args(corpus), *_small(), "--frames-per-iter", "25000",
            "--num-repeats", "6", "--stream-egs"]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JN, "available", lambda: False)
        mp.setattr(JN, "get_lib", lambda: None)
        for name, mod, run in (("port", PS, PR), ("jax", JS, JR)):
            real = run.Recipe.make_features

            def undithered(self, data, provider, split, dither_seed=0,
                           _real=real):
                return _real(self, data, provider, split, dither_seed=None)

            mp.setattr(run.Recipe, "make_features", undithered)
            mp.setattr(run.Recipe, "train",
                       lambda self, n, _run=run: _fixed_trainer(_run, n))
            mp.setattr(mod, "RecipeConfig",
                       partial(run.RecipeConfig, compress_feats=False))
            work = base / name
            dev = ["--device", "cpu"] if mod is PS else []
            res = {"wav": mod.main(["--work-dir", str(work), *dev, *argv,
                                    "--extract-from-wav"])}
            xv = {"wav": _read_xvectors(work, "wav")}
            res["ark"] = mod.main(["--work-dir", str(work), *dev, *argv,
                                   "--stage", "7"])
            xv["ark"] = _read_xvectors(work, "ark")
            out[name] = types.SimpleNamespace(work=work, res=res, xv=xv)
    return out


def test_carried_egs_match_jax(carried):
    port, jax_ = carried["port"].work, carried["jax"].work
    for name in ("egs_info.json", "pdf2num"):
        assert (port / name).read_text() == (jax_ / name).read_text()
    n = json.load(open(port / "egs_info.json"))["num_archives"]
    assert n >= 2
    for i in range(n):             # the archive plans, as ranges files
        got = (port / f"egs.{i}.ranges").read_text()
        assert got and got == (jax_ / f"egs.{i}.ranges").read_text()
    for name in ("valid_egs.xta", "train_subset_egs.xta"):
        got = list(PAR.ArchiveReader(str(port / name)))
        want = list(PAR.ArchiveReader(str(jax_ / name)))
        assert len(got) == len(want) > 0
        for (xa, ya, ta), (xb, yb, tb) in zip(got, want):
            assert xa.shape == xb.shape and ta == tb
            np.testing.assert_array_equal(ya, yb)


@pytest.mark.parametrize("route", ["wav", "ark"])
@pytest.mark.parametrize("split", _SPLITS)
def test_carried_xvectors_match_jax(carried, route, split):
    got = carried["port"].xv[route][split]
    want = carried["jax"].xv[route][split]
    assert set(got) == set(want) and got
    if split == "sre_combined":
        assert len(got) == 30 and all(u.startswith("sre") for u in got)
    for utt in want:
        np.testing.assert_allclose(got[utt], want[utt], rtol=XV_TOL,
                                   atol=XV_TOL, err_msg=utt)


@pytest.mark.parametrize("route", ["wav", "ark"])
@pytest.mark.parametrize("variant", ["out_of_domain", "adapted"])
def test_carried_metrics_match_jax(carried, route, variant):
    """EER within 1e-6 and minDCF within 1e-4, pooled and per language."""
    got = carried["port"].res[route][variant]
    want = carried["jax"].res[route][variant]
    assert got["num_trials"] == want["num_trials"] == 32
    assert abs(got["eer"] - want["eer"]) <= EER_TOL
    assert abs(got["min_dcf"] - want["min_dcf"]) <= DCF_TOL
    assert list(got["per_condition"]) == list(want["per_condition"]) \
        == ["tgl", "yue"]
    for cond, m in want["per_condition"].items():
        g = got["per_condition"][cond]
        assert g["num_trials"] == m["num_trials"]
        assert abs(g["eer"] - m["eer"]) <= EER_TOL
        assert abs(g["min_dcf"] - m["min_dcf"]) <= DCF_TOL


def _jax_back_end(corpus, work, xv):
    """The JAX package's stage 8-10 (its ``Recipe.score_sre16``, as its
    ``main`` calls it) on the given x-vectors of every split."""
    from xvector_tpu.extract.extractor import speaker_means
    from xvector_tpu.io.datadir import load_data_dir
    full = JS.corpora.make_sre16_eval_full(
        str(corpus / "R149_0_1"),
        key_root=str(corpus / "download" / "sre16_evaluation_key"))
    pool = load_data_dir(str(corpus / "sre_datadir"))
    enroll, num_utts = speaker_means(xv["sre16_enroll"],
                                     full["enroll"].utt2spk)
    trials = [(m, s, l) for m, s, l in full["trials"]
              if m in enroll and s in xv["sre16_test"]]
    recipe = JR.Recipe(JR.RecipeConfig(str(work / "jax_back_end"),
                                       lda_dim=8))
    return recipe.score_sre16(
        xv["sre_combined"], pool, xv["sre16_major"], enroll,
        xv["sre16_test"], trials, num_utts=num_utts,
        utt2cond=full["utt2lang"], lda_dim=8)


@pytest.mark.parametrize("route", ["wav", "ark"])
def test_carried_scores_are_the_jax_back_ends(corpus, carried, route,
                                              tmp_path):
    """Per-trial scores within 1e-3 of the JAX package's back end on the
    same x-vectors: the port's scores equal the JAX back end's on the
    port's x-vectors.  Against the JAX package's own run the gap is wider
    than 1e-3 (ROADMAP C11): on this corpus the PLDA's LLRs reach ~6e4,
    and the two front ends' ~1e-6 round-off in the x-vectors moves them
    by ~2 (3e-5 of their size), in the JAX package's back end just as in
    the port's."""
    for variant in ("out_of_domain", "adapted"):
        got = carried["port"].res[route][variant]
        ref = _jax_back_end(corpus, tmp_path, carried["port"].xv[route])
        np.testing.assert_allclose(got["scores"],
                                   np.asarray(ref[variant]["scores"]),
                                   rtol=0, atol=SCORE_TOL)
        assert abs(got["eer"] - ref[variant]["eer"]) <= EER_TOL
        # C11: the same back end moves with its inputs by far more
        want = carried["jax"].res[route][variant]
        gap = np.abs(np.asarray(ref[variant]["scores"])
                     - np.asarray(want["scores"]))
        scale = np.abs(np.asarray(want["scores"])).max()
        assert scale > 1e3 and gap.max() <= 1e-4 * scale


def test_carried_result_files_match_jax(carried):
    """The files the feature-route run left: ``sre16_results.json``
    within the metric tolerances, one score line per trial in the same
    order, the NIST tsv with the same rows."""
    port, jax_ = carried["port"].work, carried["jax"].work
    got = json.load(open(port / "sre16_results.json"))
    want = json.load(open(jax_ / "sre16_results.json"))
    assert list(got) == list(want) == ["out_of_domain", "adapted"]
    for variant in want:
        assert abs(got[variant]["eer"] - want[variant]["eer"]) <= EER_TOL
        assert abs(got[variant]["min_dcf"] - want[variant]["min_dcf"]) \
            <= DCF_TOL
        assert got[variant]["num_trials"] == want[variant]["num_trials"]
        assert set(got[variant]["per_condition"]) == {"tgl", "yue"}
        for ext, sep in (("txt", " "), ("tsv", "\t")):
            g = (port / f"scores_{variant}.{ext}").read_text().splitlines()
            w = (jax_ / f"scores_{variant}.{ext}").read_text().splitlines()
            assert len(g) == len(w) == 32 + (ext == "tsv")
            assert [a.split(sep)[:-1] for a in g] == \
                [b.split(sep)[:-1] for b in w]
    assert json.load(open(port / "stage_walls.json")).keys() == \
        json.load(open(jax_ / "stage_walls.json")).keys()


def test_compressed_arks_round_front_end_noise_to_whole_steps(carried):
    """ROADMAP C10: the recipe stores features as Kaldi CompressedMatrix
    (make_mfcc.sh --compress=true).  The two packages' raw features agree
    within the front end's bound (rtol 1e-4, atol 2e-3), and one writer
    compresses each package's features to bits that equal the JAX
    writer's; but the two packages' features compress to codes up to a
    whole quantisation step apart wherever a value lies next to a step
    boundary.  So the feature route's x-vectors through compressed arks
    differ by more than the front end's round-off, in either package."""
    from xvector_tpu.io import kaldi_ark as JK
    port, jax_ = carried["port"].work, carried["jax"].work

    def raw(work, kio):
        with open(work / "feats_train.ark.scp") as f:
            return {u: kio.read_mat(loc) for u, loc in
                    (line.split(None, 1) for line in f.read().splitlines())}

    def cm(kio, mat):
        buf = io.BytesIO()
        kio.write_mat(buf, mat, compress=True)
        return buf.getvalue()

    got, want = raw(port, PK), raw(jax_, JK)
    assert set(got) == set(want)
    worst = 0.0
    for utt in sorted(want):
        np.testing.assert_allclose(got[utt], want[utt], rtol=1e-4,
                                   atol=2e-3)
        codes = cm(PK, got[utt])
        assert codes == cm(JK, got[utt])
        dg = PK.read_mat(io.BytesIO(codes))
        dw = PK.read_mat(io.BytesIO(cm(PK, want[utt])))
        worst = max(worst, float(np.abs(dg - dw).max()))
    assert worst > 1e-2            # a whole step, far above the 2e-3
