"""The port's recipe (xvector_tpu_torch.cli.run, stages 0-5) on the CPU
against the JAX package's, at tests/test_e2e.py's sizes (8 speakers × 6
utterances of resonant tones, ``tiny``, f32).

One module fixture runs both recipes once on the same corpus, dither off:
- features within PR 6's bounds (rtol 1e-4, atol 2e-3); VAD decisions
  equal, except next to a frame within 1e-3 of its row's threshold;
- given the same feature arks, ``make_egs`` gives equal usable-frame
  counts, ``pdf2num`` and ``egs_info.json``, and archives with the same
  shapes, labels and lengths, at most one float16 step apart beyond
  CMVN's f32 round-off (1e-5);
- the port's training loss falls (final accuracy above 0.5) and its EER
  stays below 0.20, as ``tests/test_e2e.py:102``;
- extraction with the JAX package's weights carried across
  (``models/convert.py``) equals the JAX package's at 1e-4.
Then: idempotent restart, ``force_from_stage``, ``stream_egs`` training
to the same parameters as the materialised route, and
``tests/test_augment_recipe.py``'s two checks."""

import json
import os
import types

import jax
import numpy as np
import pytest
import torch

from xvector_tpu.cli import run as JR
from xvector_tpu.data.allocator import AllocatorConfig as JAlloc
from xvector_tpu.extract.extractor import ExtractorConfig as JExt
from xvector_tpu.io import kaldi_ark as JK
from xvector_tpu.io.datadir import DataDir as JDataDir
from xvector_tpu.models import tdnn as JT
from xvector_tpu.runtime import native as JN
from xvector_tpu.train.trainer import TrainConfig as JTrain
from xvector_tpu_torch.cli import run as PR
from xvector_tpu_torch.data import allocator as PA
from xvector_tpu_torch.data import archives as PAR
from xvector_tpu_torch.data.allocator import (AllocatorConfig as PAlloc,
                                              ArchivePlan, base_utt)
from xvector_tpu_torch.extract.extractor import (ExtractorConfig as PExt,
                                                 speaker_means)
from xvector_tpu_torch.io import kaldi_ark as PK
from xvector_tpu_torch.io.datadir import DataDir
from xvector_tpu_torch.models import tdnn as PT
from xvector_tpu_torch.models.convert import (params_from_numpy,
                                              tree_leaves)
from xvector_tpu_torch.runtime import native
from xvector_tpu_torch.train.trainer import TrainConfig as PTrain

SR = 8000
NUM_SPK = 8
UTTS_PER_SPK = 6
VAD_NEAR = 1e-3
CMVN_ATOL = 1e-5   # f32 sliding CMVN, the port's against the JAX package's


def _make_corpus(seed=0):
    """Each speaker = 2 resonant tones + noise (tests/test_e2e.py's)."""
    rng = np.random.RandomState(seed)
    f0 = rng.uniform(300, 3000, size=(NUM_SPK, 2))
    waves, utt2spk = {}, {}
    for s in range(NUM_SPK):
        for u in range(UTTS_PER_SPK):
            dur = int(SR * rng.uniform(1.8, 2.5))
            t = np.arange(dur) / SR
            w = sum(np.sin(2 * np.pi * f * t + rng.uniform(0, 6))
                    for f in f0[s])
            w = 3000 * w + 300 * rng.randn(dur)
            utt = f"spk{s}_utt{u}"
            waves[utt] = w.astype(np.float32)
            utt2spk[utt] = f"spk{s}"
    return waves, utt2spk


def _cfg(mod, work, **kw):
    """tests/test_e2e.py's configuration in either package; raw (not
    compressed) feature arks, so the features compare directly."""
    jax_side = mod is JR
    alloc, train, ext = ((JAlloc, JTrain, JExt) if jax_side
                         else (PAlloc, PTrain, PExt))
    base = dict(
        work_dir=str(work), min_utt_frames=60, num_valid_utts=4,
        num_archives=2, compress_feats=False,
        allocator=alloc(min_frames=60, max_frames=120, minibatch_size=8,
                        num_repeats=3, frames_per_iter=30_000, seed=1,
                        length_bucket=32),
        train=train(model="tiny", num_targets=1, num_epochs=2,
                    compute_dtype="float32", initial_effective_lrate=2e-3,
                    final_effective_lrate=5e-4),
        extractor=ext(min_chunk=25, max_chunk=400, batch_size=8,
                      buckets=(64, 128, 192, 256, 320, 416)),
        lda_dim=6)
    if not jax_side:
        base["device"] = "cpu"
    base.update(kw)
    return mod.RecipeConfig(**base)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """Both recipes over the same corpus.  The JAX package runs on its
    Python data paths (its libxta is not the referee)."""
    waves, utt2spk = _make_corpus()
    work = tmp_path_factory.mktemp("recipe")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JN, "available", lambda: False)
        mp.setattr(JN, "get_lib", lambda: None)
        port = PR.Recipe(_cfg(PR, work / "port"))
        p_feat = port.make_features(DataDir(utt2spk=utt2spk),
                                    waves.__getitem__, split="all",
                                    dither_seed=None)
        p_train, p_valid, n_targets = port.make_egs(p_feat)
        trainer = port.train(n_targets)

        jr = JR.Recipe(_cfg(JR, work / "jax"))
        j_feat = jr.make_features(JDataDir(utt2spk=utt2spk),
                                  waves.__getitem__, split="all",
                                  dither_seed=None)
        # JAX's make_egs over the PORT's feature arks
        j_egs = JR.Recipe(_cfg(JR, work / "jax_egs"))
        j_train, _, j_targets = j_egs.make_egs(JDataDir(
            p_feat.utt2spk, p_feat.wav, p_feat.feats, p_feat.vad,
            p_feat.utt2num_frames))
        j_src, j_usable = j_egs._prepare_egs_feats(JDataDir(
            p_feat.utt2spk, p_feat.wav, p_feat.feats, p_feat.vad))
    return types.SimpleNamespace(
        waves=waves, utt2spk=utt2spk, port=port, p_feat=p_feat,
        p_train=p_train, p_valid=p_valid, n_targets=n_targets,
        trainer=trainer, jr=jr,
        j_feat=j_feat, j_egs=j_egs, j_train=j_train, j_targets=j_targets,
        j_usable=j_usable)


def test_features_match_jax(both):
    p_feat, j_feat = both.p_feat, both.j_feat
    assert p_feat.utt2num_frames == j_feat.utt2num_frames
    for utt in both.utt2spk:
        got = PK.read_mat(p_feat.feats[utt])
        want = JK.read_mat(j_feat.feats[utt])
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-3)


def test_vad_matches_jax_but_next_to_threshold(both):
    """A decision may differ only where a frame inside its smoothing
    window lies within 1e-3 of the row's threshold."""
    from xvector_tpu_torch.ops.features import VadConfig
    vcfg = VadConfig()
    flips = 0
    for utt in both.utt2spk:
        got = PK.read_vec_flt(both.p_feat.vad[utt])
        want = JK.read_vec_flt(both.j_feat.vad[utt])
        assert got.shape == want.shape
        c0 = JK.read_mat(both.j_feat.feats[utt])[:, 0].astype(np.float64)
        thresh = (vcfg.energy_threshold
                  + vcfg.energy_mean_scale * c0.mean())
        near = np.abs(c0 - thresh) < VAD_NEAR
        ctx = vcfg.frames_context
        for t in np.flatnonzero(got != want):
            assert near[max(0, t - ctx): t + ctx + 1].any(), (utt, t)
            flips += 1
    assert flips <= 2


def test_make_egs_matches_jax_on_the_same_arks(both):
    port, j_egs = both.port, both.j_egs
    _, p_usable = port._prepare_egs_feats(both.p_feat)
    assert p_usable == both.j_usable
    assert both.n_targets == both.j_targets == NUM_SPK
    assert sorted(both.p_train.utts) == sorted(both.j_train.utts)
    for name in ("pdf2num", "egs_info.json"):
        assert (open(port._p(name)).read()
                == open(j_egs._p(name)).read())
    names = ["egs.0.xta", "egs.1.xta", "valid_egs.xta",
             "train_subset_egs.xta"]
    for name in names:
        got = list(PAR.ArchiveReader(port._p(name)))
        want = list(PAR.ArchiveReader(j_egs._p(name)))
        assert len(got) == len(want) > 0
        for (xa, ya, ta), (xb, yb, tb) in zip(got, want):
            assert xa.shape == xb.shape and ta == tb
            np.testing.assert_array_equal(ya, yb)
            # at most one float16 step apart, beyond the f32 round-off of
            # CMVN (features up to ~60: ~1e-5 absolute, checked below)
            step = np.spacing(np.maximum(np.abs(xa), np.abs(xb)))
            assert np.all(np.abs(xa.astype(np.float32)
                                 - xb.astype(np.float32))
                          <= step.astype(np.float32) + CMVN_ATOL)
    for utt in both.p_train.utts[:8]:
        np.testing.assert_allclose(
            port._load_processed(both.p_feat, utt),
            np.asarray(j_egs._load_processed(both.p_feat, utt)),
            rtol=0, atol=CMVN_ATOL)


def test_native_route_taken(both):
    """Where a compiler is present the port materialises natively: the
    recipe's archives equal a Python materialisation of the same plan."""
    assert native.available()
    port = both.port
    s2i = DataDir({**both.p_train.utt2spk,
                   **both.p_valid.utt2spk}).spk2int()
    usable = port._prepare_egs_feats(both.p_feat)[1]
    plan = next(iter(PA.allocate_archives(
        {u: usable[u] for u in both.p_train.utts},
        {u: s2i[s] for u, s in both.p_train.utt2spk.items()},
        port.cfg.allocator, num_archives=2)))
    path = port._p("python_egs.0.xta")
    PAR.materialize_archive(plan, path,
                            lambda u: port._load_processed(both.p_train, u),
                            shuffle_seed=port.cfg.allocator.seed)
    assert (open(path, "rb").read()
            == open(port._p("egs.0.xta"), "rb").read())


def test_training_learns(both):
    with open(os.path.join(both.trainer.work_dir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    train = [r for r in lines if r["kind"] == "train"]
    assert len(train) == 4            # 2 epochs × 2 archives
    assert train[-1]["loss"] < train[0]["loss"]
    assert train[-1]["accuracy"] > 0.5


def test_eer_far_below_chance(both):
    port, feat = both.port, both.p_feat
    xv = port.extract(both.trainer, feat, split="all")
    assert len(xv) >= 0.9 * len(feat)
    train_xv = {u: xv[u] for u in both.p_train.utts if u in xv}
    enroll = {u: v for u, v in xv.items() if int(u.split("utt")[1]) < 3}
    test = {u: v for u, v in xv.items() if int(u.split("utt")[1]) >= 3}
    spk_enroll, _ = speaker_means(enroll, feat.utt2spk)
    trials = [(s, t, 1 if feat.utt2spk[t] == s else 0)
              for s in spk_enroll for t in test]
    res = port.score(train_xv, both.p_train, spk_enroll, test, trials)
    assert res["num_trials"] == len(trials)
    assert res["eer"] < 0.20, f"EER {res['eer']:.3f} not separating speakers"


@pytest.mark.parametrize("source", ["features", "wav"])
def test_extraction_with_jax_weights_matches_jax(both, source):
    """The JAX package's weights carried across: the port's stage 4 gives
    the JAX package's x-vectors at 1e-4 (f32, unfused), from the feature
    arks and from the waveforms."""
    cfg = JT.MODEL_ZOO["tiny"]
    jp, js = JT.init_params(jax.random.PRNGKey(3), cfg, NUM_SPK)
    jp, js = jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js)
    jtr = types.SimpleNamespace(model_cfg=cfg, params=jp, state=js)
    tp, ts = params_from_numpy(jp, js, device="cpu")
    ptr = types.SimpleNamespace(model_cfg=PT.MODEL_ZOO["tiny"], params=tp,
                                state=ts)
    split = f"jaxw_{source}"
    if source == "features":
        want = both.jr.extract(jtr, both.j_feat, split)
        got = both.port.extract(ptr, both.p_feat, split)
    else:
        want = both.jr.extract_from_wav(jtr, both.j_feat,
                                        both.waves.__getitem__, split)
        got = both.port.extract_from_wav(ptr, both.p_feat,
                                         both.waves.__getitem__, split)
    assert set(got) == set(want) and len(got) >= 0.9 * len(both.utt2spk)
    for utt in want:
        np.testing.assert_allclose(got[utt], want[utt], rtol=1e-4,
                                   atol=1e-4)


def test_idempotent_restart(both):
    """Re-running the feature and egs stages reuses the on-disk outputs."""
    port = both.port
    ark = port._p("feats_all.ark")
    egs = port._p("egs.0.xta")
    mtimes = os.path.getmtime(ark), os.path.getmtime(egs)
    again = port.make_features(DataDir(utt2spk=both.utt2spk),
                               lambda u: 1 / 0, split="all")  # not called
    assert again.feats == both.p_feat.feats
    port.make_egs(again)
    assert (os.path.getmtime(ark), os.path.getmtime(egs)) == mtimes


def test_force_from_stage(tmp_path):
    """Stages >= N lose their outputs, earlier stages keep theirs."""
    recipe = PR.Recipe(PR.RecipeConfig(str(tmp_path), device="cpu"))
    by_stage = {1: ["feats_all.ark", "feats_all.ark.scp", "vad_all.ark"],
                2: ["egs_feats.ark", "egs.0.xta", "egs.1.ranges", "pdf2num",
                    "egs_info.json", "valid_egs.xta"],
                3: ["exp/model_0/ckpt.pt"],
                4: ["xvector_all.ark", "xvector_all.scp.done"]}
    for names in by_stage.values():
        for name in names:
            os.makedirs(os.path.dirname(tmp_path / name), exist_ok=True)
            (tmp_path / name).write_text("x")
    recipe.force_from_stage(3)
    for stage, names in by_stage.items():
        for name in names:
            assert (tmp_path / name).exists() == (stage < 3), name
    assert not (tmp_path / "exp").exists()
    recipe.force_from_stage(1)
    assert not any(tmp_path.iterdir())


def test_stream_egs_trains_to_the_same_parameters(tmp_path):
    """Recipe(stream_egs=True) trains to EXACTLY the parameters of the
    materialised route: same plans, same shuffle, same trainer."""
    rng = np.random.RandomState(0)
    waves = {f"spk{s}_u{u}": (np.sin(2 * np.pi * (500 + 700 * s)
                                     * np.arange(SR * 2) / SR) * 3000
                              + 200 * rng.randn(SR * 2)).astype(np.float32)
             for s in range(3) for u in range(3)}
    data = DataDir(utt2spk={u: u.split("_")[0] for u in waves})

    def build(work, stream):
        return PR.RecipeConfig(
            work_dir=str(work), min_utt_frames=40, min_spk_utts=2,
            num_valid_utts=2, num_archives=2, stream_egs=stream,
            allocator=PAlloc(min_frames=40, max_frames=60, minibatch_size=4,
                             num_repeats=2, frames_per_iter=3_000,
                             length_bucket=32),
            train=PTrain(model="tiny", num_targets=1, num_epochs=1,
                         compute_dtype="float32", block_size=2),
            extractor=PExt(min_chunk=25, max_chunk=100, batch_size=4),
            device="cpu")

    params = {}
    for stream in (False, True):
        r = PR.Recipe(build(tmp_path / f"s{int(stream)}", stream))
        feat = r.make_features(data, waves.__getitem__, split="all",
                               dither_seed=None)
        _, _, n = r.make_egs(feat)
        params[stream] = [t.detach().clone()
                          for t in tree_leaves(r.train(n).params)]
    for a, b in zip(params[False], params[True]):
        assert torch.equal(a, b)
    s1 = tmp_path / "s1"
    assert (s1 / "egs.0.ranges").exists()
    assert not (s1 / "egs.0.xta").exists()
    plan = ArchivePlan.from_ranges_lines(
        0, (s1 / "egs.0.ranges").read_text().splitlines())
    assert plan.minibatches


def test_recipe_augment_stage(tmp_path):
    rng = np.random.RandomState(0)
    waves = {f"spk{s}_u{u}": (rng.randn(8000) * 1000).astype(np.float32)
             for s in range(2) for u in range(2)}
    data = DataDir(utt2spk={u: u.split("_")[0] for u in waves})
    recipe = PR.Recipe(PR.RecipeConfig(work_dir=str(tmp_path),
                                       device="cpu"))
    rirs = [np.exp(-np.arange(100) / 20).astype(np.float32)]
    noises = [(rng.randn(2000) * 100).astype(np.float32)]
    aug, provider = recipe.augment(data, lambda u: waves[u], rirs=rirs,
                                   noises=noises)
    assert len(aug) == 12              # 4 clean + 2 kinds × 4
    assert aug.utt2spk["spk0_u0-reverb"] == "spk0"
    assert base_utt("spk0_u0-reverb") == "spk0_u0"
    clean = provider("spk0_u0")
    reverbed = provider("spk0_u0-reverb")
    noised = provider("spk0_u0-noise")
    assert reverbed.shape == clean.shape == noised.shape
    assert not np.allclose(reverbed, clean)
    assert not np.allclose(noised, clean)
    np.testing.assert_array_equal(provider("spk0_u0-noise"), noised)
    assert "spk0_u0-music" not in aug.utt2spk
    # the same copies as the JAX package's recipe, to f32 round-off
    jr = JR.Recipe(JR.RecipeConfig(work_dir=str(tmp_path / "jax")))
    _, jprov = jr.augment(JDataDir(utt2spk=dict(data.utt2spk)),
                          lambda u: waves[u], rirs=rirs, noises=noises)
    for utt in ("spk0_u0-reverb", "spk1_u1-noise"):
        np.testing.assert_allclose(provider(utt), np.asarray(jprov(utt)),
                                   rtol=1e-4, atol=1e-2)


def test_augmented_copies_inherit_clean_vad(tmp_path):
    """Reference behaviour: vad.scp of augmented lists is COPIED from the
    clean list (run.sh:141), never recomputed on corrupted audio."""
    rng = np.random.RandomState(3)
    waves = {f"spk{s}_u{u}": np.concatenate([
        (rng.randn(4000) * 2000), np.zeros(4000)]).astype(np.float32)
        for s in range(2) for u in range(2)}
    data = DataDir(utt2spk={u: u.split("_")[0] for u in waves})
    recipe = PR.Recipe(PR.RecipeConfig(work_dir=str(tmp_path),
                                       device="cpu"))
    noises = [(rng.randn(2000) * 3000).astype(np.float32)]
    aug, provider = recipe.augment(data, lambda u: waves[u], noises=noises)
    feat_dir = recipe.make_features(aug, provider, split="aug",
                                    dither_seed=None)
    vads = {u: PK.read_vec_flt(loc) for u, loc in feat_dir.vad.items()}
    for u in waves:
        np.testing.assert_array_equal(vads[u + "-noise"], vads[u])
    f_clean = PK.read_mat(feat_dir.feats["spk0_u0"])
    f_noise = PK.read_mat(feat_dir.feats["spk0_u0-noise"])
    assert not np.allclose(f_clean, f_noise)


def test_dither_draws_from_a_seeded_generator(tmp_path):
    """Dither on: the same seed gives the same features, another seed
    other ones; both stay within dither's reach of the undithered run."""
    waves, utt2spk = _make_corpus()
    keep = sorted(utt2spk)[:4]
    data = DataDir(utt2spk={u: utt2spk[u] for u in keep})
    out = {}
    for name, seed in (("a", 5), ("b", 5), ("c", 6), ("off", None)):
        r = PR.Recipe(PR.RecipeConfig(str(tmp_path / name), device="cpu",
                                      compress_feats=False))
        feat = r.make_features(data, waves.__getitem__, "all",
                               dither_seed=seed)
        out[name] = {u: PK.read_mat(feat.feats[u]) for u in keep}
    for u in keep:
        np.testing.assert_array_equal(out["a"][u], out["b"][u])
        assert not np.array_equal(out["a"][u], out["c"][u])
        np.testing.assert_allclose(out["a"][u], out["off"][u], atol=0.5)


def _write_wav(path, samples, rate):
    import wave
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(np.asarray(samples, "<i2").tobytes())


def _augmentation_corpora(root):
    """A MUSAN tree (noise and music, one file at 16 kHz) and a
    RIRS_NOISES tree (small and medium rooms)."""
    rng = np.random.RandomState(9)
    _write_wav(root / "musan" / "noise" / "free" / "n1.wav",
               rng.randn(16000) * 800, 16000)
    _write_wav(root / "musan" / "noise" / "n2.wav", rng.randn(9000) * 800,
               8000)
    _write_wav(root / "musan" / "music" / "m1.wav", rng.randn(8000) * 500,
               8000)
    for room in ("smallroom", "mediumroom"):
        h = np.zeros(400)
        h[0], h[1:] = 20000, rng.randn(399) * 300 * np.exp(
            -np.arange(399) / 60)
        _write_wav(root / "rirs" / "simulated_rirs" / room / "Room001"
                   / "r1.wav", h, 8000)
    return root / "musan", root / "rirs"


def test_corpora_match_jax(tmp_path):
    from xvector_tpu.data import corpora as JC
    from xvector_tpu_torch.data import corpora as PC
    musan, rirs = _augmentation_corpora(tmp_path)
    got, want = PC.make_musan(str(musan)), JC.make_musan(str(musan))
    assert sorted(got) == sorted(want) == ["music", "noise"]
    for cat in got:
        assert got[cat].utt2spk == want[cat].utt2spk
        assert got[cat].wav == want[cat].wav
    assert PC.make_rirs(str(rirs)) == JC.make_rirs(str(rirs))
    lazy = PR._LazyWaves([got["noise"].wav["noise-n1"]], target_sr=8000)
    jlazy = JR._LazyWaves([want["noise"].wav["noise-n1"]], target_sr=8000)
    assert len(lazy) == 1 and lazy[0].shape == (8000,)
    np.testing.assert_allclose(lazy[0], jlazy[0], rtol=1e-5, atol=1e-2)


def test_cli_run_then_stage3_rerun(tmp_path):
    """``cli.run`` end to end on the CPU (synthetic corpus, ``tiny``,
    MUSAN noise and RIRS_NOISES augmentation, --extract-from-wav), then
    ``--stage 3``: features and egs are reused, the model is trained
    again and the x-vectors are extracted again."""
    import contextlib
    import io
    musan, rirs = _augmentation_corpora(tmp_path)
    work = tmp_path / "run"
    argv = [f"--work-dir={work}", "--synthetic-speakers=2",
            "--synthetic-utts=4", "--model=tiny", "--device=cpu",
            "--compute-dtype=float32", "--num-epochs=1",
            "--num-archives=1", f"--musan-dir={musan}",
            f"--rirs-dir={rirs}"]
    with contextlib.redirect_stdout(io.StringIO()) as out:
        first = PR.main(argv + ["--extract-from-wav"])
    assert ("stage 0: augmentation (rirs=True noise=True music=True "
            "babble=False)") in out.getvalue()
    assert "stage 1: features (32 utts)" in out.getvalue()
    assert 0.0 <= first["eer"] <= 1.0 and first["num_trials"] == 32
    assert (work / "xvector_wav_all.scp.done").exists()
    kept = {name: os.path.getmtime(work / name)
            for name in ("feats_all.ark", "egs_feats.ark", "egs.0.xta")}
    ckpt = work / "exp" / "model_0" / "ckpt.pt"
    before = os.path.getmtime(ckpt)
    os.utime(ckpt, (before - 100, before - 100))
    with contextlib.redirect_stdout(io.StringIO()) as out:
        PR.main(argv + ["--stage=3"])
    assert "forcing re-run from stage 3" in out.getvalue()
    assert {n: os.path.getmtime(work / n) for n in kept} == kept
    assert os.path.getmtime(ckpt) > before - 100     # trained again
    assert not (work / "xvector_wav_all.scp").exists()
    assert (work / "xvector_all.scp.done").exists()
