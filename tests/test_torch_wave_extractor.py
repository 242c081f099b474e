"""The port's wave path (``xvector_tpu_torch/extract/extractor.py``:
``pack_wave_batch``, ``make_wave_to_xvector``, ``WaveExtractor``,
``read_wav_scp``), its compressed-matrix writer and the CLI's
``--wav-rspecifier``, against the JAX package's on the same waveforms and
numpy weights, on the CPU in f32.

Bounds: the JAX package's own (``tests/test_extractor.py``): x-vectors
rtol 1e-3, atol 2e-3; the long-utterance path 1e-4; the CLI arks 2e-3;
the fused path (K1's bf16 numerics, plain version on the CPU) 5e-2
normalised against the JAX f32 output, the bound of the fused stack;
bytes of ``pack_wave_batch`` and of the CM writer identical."""

import io
import os
import struct
import sys
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xvector_tpu.cli import extract_embedding as JCLI
from xvector_tpu.extract import extractor as JE
from xvector_tpu.io import kaldi_ark as JK
from xvector_tpu.models import tdnn as jt
from xvector_tpu.ops import features as JF
from xvector_tpu.train import checkpoints as JC
from xvector_tpu.train import trainer as JT
from xvector_tpu_torch.cli import extract_embedding as TCLI
from xvector_tpu_torch.extract import extractor as TE
from xvector_tpu_torch.io import kaldi_ark as kio
from xvector_tpu_torch.models.convert import params_from_numpy
from xvector_tpu_torch.ops import features as TF
from xvector_tpu_torch.ops import tdnn_kernel as TK
from xvector_tpu_torch.train import checkpoints as TC
from xvector_tpu_torch.train import trainer as TT

from port_helpers import model_pair, port_cfg

sys.path.insert(0, os.path.dirname(__file__))
import shorten_ref as enc  # noqa: E402

CFG = jt.MODEL_ZOO["tiny"]


@pytest.fixture(scope="module")
def model():
    return model_pair(CFG, seed=0, num_classes=8)


def _speech(n, seed, scale=2000.0):
    return (np.random.RandomState(seed).randn(n) * scale).astype(np.float32)


def _close(got, want, rtol=1e-3, atol=2e-3):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def test_pack_wave_batch_bytes_match_jax():
    rng = np.random.RandomState(0)
    items = [("a", rng.randn(500) * 40000), ("b", rng.randn(37) * 100.4),
             ("c", np.zeros(0, np.float32))]
    for n_rows in (3, 5):
        got = TE.pack_wave_batch(items, 600, n_rows)
        want = JE.pack_wave_batch(items, 600, n_rows)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


@pytest.mark.parametrize("kw", [dict(), dict(cmvn_window=50),
                                dict(vad=dict(frames_context=0))],
                         ids=["default", "window50", "vad_ctx0"])
def test_make_wave_to_xvector_matches_jax(model, kw):
    """Rows of 8000, 4400 and 16000 samples plus a silent one (NaN in
    both) and an empty one."""
    jp, js, tp, ts = model
    window = kw.get("cmvn_window", 300)
    vad = kw.get("vad", {})
    lens = [8000, 4400, 16000, 6000, 0]
    waves = np.zeros((5, 16000), np.float32)
    for i, n in enumerate(lens[:3]):
        waves[i, :n] = _speech(n, i)
    lens = np.asarray(lens, np.int32)
    jfn = JE.make_wave_to_xvector(CFG, JF.MfccConfig(dither=0.0),
                                  JF.VadConfig(**vad), cmvn_window=window,
                                  compute_dtype=jnp.float32)
    jxv, jn = (np.asarray(a) for a in jfn(jp, js, jnp.asarray(waves),
                                          jnp.asarray(lens)))
    tfn = TE.make_wave_to_xvector(port_cfg(CFG), TF.MfccConfig(dither=0.0),
                                  TF.VadConfig(**vad), cmvn_window=window,
                                  compute_dtype=torch.float32, device="cpu")
    txv, tn = tfn(tp, ts, torch.from_numpy(waves), torch.from_numpy(lens))
    assert txv.dtype == torch.float32 and tn.dtype == torch.int32
    np.testing.assert_array_equal(tn.numpy(), jn)
    assert (jn[:3] > 0).all() and (jn[3:] == 0).all()
    assert np.isnan(txv[3:].numpy()).all() and np.isnan(jxv[3:]).all()
    np.testing.assert_allclose(txv[:3].numpy(), jxv[:3], rtol=1e-3,
                               atol=2e-3)


def _utterances():
    """Mixed buckets (1, 2, 3 s) across batch boundaries, a silent and a
    too-short utterance (skipped), and one loud, one quiet half."""
    lens = [8000, 4000, 23000, 8000, 15999, 6000, 9000, 12000, 400]
    utts = [(f"u{i}", _speech(n, 10 + i)) for i, n in enumerate(lens)]
    half = np.concatenate([_speech(8000, 30, 5000), _speech(8000, 31, 1.0)])
    return utts + [("silence", np.zeros(8000, np.float32)),
                   ("halves", half)]


def test_wave_extractor_matches_jax(model):
    jp, js, tp, ts = model
    want = JE.WaveExtractor(CFG, jp, js, JE.WaveExtractorConfig(
        batch_size=2, compute_dtype="float32")).extract(_utterances())
    got = TE.WaveExtractor(port_cfg(CFG), tp, ts, TE.WaveExtractorConfig(
        batch_size=2, compute_dtype="float32"), device="cpu").extract(
            _utterances())
    assert "silence" not in want and "u8" not in want and "u0" in want
    _close(got, want)


def test_wave_extractor_matches_stepwise_chain(model):
    """Each kept row equals the port's own host chain on the int16-rounded
    samples the batch carries: mfcc → energy_vad → sliding_cmvn →
    select_voiced_frames → extract_xvector."""
    _, _, tp, ts = model
    got = TE.WaveExtractor(port_cfg(CFG), tp, ts, TE.WaveExtractorConfig(
        batch_size=3, compute_dtype="float32"), device="cpu").extract(
            _utterances())
    from xvector_tpu_torch.models import tdnn as tt
    cfg = TF.MfccConfig(dither=0.0)
    for utt, wave in _utterances():
        wave = np.clip(np.rint(wave), -32768, 32767)
        feats = TF.mfcc(torch.from_numpy(wave), cfg)
        vad = TF.energy_vad(feats).numpy()
        voiced = TF.select_voiced_frames(TF.sliding_cmvn(feats).numpy(), vad)
        if voiced.shape[0] < 25:
            assert utt not in got
            continue
        want = tt.extract_xvector(port_cfg(CFG), tp, ts,
                                  torch.from_numpy(voiced[None]))[0]
        np.testing.assert_allclose(got[utt], want.numpy(), rtol=1e-3,
                                   atol=2e-3)


def test_wave_extractor_fused_on_cpu_matches_jax(model):
    """use_fused sends the compacted batch through K1's plain version (the
    CPU tensors launch nothing)."""
    jp, js, tp, ts = model
    want = JE.WaveExtractor(CFG, jp, js, JE.WaveExtractorConfig(
        batch_size=4, compute_dtype="float32")).extract(_utterances())
    TK.launches = 0
    got = TE.WaveExtractor(port_cfg(CFG), tp, ts, TE.WaveExtractorConfig(
        batch_size=4, use_fused=True), device="cpu").extract(_utterances())
    assert TK.launches == 0 and set(got) == set(want)
    for k in want:
        err = np.abs(got[k] - want[k]).max() / np.abs(want[k]).max()
        assert err <= 5e-2, (k, err)


def test_wave_extractor_long_utterance_path(model):
    """> max_chunk frames: CMVN and VAD over the whole utterance, then
    chunk-and-average, against JAX's WaveExtractor and against the port's
    explicit host chain."""
    jp, js, tp, ts = model
    wave = _speech(60000, 2)                    # 7.5 s, 750 frames
    wcfg = dict(max_chunk=300, batch_size=4, compute_dtype="float32")
    want = JE.WaveExtractor(CFG, jp, js, JE.WaveExtractorConfig(**wcfg)
                            ).extract([("long", wave)])
    got = TE.WaveExtractor(port_cfg(CFG), tp, ts,
                           TE.WaveExtractorConfig(**wcfg), device="cpu"
                           ).extract([("long", wave)])
    np.testing.assert_allclose(got["long"], want["long"], rtol=1e-4,
                               atol=1e-4)
    feats = TF.mfcc(torch.from_numpy(wave), TF.MfccConfig(dither=0.0))
    vad = TF.energy_vad(feats).numpy()
    chain = TE.XvectorExtractor(
        port_cfg(CFG), tp, ts, TE.ExtractorConfig(max_chunk=300,
                                                  batch_size=1),
        device="cpu").extract([("long", TE.preprocess(
            feats.numpy(), vad=vad, device="cpu"))])
    np.testing.assert_allclose(got["long"], chain["long"], rtol=1e-4,
                               atol=1e-4)


def test_wave_extractor_dither_repeats_under_its_seed(model):
    _, _, tp, ts = model
    utts = _utterances()[:4]

    def run(seed):
        return TE.WaveExtractor(port_cfg(CFG), tp, ts, TE.WaveExtractorConfig(
            batch_size=2, compute_dtype="float32", dither_seed=seed),
            device="cpu").extract(utts)

    a, b, c = run(7), run(7), run(8)
    clean = run(0)
    assert set(a) == set(clean)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        assert np.abs(a[k] - clean[k]).max() < 0.1
    assert any(np.abs(a[k] - c[k]).max() > 0 for k in a)


def _riff(samples, rate=8000, n_ch=1):
    data = np.asarray(samples).astype("<i2").tobytes()
    return (b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
            + b"fmt " + struct.pack("<IHHIIHH", 16, 1, n_ch, rate,
                                    rate * 2 * n_ch, 2 * n_ch, 16)
            + b"data" + struct.pack("<I", len(data)) + data)


def _wav_scp(d):
    """A wav.scp of a WAV, a 16 kHz WAV (resampled), a stereo WAV's
    channel 1, an embedded-shorten SPHERE channel, a pipe, a silent WAV
    and a 0.2 s one (the last two skipped)."""
    rng = np.random.RandomState(3)

    def clip(x):
        return np.clip(x, -32768, 32767).astype(np.int64)

    (d / "a.wav").write_bytes(_riff(clip(rng.randn(9000) * 2000)))
    (d / "b16k.wav").write_bytes(_riff(clip(rng.randn(24000) * 2000),
                                       rate=16000))
    st = clip(rng.randn(7000, 2) * 2000)
    (d / "st.wav").write_bytes(_riff(st.reshape(-1), n_ch=2))
    sh = clip(np.cumsum(rng.randint(-300, 300, size=(8000, 2)), axis=0))
    (d / "c.sph").write_bytes(enc.sphere_with_shorten(sh))
    (d / "p.wav").write_bytes(_riff(clip(rng.randn(12000) * 2000)))
    (d / "sil.wav").write_bytes(_riff(np.zeros(8000)))
    (d / "short.wav").write_bytes(_riff(clip(rng.randn(1600) * 2000)))
    scp = d / "wav.scp"
    scp.write_text(
        f"utt_a {d}/a.wav\nutt_b {d}/b16k.wav\nutt_c {d}/st.wav#ch1\n"
        f"utt_d {d}/c.sph#ch1\nutt_e cat {d}/p.wav |\n"
        f"utt_sil {d}/sil.wav\nutt_short {d}/short.wav\n")
    return scp


@pytest.mark.parametrize("target_sr", [8000, None])
def test_read_wav_scp_matches_jax(tmp_path, target_sr):
    scp = str(_wav_scp(tmp_path))
    got = list(TE.read_wav_scp(scp, target_sr=target_sr))
    want = list(JE.read_wav_scp(scp, target_sr=target_sr))
    assert [u for u, _ in got] == [u for u, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())
    lens = {u: len(w) for u, w in got}
    assert lens["utt_b"] == (12000 if target_sr else 24000)


@pytest.mark.parametrize("shape,const", [((5, 23), False), ((300, 23), False),
                                         ((40, 7), True), ((1, 4), False)],
                         ids=["cm2", "cm", "constant", "one_row"])
def test_compressed_writer_bytes_match_jax(shape, const):
    rng = np.random.RandomState(shape[0])
    m = (np.full(shape, 3.25) if const
         else rng.randn(*shape) * 4 + 2).astype(np.float32)
    got, want = io.BytesIO(), io.BytesIO()
    kio.write_mat(got, m, key="k", compress=True)
    JK.write_mat(want, m, key="k", compress=True)
    assert got.getvalue() == want.getvalue()
    back = kio.read_mat(io.BytesIO(got.getvalue()[len("k "):]))
    assert back.shape == shape
    assert (np.abs(back - m).max(0) <= _cm_bound(m)).all()


def _cm_bound(m):
    """Per-column error bound of CompressedMatrix: CM2 rounds to half a
    uint16 step of the global range (plus the float32 rounding of the
    stored minimum and range); CM's codes are clipped into their
    percentile segment, so a value can land one code of the widest
    segment away (a column's range over 63 codes at worst), plus the
    uint16 rounding of the percentiles."""
    grange = max(float(m.max() - m.min()), 1e-5)
    if m.shape[0] <= 8:
        return np.full(m.shape[1], grange / 65535 / 2
                       + 4e-7 * float(np.abs(m).max()))
    return (m.max(0) - m.min(0)) / 63 + 2 * grange / 65535 + 1e-6


def test_ark_writer_compress_round_trip(tmp_path):
    rng = np.random.RandomState(1)
    mats = {f"u{i}": (rng.randn(50 + i, 23) * 3).astype(np.float32)
            for i in range(3)}
    ark, scp = str(tmp_path / "f.ark"), str(tmp_path / "f.scp")
    with kio.ArkWriter(ark, scp, compress=True) as w:
        for k, v in mats.items():
            w.write(k, v)
    jark = str(tmp_path / "j.ark")
    with JK.ArkWriter(jark, compress=True) as w:
        for k, v in mats.items():
            w.write(k, v)
    assert open(ark, "rb").read() == open(jark, "rb").read()
    back = dict(kio.read_mat_scp(scp))
    for k, v in mats.items():
        assert (np.abs(back[k] - v).max(0) <= _cm_bound(v)).all()


def test_extract_cli_from_wav_matches_jax_cli(tmp_path):
    """The port's ``--wav-rspecifier`` ark against the JAX CLI's on the
    same wav.scp and weights (a JAX checkpoint, carried across with
    ``models/convert.py``), f32, sharded in two."""
    scp = _wav_scp(tmp_path)
    jtr = JT.Trainer(JT.TrainConfig(model="tiny", num_targets=4),
                     str(tmp_path / "jexp"))
    JC.save_iteration(jtr, 0)
    ttr = TT.Trainer(TT.TrainConfig(model="tiny", num_targets=4),
                     str(tmp_path / "texp"), device="cpu")
    ttr.set_params(*params_from_numpy(
        jax.tree.map(np.asarray, jtr.params),
        jax.tree.map(np.asarray, jtr.state), device="cpu"))
    TC.save_iteration(ttr, 0)
    common = ["--model=tiny", "--num-targets=4", "--batch-size=2",
              "--compute-dtype=float32"]
    JCLI.main([f"--model-dir={tmp_path / 'jexp'}", *common,
               f"--wav-rspecifier=scp:{scp}",
               f"--output-ark={tmp_path / 'j.ark'}"])
    want = dict(kio.read_vec_flt_scp(str(tmp_path / "j.scp")))
    got = {}
    for shard in (0, 1):
        out = tmp_path / f"t{shard}.ark"
        TCLI.main([f"--model-dir={tmp_path / 'texp'}", *common,
                   f"--wav-rspecifier=scp,p:{scp}", f"--output-ark={out}",
                   "--num-shards=2", f"--shard={shard}", "--device=cpu"])
        part = dict(kio.read_vec_flt_scp(str(out).replace(".ark", ".scp")))
        assert not set(part) & set(got)
        got.update(part)
    assert set(want) == {"utt_a", "utt_b", "utt_c", "utt_d", "utt_e"}
    _close(got, want)


def test_extract_cli_takes_exactly_one_input(tmp_path):
    base = [f"--model-dir={tmp_path}", "--model=tiny", "--num-targets=4",
            f"--output-ark={tmp_path / 'xv.ark'}", "--device=cpu"]
    for extra in ([], ["--feats-rspecifier=ark:f.ark",
                       "--wav-rspecifier=scp:wav.scp"]):
        with pytest.raises(SystemExit, match="exactly one"):
            TCLI.main(base + extra)


def test_wave_entry_points_reject_unsupported_fused_topology():
    cfg = replace(jt.MODEL_ZOO["l2_lrelu_attention"],
                  channels=(8, 8, 8, 8, 16), embed_dims=(12, 12))
    _, _, tp, ts = model_pair(cfg, seed=1)
    with pytest.raises(ValueError, match="unsupported"):
        TE.WaveExtractor(port_cfg(cfg), tp, ts,
                         TE.WaveExtractorConfig(use_fused=True),
                         device="cpu")
    with pytest.raises(ValueError, match="unsupported"):
        TE.make_wave_to_xvector(port_cfg(cfg), use_fused=True, device="cpu")
