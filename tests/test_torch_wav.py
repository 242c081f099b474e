"""The port's wave I/O (``xvector_tpu_torch/io/wav.py``, ``io/shorten.py``)
and Kaldi conf parsers (``utils/kaldi_conf.py``) against the JAX
package's on the same bytes.  Decoding is exact (integer audio); resampling
is held at 1e-5 relative."""

import dataclasses
import io
import os
import struct
import sys

import numpy as np
import pytest

from xvector_tpu.io import shorten as JS
from xvector_tpu.io import wav as JW
from xvector_tpu.utils import kaldi_conf as JK
from xvector_tpu_torch.io import shorten as TS
from xvector_tpu_torch.io import wav as TW
from xvector_tpu_torch.utils import kaldi_conf as TK

sys.path.insert(0, os.path.dirname(__file__))
import shorten_ref as enc  # noqa: E402


def _riff(data: bytes, rate=8000, n_ch=1, bits=16, fmt_code=1) -> bytes:
    block = n_ch * bits // 8
    fmt = struct.pack("<HHIIHH", fmt_code, n_ch, rate, rate * block, block,
                      bits)
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", len(data)) + data)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _sphere(raw: bytes, coding="pcm", n_bytes=2, byte_fmt="01", n_ch=1,
            rate=8000, count=None) -> bytes:
    lines = ["NIST_1A", "   1024", f"channel_count -i {n_ch}",
             f"sample_rate -i {rate}", f"sample_n_bytes -i {n_bytes}",
             f"sample_byte_format -s{len(byte_fmt)} {byte_fmt}",
             f"sample_coding -s{len(coding)} {coding}"]
    if count is not None:
        lines.append(f"sample_count -i {count}")
    head = "\n".join(lines + ["end_head"]).encode() + b"\n"
    return head.ljust(1024, b" ") + raw


def _ar_signal(rng, n, nchan, scale=300):
    x = np.cumsum(rng.integers(-scale, scale, size=(n, nchan)), axis=0)
    return np.clip(x, -32768, 32767).astype(np.int64)


def _same(got, want):
    (gs, gr), (ws, wr) = got, want
    assert gr == wr and gs.dtype == ws.dtype == np.float32
    np.testing.assert_array_equal(gs, ws)


_RNG = np.random.RandomState(0)
_PCM16 = (_RNG.randn(1000) * 3000).astype("<i2")
_STEREO = (_RNG.randn(600) * 3000).astype("<i2")      # 300 frames × 2
WAV_CASES = {
    "pcm16": (_riff(_PCM16.tobytes()), None),
    "pcm8": (_riff(_RNG.randint(0, 256, 700).astype(np.uint8).tobytes(),
                   bits=8), None),
    "float32": (_riff((_RNG.randn(500) * 0.3).astype("<f4").tobytes(),
                      bits=32, fmt_code=3), None),
    "stereo_ch0": (_riff(_STEREO.tobytes(), n_ch=2), 0),
    "stereo_ch1": (_riff(_STEREO.tobytes(), n_ch=2), 1),
    "rate16k": (_riff(_PCM16.tobytes(), rate=16000), None),
}


@pytest.mark.parametrize("case", sorted(WAV_CASES))
def test_read_wav_matches_jax(case):
    data, ch = WAV_CASES[case]
    _same(TW.read_wav(io.BytesIO(data), ch), JW.read_wav(io.BytesIO(data),
                                                         ch))


def test_read_wav_rejects_what_jax_rejects():
    for bad in (b"RIFX" + b"\x00" * 40, _riff(b"\x00" * 12, bits=24)):
        for mod in (TW, JW):
            with pytest.raises(ValueError):
                mod.read_wav(io.BytesIO(bad))


_PCM_BE = (_RNG.randn(800) * 3000).astype(">i2")
_U8 = _RNG.randint(0, 256, 900).astype(np.uint8)
SPHERE_CASES = {
    "pcm_01": (_sphere(_PCM16.tobytes()), None),
    "pcm_10": (_sphere(_PCM_BE.tobytes(), byte_fmt="10"), None),
    "pcm_2ch_0": (_sphere(_STEREO.tobytes(), n_ch=2), 0),
    "pcm_2ch_1": (_sphere(_STEREO.tobytes(), n_ch=2), 1),
    "ulaw": (_sphere(_U8.tobytes(), coding="ulaw", n_bytes=1), None),
    "alaw": (_sphere(_U8.tobytes(), coding="alaw", n_bytes=1), None),
    "ulaw_2ch_1": (_sphere(_U8.tobytes(), coding="ulaw", n_bytes=1,
                           n_ch=2), 1),
    "shorten_pcm_ch1": (enc.sphere_with_shorten(
        _ar_signal(np.random.default_rng(7), 1500, 2)), 1),
    "shorten_pcm_mono": (enc.sphere_with_shorten(
        _ar_signal(np.random.default_rng(8), 777, 1)), None),
    "shorten_ulaw_ch0": (enc.sphere_with_shorten(
        np.random.default_rng(9).integers(0, 256, (800, 2)), ulaw=True), 0),
}


@pytest.mark.parametrize("case", sorted(SPHERE_CASES))
def test_read_sphere_matches_jax(case, tmp_path):
    data, ch = SPHERE_CASES[case]
    p = tmp_path / "a.sph"
    p.write_bytes(data)
    _same(TW.read_sphere(str(p), ch), JW.read_sphere(str(p), ch))


def test_sphere_sample_count_bounds_padded_shorten(tmp_path):
    x = _ar_signal(np.random.default_rng(9), 700, 1)
    stream = enc.encode(np.concatenate([x, np.zeros((68, 1), np.int64)]),
                        blocksize=256, nmean=4)
    p = tmp_path / "padded.sph"
    p.write_bytes(_sphere(stream, coding="pcm,embedded-shorten-v2.00",
                          byte_fmt="10", count=700))
    got = TW.load_wave(str(p))
    _same(got, JW.load_wave(str(p)))
    np.testing.assert_array_equal(got[0].astype(np.int64), x[:, 0])


@pytest.mark.parametrize("spec", ["path", "ch0", "ch1", "pipe", "pipe_ch1",
                                  "sph_ch1"])
def test_load_wave_matches_jax(spec, tmp_path):
    (tmp_path / "s.wav").write_bytes(WAV_CASES["stereo_ch0"][0])
    (tmp_path / "m.wav").write_bytes(WAV_CASES["pcm16"][0])
    (tmp_path / "c.sph").write_bytes(SPHERE_CASES["shorten_pcm_ch1"][0])
    s = {"path": f"{tmp_path}/m.wav", "ch0": f"{tmp_path}/s.wav#ch0",
         "ch1": f"{tmp_path}/s.wav#ch1", "pipe": f"cat {tmp_path}/m.wav |",
         "pipe_ch1": f"cat {tmp_path}/s.wav |#ch1",
         "sph_ch1": f"{tmp_path}/c.sph#ch1"}[spec]
    _same(TW.load_wave(s), JW.load_wave(s))


@pytest.mark.parametrize("sr_in,sr_out,n", [(16000, 8000, 16000),
                                            (44100, 8000, 9000),
                                            (8000, 16000, 3001),
                                            (22050, 8000, 5000)])
def test_resample_matches_jax(sr_in, sr_out, n):
    x = (np.random.RandomState(n).randn(n) * 3000).astype(np.float32)
    got, want = TW.resample(x, sr_in, sr_out), JW.resample(x, sr_in, sr_out)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_resample_same_rate_is_identity():
    x = np.arange(100, dtype=np.float32)
    assert TW.resample(x, 8000, 8000) is x


def test_mulaw_and_alaw_tables_match_jax():
    codes = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(TW._mulaw_decode(codes),
                                  JW._mulaw_decode(codes))
    np.testing.assert_array_equal(TW._alaw_decode(codes),
                                  JW._alaw_decode(codes))


def _shorten_cases():
    rng = np.random.default_rng(0)
    x2 = _ar_signal(rng, 1000, 2)
    z = np.zeros(777, np.int64)
    z[300:400] = rng.integers(-5000, 5000, 100)
    cases = {f"diff{f}_nmean{m}": enc.encode(x2, blocksize=256, nmean=m,
                                              force_cmd=f)
             for m in (0, 4)
             for f in (None, enc.FN_DIFF0, enc.FN_DIFF1, enc.FN_DIFF2,
                       enc.FN_DIFF3)}
    cases["qlpc"] = enc.encode(_ar_signal(rng, 2000, 2), blocksize=128,
                               nmean=4, qlpc_coeffs=[40, -20, 8])
    cases["qlpc_over_declared"] = enc.encode(
        _ar_signal(rng, 1500, 1), blocksize=128, nmean=4,
        qlpc_coeffs=[40, -20, 8], declare_maxnlpc=2)
    cases["zero_verbatim_tail"] = enc.encode(z, blocksize=256, nmean=4,
                                             verbatim_head=b"hdr\x00")
    cases["ulaw_bytes"] = enc.encode(
        rng.integers(0, 256, size=(500, 2)).astype(np.int64),
        ftype=enc.TYPE_ULAW, blocksize=64, nmean=4)
    return cases


SHORTEN = _shorten_cases()


@pytest.mark.parametrize("case", sorted(SHORTEN))
@pytest.mark.parametrize("max_samples", [None, 300])
def test_shorten_decode_matches_jax(case, max_samples):
    got = TS.decode(SHORTEN[case], max_samples=max_samples)
    want = JS.decode(SHORTEN[case], max_samples=max_samples)
    assert got[1] == want[1] and got[2] == want[2]
    assert got[0].dtype == want[0].dtype == np.int32
    np.testing.assert_array_equal(got[0], want[0])


def _raised(fn, payload):
    try:
        fn(payload, max_samples=4000)
    except (ValueError, EOFError, OverflowError, MemoryError) as e:
        return type(e), str(e)
    return None


def test_shorten_corrupt_streams_raise_as_jax():
    """Truncations, byte flips and garbage: the port raises the same
    exception type with the same message as the JAX package's decoder (or
    decodes the same samples)."""
    rng = np.random.default_rng(42)
    stream = bytearray(enc.encode(_ar_signal(rng, 2000, 2), blocksize=256,
                                  nmean=4))
    cases = [b"nope" + b"\x00" * 64, b"", b"ajkg\x07" + b"\x00" * 16]
    cases += [bytes(stream[:cut]) for cut in (5, 6, 20, len(stream) // 2,
                                              len(stream) - 3)]
    for _ in range(20):
        mut = bytearray(stream)
        for _ in range(rng.integers(1, 8)):
            mut[rng.integers(5, len(mut))] = rng.integers(0, 256)
        cases.append(bytes(mut))
    cases += [b"ajkg\x02" + rng.bytes(rng.integers(4, 200))
              for _ in range(10)]
    for payload in cases:
        got, want = _raised(TS.decode, payload), _raised(JS.decode, payload)
        assert got == want, payload[:16]
        if want is None:
            np.testing.assert_array_equal(
                TS.decode(payload, max_samples=4000)[0],
                JS.decode(payload, max_samples=4000)[0])


MFCC_CONF = """--sample-frequency=8000
--frame-length=25 # the default is 25
--low-freq=20 # the default.
--high-freq=3700 # the default is zero meaning use the Nyquist (4k in this case).
--num-ceps=23 # higher than the default which is 12.
--snip-edges=false
--dither=0.5
--window-type=hamming
--raw-energy=false
"""
VAD_CONF = """--vad-energy-threshold=5.5
--vad-energy-mean-scale=0.5
--vad-proportion-threshold=0.12
--vad-frames-context=2
"""


def test_conf_parsers_match_jax(tmp_path):
    (tmp_path / "mfcc.conf").write_text(MFCC_CONF)
    (tmp_path / "vad.conf").write_text(VAD_CONF)
    mp, vp = str(tmp_path / "mfcc.conf"), str(tmp_path / "vad.conf")
    assert TK.parse_conf(mp) == JK.parse_conf(mp)
    assert TK.parse_conf(vp) == JK.parse_conf(vp)
    for got, want in ((TK.mfcc_config_from_conf(mp),
                       JK.mfcc_config_from_conf(mp)),
                      (TK.vad_config_from_conf(vp),
                       JK.vad_config_from_conf(vp))):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert TK.mfcc_config_from_conf(mp).dither == 0.5
    assert TK.mfcc_config_from_conf(mp).raw_energy is False
