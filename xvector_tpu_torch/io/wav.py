"""Waveform loading: RIFF WAV and NIST SPHERE decode, and resampling.

Own copy of ``xvector_tpu/io/wav.py`` (numpy only).  It replaces the
``sph2pipe`` (C) + piped-decode-command pattern of the reference's data
prep (e.g. ``local/make_sre16_eval_BUT.pl:53`` builds ``sph2pipe -f wav
-p -c 1 file.sph |`` commands into wav.scp): an utterance resolves either
to a file this module decodes, or to a ``cmd |`` pipe run the Kaldi way.

SPHERE support covers the NIST corpora the recipe uses: 16-bit PCM in
either byte order, 8-bit µ-law and A-law, 1-2 channels with channel
selection, and embedded-shorten compression (``pcm,embedded-shorten-v2.00``
/ ``ulaw,embedded-shorten-v2.00``, the payload of LDC SRE04-10/SWBD
deliveries) through libxta's native decoder (``runtime/native.py``) where
a compiler is present, else through the pure-Python decoder in
``io/shorten.py``, which gives the same samples.
"""

from __future__ import annotations

import io
import math
import subprocess
from typing import Optional, Tuple

import numpy as np

from . import shorten

__all__ = ["load_wave", "read_wav", "read_sphere", "resample"]


def resample(samples: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Band-limited polyphase resampling (Kaiser-windowed sinc, scipy's
    ``resample_poly``), as the reference's sox/ffmpeg resample
    (``run.sh:135``) does for 16 kHz assets feeding the 8 kHz recipe.
    Falls back to linear interpolation only if scipy is unavailable."""
    samples = np.asarray(samples, np.float32)
    if sr_in == sr_out or not sr_in or not sr_out:
        return samples
    try:
        from scipy.signal import resample_poly
    except ImportError:
        n_out = int(round(len(samples) * sr_out / sr_in))
        return np.interp(
            np.arange(n_out) * (len(samples) - 1) / max(n_out - 1, 1),
            np.arange(len(samples)), samples).astype(np.float32)
    g = math.gcd(int(sr_in), int(sr_out))
    out = resample_poly(samples.astype(np.float64), sr_out // g, sr_in // g,
                        window=("kaiser", 5.0))
    return out.astype(np.float32)


def load_wave(spec: str, channel: Optional[int] = None
              ) -> Tuple[np.ndarray, int]:
    """Load from a wav.scp value: a path to .wav/.sph (with an optional
    ``#chN`` channel suffix), or a ``cmd |`` pipe producing a wav stream.
    Returns (float32 samples in int16 scale, sample_rate)."""
    spec = spec.strip()
    if "#ch" in spec and channel is None:     # call-corpus channel suffix
        spec, _, ch = spec.rpartition("#ch")
        channel = int(ch)
    if spec.endswith("|"):
        data = subprocess.run(spec[:-1], shell=True, check=True,
                              stdout=subprocess.PIPE).stdout
        return read_wav(io.BytesIO(data), channel)
    if spec.lower().endswith(".sph"):
        return read_sphere(spec, channel)
    with open(spec, "rb") as f:
        return read_wav(f, channel)


def read_wav(f, channel: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """Minimal RIFF/WAVE reader (16-bit and 8-bit PCM, float32)."""
    riff = f.read(12)
    if riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    fmt = None
    data = None
    while True:
        hdr = f.read(8)
        if len(hdr) < 8:
            break
        cid, size = hdr[:4], int.from_bytes(hdr[4:8], "little")
        payload = f.read(size + (size & 1))
        if cid == b"fmt ":
            fmt = payload
        elif cid == b"data":
            data = payload[:size]
            if fmt is not None:
                break
    if fmt is None or data is None:
        raise ValueError("missing fmt/data chunk")
    audio_format = int.from_bytes(fmt[0:2], "little")
    n_ch = int.from_bytes(fmt[2:4], "little")
    rate = int.from_bytes(fmt[4:8], "little")
    bits = int.from_bytes(fmt[14:16], "little")
    if audio_format == 1 and bits == 16:
        samples = np.frombuffer(data, dtype="<i2").astype(np.float32)
    elif audio_format == 1 and bits == 8:
        samples = (np.frombuffer(data, dtype=np.uint8).astype(np.float32)
                   - 128.0) * 256.0
    elif audio_format == 3 and bits == 32:
        samples = np.frombuffer(data, dtype="<f4").astype(np.float32) \
            * 32768.0
    else:
        raise ValueError(f"unsupported WAV format {audio_format}/{bits}bit")
    if n_ch > 1:
        samples = samples.reshape(-1, n_ch)
        samples = samples[:, channel if channel is not None else 0]
    return samples, rate


def _shorten_to_samples(payload: bytes, sample_count):
    """Decode an embedded-shorten payload to an (n, nchan) int32 array,
    preferring the native C++ decoder (``csrc/xta_io.cc``) and falling
    back to the pure-Python one (``io/shorten.py``)."""
    from ..runtime import native
    if native.available():
        return native.shorten_decode(payload, sample_count)
    samples, _, _ = shorten.decode(payload, max_samples=sample_count)
    return samples


_MULAW_BIAS = 0x84


def _alaw_decode(a: np.ndarray) -> np.ndarray:
    """G.711 A-law byte → linear (int16-scale float32).

    CCITT g711.c convention: after the even-bit (0x55) inversion, a SET
    sign bit means a POSITIVE sample."""
    a = a.astype(np.uint8) ^ 0x55          # even-bit inversion
    positive = (a & 0x80) != 0
    exponent = (a >> 4) & 0x07
    mantissa = (a & 0x0F).astype(np.int32)
    mag = np.where(exponent == 0,
                   (mantissa << 4) + 8,
                   ((mantissa << 4) + 0x108) << (exponent - 1))
    return np.where(positive, mag, -mag).astype(np.float32)


def _mulaw_decode(u: np.ndarray) -> np.ndarray:
    u = ~u.astype(np.uint8)
    sign = (u & 0x80) != 0
    exponent = (u >> 4) & 0x07
    mantissa = u & 0x0F
    magnitude = ((mantissa.astype(np.int32) << 3) + _MULAW_BIAS) \
        << exponent.astype(np.int32)
    magnitude -= _MULAW_BIAS
    return np.where(sign, -magnitude, magnitude).astype(np.float32)


def read_sphere(path: str, channel: Optional[int] = None
                ) -> Tuple[np.ndarray, int]:
    """NIST SPHERE reader (the sph2pipe use case: mono/stereo telephone
    speech, 16-bit PCM, µ-law or A-law, optionally embedded-shorten)."""
    with open(path, "rb") as f:
        magic = f.readline()
        if not magic.startswith(b"NIST_1A"):
            raise ValueError("not a NIST SPHERE file")
        header_size = int(f.readline().strip())
        f.seek(0)
        header = f.read(header_size).decode("latin1")
        fields = {}
        for line in header.splitlines()[2:]:
            parts = line.split()
            if len(parts) >= 3 and parts[0] != "end_head":
                key, typ, val = parts[0], parts[1], " ".join(parts[2:])
                fields[key] = int(val) if typ == "-i" else val
        n_ch = int(fields.get("channel_count", 1))
        rate = int(fields.get("sample_rate", 8000))
        n_bytes = int(fields.get("sample_n_bytes", 2))
        coding = str(fields.get("sample_coding", "pcm"))
        byte_fmt = str(fields.get("sample_byte_format", "01"))
        raw = f.read()
    if "shorten" in coding:
        n_count = fields.get("sample_count")
        decoded = _shorten_to_samples(
            raw, int(n_count) if n_count is not None else None)
        if "alaw" in coding:
            decoded = _alaw_decode(decoded.astype(np.uint8))
        elif "ulaw" in coding or n_bytes == 1:
            decoded = _mulaw_decode(decoded.astype(np.uint8))
        else:
            decoded = decoded.astype(np.float32)
        if decoded.ndim > 1 and decoded.shape[1] > 1:
            decoded = decoded[:, channel if channel is not None else 0]
        elif decoded.ndim > 1:
            decoded = decoded[:, 0]
        return decoded, rate
    if "alaw" in coding:
        samples = _alaw_decode(np.frombuffer(raw, dtype=np.uint8))
    elif "ulaw" in coding or n_bytes == 1:
        samples = _mulaw_decode(np.frombuffer(raw, dtype=np.uint8))
    else:
        dt = "<i2" if byte_fmt == "01" else ">i2"
        samples = np.frombuffer(raw, dtype=dt).astype(np.float32)
    if n_ch > 1:
        samples = samples[: (len(samples) // n_ch) * n_ch]
        samples = samples.reshape(-1, n_ch)
        samples = samples[:, channel if channel is not None else 0]
    return samples, rate
