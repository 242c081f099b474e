"""Feature front end: MFCC, energy VAD, sliding CMVN and voiced-frame
selection, per utterance and batched (counterpart of
``xvector_tpu/ops/features.py``).

It stands in for the Kaldi binaries the reference pipes together per
utterance (``compute-mfcc-feats | compute-vad-energy … apply-cmvn-sliding
| select-voiced-frames``, ``run.sh:97-101``, ``extract_xvectors.sh:68``),
with Kaldi's numerics: povey window, pre-emphasis 0.97, snip-edges=false
reflection framing, raw log-energy C0, orthonormal DCT-II, lifter 22.

Every function works on the device of the tensors it is given.  The
spectral products (the folded DFT, the mel bank, the DCT) run in float64,
where TF32 cannot reach them whatever ``torch.backends.cuda.matmul.
allow_tf32`` says, and the cepstra come back as float32.  Dither draws
from an explicit ``torch.Generator`` (the bits differ from JAX's).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["MfccConfig", "VadConfig", "mfcc", "mfcc_batch", "num_frames",
           "energy_vad", "energy_vad_batch", "sliding_cmvn",
           "sliding_cmvn_batch", "select_voiced_frames", "compact_voiced"]

_F64 = torch.float64
_EPS = float(np.finfo(np.float32).eps)


# ---------------------------------------------------------------------------
# Configs (conf/mfcc.conf + Kaldi defaults, conf/vad.conf)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MfccConfig:
    sample_rate: int = 8000
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    num_ceps: int = 23            # conf/mfcc.conf:5 (--num-ceps=23)
    num_mel_bins: int = 23        # Kaldi default for 8 kHz recipes
    low_freq: float = 20.0        # conf/mfcc.conf:3
    high_freq: float = 3700.0     # conf/mfcc.conf:4
    preemph: float = 0.97
    dither: float = 1.0
    remove_dc_offset: bool = True
    window_type: str = "povey"
    raw_energy: bool = True
    use_energy: bool = True
    energy_floor: float = 0.0
    cepstral_lifter: float = 22.0
    snip_edges: bool = False      # conf/mfcc.conf:6

    @property
    def frame_length(self) -> int:
        return int(self.sample_rate * self.frame_length_ms / 1000.0)

    @property
    def frame_shift(self) -> int:
        return int(self.sample_rate * self.frame_shift_ms / 1000.0)

    @property
    def fft_size(self) -> int:
        n = 1
        while n < self.frame_length:
            n *= 2
        return n


@dataclass(frozen=True)
class VadConfig:
    energy_threshold: float = 5.5       # conf/vad.conf:1
    energy_mean_scale: float = 0.5      # conf/vad.conf:2
    proportion_threshold: float = 0.12  # conf/vad.conf:3
    frames_context: int = 2             # conf/vad.conf:4


# ---------------------------------------------------------------------------
# Window / mel / DCT constants (built on the host in f64)
# ---------------------------------------------------------------------------

def _window_f64(cfg: MfccConfig) -> np.ndarray:
    n = cfg.frame_length
    a = 2.0 * math.pi / (n - 1)
    i = np.arange(n, dtype=np.float64)
    hann = 0.5 - 0.5 * np.cos(a * i)
    if cfg.window_type == "povey":
        w = hann ** 0.85
    elif cfg.window_type == "hanning":
        w = hann
    elif cfg.window_type == "hamming":
        w = 0.54 - 0.46 * np.cos(a * i)
    elif cfg.window_type == "rectangular":
        w = np.ones(n)
    else:
        raise ValueError(f"unknown window {cfg.window_type}")
    return w


def _window_fn(cfg: MfccConfig) -> np.ndarray:
    return _window_f64(cfg).astype(np.float32)


def _mel_scale(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


def _mel_banks(cfg: MfccConfig) -> np.ndarray:
    """(num_mel_bins, fft_size//2) triangular filters, Kaldi MelBanks layout
    (nyquist bin excluded)."""
    num_fft_bins = cfg.fft_size // 2
    nyquist = 0.5 * cfg.sample_rate
    high = cfg.high_freq if cfg.high_freq > 0 else nyquist + cfg.high_freq
    mel_low, mel_high = _mel_scale(cfg.low_freq), _mel_scale(high)
    mel_delta = (mel_high - mel_low) / (cfg.num_mel_bins + 1)
    fft_bin_width = cfg.sample_rate / cfg.fft_size
    mel_of_bin = _mel_scale(fft_bin_width * np.arange(num_fft_bins))
    banks = np.zeros((cfg.num_mel_bins, num_fft_bins), dtype=np.float64)
    for b in range(cfg.num_mel_bins):
        left = mel_low + b * mel_delta
        center = mel_low + (b + 1) * mel_delta
        right = mel_low + (b + 2) * mel_delta
        up = (mel_of_bin - left) / (center - left)
        down = (right - mel_of_bin) / (right - center)
        banks[b] = np.clip(np.minimum(up, down), 0.0, None)
    return banks.astype(np.float32)


def _dct_matrix(num_ceps: int, num_bins: int) -> np.ndarray:
    """Orthonormal DCT-II rows (Kaldi ComputeDctMatrix)."""
    j = np.arange(num_bins, dtype=np.float64)
    m = np.zeros((num_ceps, num_bins), dtype=np.float64)
    m[0] = 1.0 / math.sqrt(num_bins)
    for k in range(1, num_ceps):
        m[k] = math.sqrt(2.0 / num_bins) * np.cos(
            math.pi / num_bins * (j + 0.5) * k)
    return m.astype(np.float32)


def _lifter_coeffs(num_ceps: int, q: float) -> np.ndarray:
    i = np.arange(num_ceps, dtype=np.float64)
    return (1.0 + 0.5 * q * np.sin(math.pi * i / q)).astype(np.float32)


def _dft_matrices(cfg: MfccConfig) -> tuple[np.ndarray, np.ndarray]:
    """Real-DFT (cos, sin) matrices of shape (frame_length, fft_size//2);
    the zero-padding beyond frame_length is implicit (those rows would
    multiply zeros)."""
    n = np.arange(cfg.frame_length, dtype=np.float64)[:, None]
    k = np.arange(cfg.fft_size // 2, dtype=np.float64)[None, :]
    ang = 2.0 * math.pi * n * k / cfg.fft_size
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _folded_dft(cfg: MfccConfig) -> np.ndarray:
    """(frame_length, 2*(fft//2)) [cos | sin] real-DFT matrix with the
    per-frame linear pre-processing folded in, built in f64.

    Kaldi's ProcessWindow applies, per frame x: DC-offset removal
    (D = I − 11ᵀ/L), pre-emphasis (P[0,0] = 1−p, P[i,i] = 1, P[i,i−1] =
    −p), the window (diag w), then the DFT (Cᵀ·).  All four are linear in
    the raw window, so Cᵀ·W·P·D·x = (Dᵀ Pᵀ (w⊙C))ᵀ x: the frames go into
    one matmul with no per-frame elementwise passes."""
    L = cfg.frame_length
    n = np.arange(L, dtype=np.float64)[:, None]
    k = np.arange(cfg.fft_size // 2, dtype=np.float64)[None, :]
    ang = 2.0 * math.pi * n * k / cfg.fft_size
    m = np.concatenate([np.cos(ang), np.sin(ang)], axis=1)
    m = _window_f64(cfg)[:, None] * m
    if cfg.preemph != 0.0:
        p = cfg.preemph
        mp = m.copy()
        mp[:-1] -= p * m[1:]
        mp[0] -= p * m[0]
        m = mp
    if cfg.remove_dc_offset:
        m = m - m.sum(axis=0, keepdims=True) / L
    return m.astype(np.float32)


_CONSTANTS = {
    "window": _window_fn,
    "mel": _mel_banks,
    "dct": lambda c: _dct_matrix(c.num_ceps, c.num_mel_bins),
    "lifter": lambda c: _lifter_coeffs(c.num_ceps, c.cepstral_lifter),
    "cos": lambda c: _dft_matrices(c)[0],
    "sin": lambda c: _dft_matrices(c)[1],
    "folded": _folded_dft,
}


@functools.lru_cache(maxsize=64)
def _const(name: str, cfg: MfccConfig, device: torch.device) -> torch.Tensor:
    """A host constant as an f64 tensor on ``device``, uploaded once."""
    return torch.from_numpy(
        np.asarray(_CONSTANTS[name](cfg), np.float64)).to(device)


# ---------------------------------------------------------------------------
# Framing
# ---------------------------------------------------------------------------

def num_frames(num_samples: int, cfg: MfccConfig) -> int:
    """Frame count (Kaldi NumFrames)."""
    if cfg.snip_edges:
        if num_samples < cfg.frame_length:
            return 0
        return 1 + (num_samples - cfg.frame_length) // cfg.frame_shift
    return (num_samples + cfg.frame_shift // 2) // cfg.frame_shift


def _frame_indices(num_samples: int, cfg: MfccConfig) -> np.ndarray:
    """(T, frame_length) int32 sample indices with Kaldi reflection for
    snip-edges=false (sample -1 ↔ 0, num_samples ↔ num_samples-1)."""
    t = num_frames(num_samples, cfg)
    starts = np.arange(t) * cfg.frame_shift
    if not cfg.snip_edges:
        starts = starts + cfg.frame_shift // 2 - cfg.frame_length // 2
    idx = starts[:, None] + np.arange(cfg.frame_length)[None, :]
    idx = np.where(idx < 0, -idx - 1, idx)
    idx = np.where(idx >= num_samples, 2 * num_samples - idx - 1, idx)
    return np.clip(idx, 0, num_samples - 1).astype(np.int32)


# ---------------------------------------------------------------------------
# MFCC
# ---------------------------------------------------------------------------

def _dither(x: torch.Tensor, cfg: MfccConfig,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    if generator is None:
        return x
    return x + cfg.dither * torch.randn(x.shape, generator=generator,
                                        device=x.device, dtype=x.dtype)


def _mfcc_from_frames(frames: torch.Tensor, cfg: MfccConfig,
                      generator: Optional[torch.Generator]) -> torch.Tensor:
    """frames: (..., T, frame_length) raw sample windows → (..., T,
    num_ceps) f32, the per-frame chain written out."""
    x = _dither(frames.to(torch.float32), cfg, generator).to(_F64)
    if cfg.remove_dc_offset:
        x = x - x.mean(dim=-1, keepdim=True)
    if cfg.raw_energy:
        log_energy = torch.log((x * x).sum(-1).clamp(min=_EPS))
    if cfg.preemph != 0.0:
        x = x - cfg.preemph * torch.cat([x[..., :1], x[..., :-1]], dim=-1)
    x = x * _const("window", cfg, x.device)
    if not cfg.raw_energy:
        log_energy = torch.log((x * x).sum(-1).clamp(min=_EPS))
    re = x @ _const("cos", cfg, x.device)
    im = x @ _const("sin", cfg, x.device)
    return _ceps_from_power(re * re + im * im, log_energy, cfg)


def _folded_ceps(x: torch.Tensor, cfg: MfccConfig,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """(…, frame_length) raw sample windows → (…, num_ceps) f32 cepstra
    through the folded DFT matrix (:func:`_folded_dft`).  Valid for
    ``cfg.raw_energy`` (or energy unused): the post-window energy of
    raw_energy=False needs the windowed frame itself."""
    x = _dither(x.to(torch.float32), cfg, generator).to(_F64)
    if cfg.remove_dc_offset:
        # mean-subtract before squaring: sum(x²) − sum(x)²/L cancels when a
        # frame's DC offset dominates its AC power
        energy = (x - x.mean(dim=-1, keepdim=True)).square().sum(-1)
    else:
        energy = (x * x).sum(-1)
    log_energy = torch.log(energy.clamp(min=_EPS))
    acc = x @ _const("folded", cfg, x.device)
    n_bins = cfg.fft_size // 2
    re, im = acc[..., :n_bins], acc[..., n_bins:]
    return _ceps_from_power(re * re + im * im, log_energy, cfg)


def _ceps_from_power(power, log_energy, cfg: MfccConfig) -> torch.Tensor:
    """f64 power (…, fft//2) + per-frame log energy → (…, num_ceps) f32
    cepstra: mel fbank, log, DCT, lifter, energy substitution."""
    mel = power @ _const("mel", cfg, power.device).T
    log_mel = torch.log(mel.clamp(min=_EPS))
    ceps = log_mel @ _const("dct", cfg, power.device).T
    if cfg.cepstral_lifter != 0.0:
        ceps = ceps * _const("lifter", cfg, power.device)
    if cfg.use_energy:
        if cfg.energy_floor > 0.0:
            log_energy = log_energy.clamp(min=math.log(cfg.energy_floor))
        ceps = torch.cat([log_energy[..., None], ceps[..., 1:]], dim=-1)
    return ceps.to(torch.float32)


def mfcc(waveform, cfg: MfccConfig = MfccConfig(),
         generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(T, num_ceps) f32 MFCC of a 1-D waveform of int16-scale floats, on
    the waveform's device (a numpy array goes to the CPU).

    ``generator`` enables dither (None, or ``cfg.dither == 0``, turns it
    off)."""
    waveform = torch.as_tensor(waveform).to(torch.float32)
    idx = torch.from_numpy(_frame_indices(int(waveform.shape[0]), cfg)).to(
        waveform.device, torch.int64)
    if cfg.dither == 0.0:
        generator = None
    return _mfcc_from_frames(waveform[idx], cfg, generator)


# ---------------------------------------------------------------------------
# Energy VAD (compute-vad-energy semantics)
# ---------------------------------------------------------------------------

def _box_sum(x: torch.Tensor, context: int) -> torch.Tensor:
    """Per-row sums over the ±context window along the last axis (zero
    beyond the ends); exact for 0/1 counts."""
    c = torch.cumsum(F.pad(x, (context + 1, context)), dim=-1)
    w = 2 * context + 1
    return c[..., w:] - c[..., :-w]


def energy_vad(feats: torch.Tensor, cfg: VadConfig = VadConfig()
               ) -> torch.Tensor:
    """Per-frame 0/1 voiced decisions (f32) from MFCC column 0 (log
    energy): a frame is voiced when ≥ ``proportion_threshold`` of the
    frames in its ±context window exceed ``energy_threshold + mean_scale
    · mean(energy)``.  The threshold is formed in f64."""
    log_e = feats[:, 0].to(_F64)
    thresh = cfg.energy_threshold
    if cfg.energy_mean_scale != 0.0:
        thresh = thresh + cfg.energy_mean_scale * log_e.mean()
    above = (log_e > thresh).to(torch.float32)[None]
    num = _box_sum(above, cfg.frames_context)
    den = _box_sum(torch.ones_like(above), cfg.frames_context)
    return (num >= den * cfg.proportion_threshold).to(torch.float32)[0]


# ---------------------------------------------------------------------------
# Sliding-window CMVN (apply-cmvn-sliding --center=true semantics)
# ---------------------------------------------------------------------------

def _window_sums(v: torch.Tensor, win: int) -> torch.Tensor:
    """All size-``win`` window sums along axis 0, (T, D) → (T-win+1, D),
    from an f64 prefix sum (exact enough that the cumsum difference loses
    nothing at f32 output precision)."""
    c = F.pad(torch.cumsum(v.to(_F64), dim=0), (0, 0, 1, 0))
    return c[win:] - c[:-win]


def sliding_cmvn(feats: torch.Tensor, window: int = 300, center: bool = True,
                 normalize_variance: bool = False) -> torch.Tensor:
    """Subtract a sliding-window mean from each frame of (T, D) features
    (``apply-cmvn-sliding``).

    Kaldi window placement: nominally centered on the frame, clamped so the
    window keeps ``min(T, window)`` frames at the edges — near the
    boundaries the window slides rather than shrinks."""
    t = feats.shape[0]
    win = min(window, t)
    x = feats.to(torch.float32)
    sums = _window_sums(x, win)
    starts = torch.arange(t, device=feats.device)
    starts = starts - (win // 2 if center else win - 1)
    idx = starts.clamp(0, t - win)
    mean = (sums[idx] / win).to(torch.float32)
    out = feats - mean.to(feats.dtype)
    if normalize_variance:
        var = (_window_sums(x.square(), win)[idx] / win).to(torch.float32) \
            - mean.square()
        out = out * torch.rsqrt(var.clamp(min=1e-10)).to(feats.dtype)
    return out


# ---------------------------------------------------------------------------
# Voiced-frame selection
# ---------------------------------------------------------------------------

def select_voiced_frames(feats: np.ndarray, vad: np.ndarray) -> np.ndarray:
    """Host-side ragged compaction (``select-voiced-frames``): keep rows
    where vad > 0.5."""
    return np.asarray(feats)[np.asarray(vad) > 0.5]


# ---------------------------------------------------------------------------
# Batched masked front end: the whole chain over a padded (B, S) batch of
# waveforms with per-row sample counts; per-row validity travels as a frame
# mask, and voiced-frame selection is a stable sort-to-front compaction, so
# the frame stack sees the compacted sequences the reference's pipe makes.
# ---------------------------------------------------------------------------

def _num_frames_device(n_samples: torch.Tensor, cfg: MfccConfig):
    if cfg.snip_edges:
        return torch.where(
            n_samples < cfg.frame_length, 0,
            1 + (n_samples - cfg.frame_length) // cfg.frame_shift)
    return (n_samples + cfg.frame_shift // 2) // cfg.frame_shift


def mfcc_batch(waves: torch.Tensor, n_samples: torch.Tensor,
               cfg: MfccConfig = MfccConfig(),
               generator: Optional[torch.Generator] = None):
    """Batched MFCC over padded waveforms, on their device.

    ``waves``: (B, S) int16-scale samples (any real or integer dtype),
    zero-padded; ``n_samples``: (B,) valid sample counts.  Returns
    ``(feats (B, T, num_ceps) f32, frame_mask (B, T) f32)`` where T is the
    frame count of the padded length; row b's first ``t_b`` frames equal
    ``mfcc(waves[b, :n_samples[b]])`` (up to dither draws), and the frames
    past ``t_b`` are masked."""
    waves = torch.as_tensor(waves).to(torch.float32)
    dev = waves.device
    b, s = waves.shape
    t = num_frames(s, cfg)
    shift, length = cfg.frame_shift, cfg.frame_length
    # clamp: an n_samples beyond the buffer would claim phantom frames
    n_samples = torch.as_tensor(n_samples).to(dev, torch.int64).clamp(max=s)
    if cfg.remove_dc_offset:
        # per-frame DC removal is invariant to a constant shift, so take
        # each row's mean out first: the frames then carry no large DC
        # term into the energy and the spectrum
        valid = torch.arange(s, device=dev)[None, :] < n_samples[:, None]
        row_mean = (torch.where(valid, waves, 0.0).sum(1, dtype=_F64)
                    / n_samples.clamp(min=1)).to(torch.float32)
        waves = torch.where(valid, waves - row_mean[:, None], 0.0)

    # Framing without a gather: frame j is padded[j*shift : j*shift+length]
    # of the stream with the left snip-edges=false reflection prepended (a
    # global flip: indices < 0 reflect into the first samples, whatever
    # the row).  Only the ≤ k_fix tail frames whose window crosses a row's
    # own n_samples need the per-row reflection, fixed below.
    lpad = (length // 2 - shift // 2) if not cfg.snip_edges else 0
    k_chunks = -(-length // shift)            # chunks spanned by a frame
    padded_len = (t - 1 + k_chunks) * shift
    # Kaldi mirrors about -0.5: sample -k reflects to k-1.  A buffer shorter
    # than the reflection is clamped: every frame of such a batch is a
    # tail frame, rewritten by the exact per-row formula below.
    lpad_eff = min(lpad, s)
    parts = [waves[:, :lpad_eff].flip(1), waves]
    if padded_len > lpad_eff + s:
        parts.append(waves.new_zeros((b, padded_len - lpad_eff - s)))
    padded = torch.cat(parts, dim=1)[:, :padded_len]
    frames = (padded.unfold(1, length, shift)[:, :t] if t > 0
              else waves.new_zeros((b, 0, length)))

    # per-row tail fix: the last k_fix valid frames may read past
    # n_samples (zeros in the padding) where Kaldi reflects
    n = n_samples.clamp(min=1)[:, None, None]
    t_i = _num_frames_device(n_samples, cfg)
    k_fix = length // shift + 2
    j_fix = (t_i[:, None] - k_fix
             + torch.arange(k_fix, device=dev)[None, :]).clamp(
                 0, max(t - 1, 0))                              # (B, K)
    idx = (j_fix * shift - lpad)[..., None] + torch.arange(length,
                                                           device=dev)
    idx = torch.where(idx < 0, -idx - 1, idx)
    idx = torch.where(idx >= n, 2 * n - idx - 1, idx)
    idx = torch.minimum(idx.clamp(min=0), n - 1)                # (B, K, L)
    fix_vals = torch.gather(waves, 1, idx.reshape(b, -1)).reshape(
        b, k_fix, length)
    if cfg.dither == 0.0:
        generator = None
    rows = torch.arange(b, device=dev)[:, None]
    if cfg.raw_energy or not cfg.use_energy:
        # the folded path: cepstra of the bulk frames and of the tail
        # frames, the tail's written over the bulk's per row
        feats = _folded_ceps(frames, cfg, generator)
        fix_feats = _folded_ceps(fix_vals, cfg, generator)
        # j_fix slots clipped onto the same frame would write different
        # values under dither (per-slot draws), and index_put_ with
        # duplicate indices writes in no fixed order on the card: send every
        # dead duplicate (same j as its successor) to a dummy row t
        live = torch.cat([j_fix[:, :-1] != j_fix[:, 1:],
                          torch.ones((b, 1), dtype=torch.bool, device=dev)],
                         dim=1)
        j_sc = torch.where(live, j_fix, t)
        feats = torch.cat([feats, feats.new_zeros((b, 1, cfg.num_ceps))],
                          dim=1)
        feats[rows, j_sc] = fix_feats
        feats = feats[:, :t]
    else:
        frames = frames.clone(memory_format=torch.contiguous_format)
        frames[rows, j_fix] = fix_vals
        feats = _mfcc_from_frames(frames, cfg, generator)
    mask = (torch.arange(t, device=dev)[None, :]
            < t_i[:, None]).to(torch.float32)
    return feats, mask


def energy_vad_batch(feats: torch.Tensor, mask: torch.Tensor,
                     cfg: VadConfig = VadConfig()) -> torch.Tensor:
    """Masked batched ``compute-vad-energy``: (B, T, C) + frame mask →
    (B, T) 0/1 voiced decisions (0 on padding).  Row b equals
    ``energy_vad(feats[b, :t_b])``."""
    log_e = feats[..., 0].to(_F64)
    valid = mask > 0
    thresh = cfg.energy_threshold
    if cfg.energy_mean_scale != 0.0:
        mean_e = (torch.where(valid, log_e, 0.0).sum(-1, keepdim=True)
                  / mask.sum(-1, keepdim=True, dtype=_F64).clamp(min=1.0))
        thresh = thresh + cfg.energy_mean_scale * mean_e
    above = ((log_e > thresh) & valid).to(torch.float32)
    num = _box_sum(above, cfg.frames_context)
    den = _box_sum(valid.to(torch.float32), cfg.frames_context)
    return ((num >= den * cfg.proportion_threshold) & valid).to(
        torch.float32)


def sliding_cmvn_batch(feats: torch.Tensor, mask: torch.Tensor,
                       window: int = 300, center: bool = True,
                       normalize_variance: bool = False) -> torch.Tensor:
    """Masked batched sliding CMVN with per-row Kaldi window clamping: the
    window of row b is ``min(window, t_b)`` frames and slides rather than
    shrinks at the edges.  Window sums are differences of f64 prefix sums
    (accurate over 10k-frame rows); padding comes back zero."""
    b, t, c = feats.shape
    m = mask.to(torch.float32)[..., None]
    x = feats.to(_F64) * m
    t_i = mask.sum(-1).to(torch.int64).clamp(min=1)            # (B,)
    win = t_i.clamp(max=window)                                # (B,)
    pos = torch.arange(t, device=feats.device)[None, :]
    start = pos - (win[:, None] // 2 if center else win[:, None] - 1)
    start = torch.minimum(start.clamp(min=0), (t_i - win)[:, None])
    end = start + win[:, None]

    def window_mean(v):
        csum = F.pad(torch.cumsum(v, dim=1), (0, 0, 1, 0))      # (B, T+1, C)
        take = lambda i: torch.gather(csum, 1, i[..., None].expand(b, t, c))
        return (take(end) - take(start)) / win[:, None, None]

    mean = window_mean(x)
    out = feats - mean.to(feats.dtype)
    if normalize_variance:
        var = window_mean(x.square()) - mean.square()
        out = out * torch.rsqrt(var.clamp(min=1e-10)).to(out.dtype)
    return out * m.to(out.dtype)


def compact_voiced(feats: torch.Tensor, vad: torch.Tensor):
    """Static-shape ``select-voiced-frames``: stably move voiced frames to
    the front of each row.  Returns ``(compacted feats, new frame mask)``;
    row b's first ``sum(vad[b])`` frames equal the reference pipe's
    compacted sequence, and the rest are zero (the frame stack's masked
    frames rely on it)."""
    order = torch.argsort(1.0 - vad, dim=1, stable=True)
    out = torch.gather(feats, 1, order[..., None].expand_as(feats))
    count = vad.sum(1).to(torch.int64)
    new_mask = (torch.arange(feats.shape[1], device=feats.device)[None, :]
                < count[:, None]).to(torch.float32)
    return out * new_mask[..., None].to(out.dtype), new_mask
