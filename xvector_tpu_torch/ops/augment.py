"""Data augmentation: RIR reverberation and additive noise mixing
(counterpart of ``xvector_tpu/ops/augment.py``).

Stands in for the reference's augmentation stage, which shells out to
Kaldi's ``wav-reverberate`` through ``reverberate_data_dir.py`` (RIR
convolution, ``run.sh:124-142``) and ``augment_data_dir.py`` (MUSAN
noise/music/babble at fixed SNR sets, ``run.sh:155-163``).

:func:`fir_conv` convolves through ``torch.fft`` in float64 (the TPU
built a blocked-Toeplitz matmul because it had no FFT; an FFT product is
exact to ~1e-12 relative here and no TF32 setting reaches it).  The math
runs on the tensors' device and comes back as float32.

SNR semantics follow ``wav-reverberate --snrs``: noise is scaled so that
10·log10(P_signal / P_noise_scaled) equals the requested SNR, with the
reference recipe's SNR sets (noise ``--fg-snrs 10:5``, music ``--bg-snrs
10:7:5``, babble ``--bg-snrs 19:17:15:13`` with ``--num-bg-noises
3:4:5:6:7``, run.sh:156-163).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import resolve_device

__all__ = ["fir_conv", "reverberate", "mix_noise", "AugmentConfig",
           "augment_utterance", "NOISE_SNRS", "MUSIC_SNRS", "BABBLE_SNRS"]

NOISE_SNRS = (10.0, 5.0)                # run.sh:156 --fg-snrs "10:5"
MUSIC_SNRS = (10.0, 7.0, 5.0)           # run.sh:159 --bg-snrs "10:7:5"
BABBLE_SNRS = (19.0, 17.0, 15.0, 13.0)  # run.sh:162 --bg-snrs "19:17:15:13"

_F64 = torch.float64


def fir_conv(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """y[n] = Σ_k h[k]·x[n-k] for n in [0, len(x)): "same-start" FIR
    filtering (what wav-reverberate applies, output trimmed to the input
    length), on x's device, f32 out."""
    x = torch.as_tensor(x).to(_F64)
    h = torch.as_tensor(h).to(x.device, _F64)
    n = x.shape[0]
    nfft = 1 << max(n + h.shape[0] - 2, 1).bit_length()   # ≥ n + k - 1
    y = torch.fft.irfft(torch.fft.rfft(x, nfft) * torch.fft.rfft(h, nfft),
                        nfft)
    return y[:n].to(torch.float32)


def _power(x: torch.Tensor) -> torch.Tensor:
    return x.to(_F64).square().mean() + 1e-20


def reverberate(x: torch.Tensor, rir: torch.Tensor,
                normalize_power: bool = True) -> torch.Tensor:
    """Convolve with a room impulse response; rescale so output power
    matches input power (wav-reverberate --volume behaviour used by
    reverberate_data_dir.py)."""
    x = torch.as_tensor(x)
    y = fir_conv(x, rir)
    if normalize_power:
        y = (y * torch.sqrt(_power(x) / _power(y))).to(torch.float32)
    return y


def _fit_length(noise: torch.Tensor, n: int, offset: int = 0
                ) -> torch.Tensor:
    """Crop/tile a noise signal to exactly n samples starting at offset."""
    reps = -(-(n + offset) // noise.shape[0])
    return noise.repeat(reps)[offset: offset + n]


def mix_noise(x: torch.Tensor, noise: torch.Tensor, snr_db: float,
              offset: int = 0) -> torch.Tensor:
    """Add noise at the given SNR (dB), tiling/cropping the noise to cover
    the whole signal (augment_data_dir.py background-noise semantics)."""
    x = torch.as_tensor(x).to(torch.float32)
    noise = _fit_length(torch.as_tensor(noise).to(x.device, torch.float32),
                        x.shape[0], offset)
    scale = torch.sqrt(_power(x) / _power(noise) / 10.0 ** (snr_db / 10.0))
    return (x + scale * noise).to(torch.float32)


@dataclass(frozen=True)
class AugmentConfig:
    """One augmented copy per clean utterance per kind, reference-style:
    the recipe builds full-size reverb/noise/music/babble copies and
    combines all of them with the clean list (run.sh:124-171).  RIR
    sampling is uniform over the provided list; pass equally-sized
    small+medium room lists to reproduce the 0.5/0.5
    ``--rir-set-parameters`` split (run.sh:126-127)."""
    noise_snrs: Tuple[float, ...] = NOISE_SNRS
    music_snrs: Tuple[float, ...] = MUSIC_SNRS
    babble_snrs: Tuple[float, ...] = BABBLE_SNRS
    babble_speakers: Tuple[int, int] = (3, 7)   # augment_data_dir defaults


def augment_utterance(kind: str, x: np.ndarray, rng: np.random.RandomState,
                      cfg: AugmentConfig,
                      rirs: Optional[Union[Sequence[np.ndarray],
                                           Mapping[str, Sequence[np.ndarray]]
                                           ]] = None,
                      noises: Optional[Sequence[np.ndarray]] = None,
                      musics: Optional[Sequence[np.ndarray]] = None,
                      speeches: Optional[Sequence[np.ndarray]] = None,
                      device="cuda") -> np.ndarray:
    """One augmented copy (f32 numpy) of ``x``; ``kind`` ∈
    reverb|noise|music|babble.  The picks (RIR, noise, SNR, offset) come
    from ``rng`` on the host in the JAX package's order, the math runs on
    ``device``.

    ``rirs`` may be a mapping ``room_type → list of RIRs``: the room type
    is then sampled uniformly first, reproducing the reference's equal
    ``--rir-set-parameters`` split regardless of list sizes."""
    dev = resolve_device(device)

    def on(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    if kind == "reverb":
        if isinstance(rirs, Mapping):
            room = sorted(rirs)[rng.randint(len(rirs))]
            rirs = rirs[room]
        rir = rirs[rng.randint(len(rirs))]
        return reverberate(on(x), on(rir)).cpu().numpy()
    if kind == "noise":
        snr = cfg.noise_snrs[rng.randint(len(cfg.noise_snrs))]
        noise = noises[rng.randint(len(noises))]
        offset = int(rng.randint(max(len(noise), 1)))
        return mix_noise(on(x), on(noise), snr, offset=offset).cpu().numpy()
    if kind == "music":
        snr = cfg.music_snrs[rng.randint(len(cfg.music_snrs))]
        music = musics[rng.randint(len(musics))]
        return mix_noise(on(x), on(music), snr).cpu().numpy()
    if kind == "babble":
        snr = cfg.babble_snrs[rng.randint(len(cfg.babble_snrs))]
        lo, hi = cfg.babble_speakers
        n_spk = rng.randint(lo, hi + 1)
        picks = [speeches[rng.randint(len(speeches))] for _ in range(n_spk)]
        babble = np.zeros(max(len(p) for p in picks), np.float32)
        for p in picks:
            babble[: len(p)] += np.asarray(p, np.float32)
        return mix_noise(on(x), on(babble), snr).cpu().numpy()
    raise ValueError(f"unknown augmentation kind {kind!r}")
