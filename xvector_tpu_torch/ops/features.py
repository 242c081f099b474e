"""Feature post-processing for extraction: sliding CMVN and voiced-frame
selection (counterparts of ``xvector_tpu/ops/features.py:sliding_cmvn``
and ``select_voiced_frames``).  MFCC, energy VAD and the batched wave
front end are not ported yet."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["sliding_cmvn", "select_voiced_frames"]


def _window_sums(v: torch.Tensor, win: int) -> torch.Tensor:
    """All size-``win`` window sums along axis 0, (T, D) → (T-win+1, D),
    from an f64 prefix sum (exact enough that the cumsum difference loses
    nothing at f32 output precision)."""
    c = F.pad(torch.cumsum(v.to(torch.float64), dim=0), (0, 0, 1, 0))
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


def select_voiced_frames(feats: np.ndarray, vad: np.ndarray) -> np.ndarray:
    """Host-side ragged compaction (``select-voiced-frames``): keep rows
    where vad > 0.5."""
    return np.asarray(feats)[np.asarray(vad) > 0.5]
