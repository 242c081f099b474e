"""Plain reference of extraction's feature handling and chunk protocol.

Kaldi's ``apply-cmvn-sliding --center=true --norm-vars=false
--cmn-window=300`` (the window holds ``min(T, 300)`` frames, centred on
the frame and slid, not shrunk, at the edges), ``select-voiced-frames``
(keep frames whose VAD decision is above 0.5), and the recipe's x-vector
chunking (``extract_xvectors.sh``: consecutive chunks of at most
``max_chunk`` frames, a last chunk shorter than ``min_chunk`` dropped, the
x-vector the frame-weighted mean of the chunks').
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from . import tdnn


def sliding_cmvn(feats: torch.Tensor, window: int = 300) -> torch.Tensor:
    """(T, D) features minus their sliding-window mean, in float64 sums."""
    t = feats.shape[0]
    win = min(window, t)
    c = torch.cat([torch.zeros(1, feats.shape[1], dtype=torch.float64,
                               device=feats.device),
                   torch.cumsum(feats.to(torch.float64), 0)])
    start = (torch.arange(t, device=feats.device) - win // 2).clamp(0, t - win)
    mean = (c[start + win] - c[start]) / win
    return (feats.to(torch.float64) - mean).to(torch.float32)


def select_voiced(feats: torch.Tensor, vad: torch.Tensor) -> torch.Tensor:
    return feats[vad > 0.5]


def chunks(n: int, min_chunk: int, max_chunk: int) -> List[Tuple[int, int]]:
    """(offset, length) of each chunk of an n-frame utterance."""
    out = []
    for off in range(0, n, max_chunk):
        ln = min(max_chunk, n - off)
        if ln >= min_chunk:
            out.append((off, ln))
    return out


def xvector(cfg, params, stats, feats: torch.Tensor, vad: torch.Tensor,
            ext, lowp=None) -> torch.Tensor:
    """The x-vector of one utterance from its raw (T, F) features and VAD,
    chunk by chunk."""
    x = select_voiced(sliding_cmvn(feats, ext["cmvn_window"]), vad)
    total, weight = None, 0
    for off, ln in chunks(x.shape[0], ext["min_chunk"], ext["max_chunk"]):
        h = tdnn.frame_stack_eval(cfg, params, stats, x[None, off:off + ln],
                                  lowp)
        xv = tdnn.embed_eval(params, tdnn.stats_pool(h), lowp)[0]
        total = ln * xv if total is None else total + ln * xv
        weight += ln
    return None if total is None else total / weight
