"""Sequence-parallel x-vector extraction for long utterances.

Counterpart of ``xvector_tpu/parallel/seqshard.py``.  The reference bounds
sequence length by chunking any utterance to ≤10000 frames and
weight-averaging the chunks' x-vectors (``models.py:396-421``), an
approximation.  The exact x-vector is cheap to spread over ranks: the
frame-level layers are local convolutions (receptive field 15 for every
stock topology) and stats pooling is a sum over frames, so

* the time axis is split over the ranks of one mesh axis;
* each rank runs the frame stack (f32, plain PyTorch: the JAX package's
  ``tdnn.frame_stack`` here, no fused kernel) on its slice plus a halo of
  its neighbours' frames, exchanged in ONE all-reduce of a zero-filled
  (W, 2, halo, C + 1) buffer in which each rank fills its own first and
  last frames and their mask (gloo has no point-to-point on CUDA
  tensors);
* the masked pooling sums and counts are all-reduced;
* attention pooling (``models.py:1039-1051``) runs its softmax over time
  online across ranks: the maximum score by a max all-reduce, then the
  exp-sum and the weighted moments summed.

Every rank returns the same x-vector, with per-rank memory O(T / W).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models import tdnn
from . import mesh as meshlib

__all__ = ["seq_sharded_xvector"]


def _halo_exchange(x: torch.Tensor, halo: int, group) -> torch.Tensor:
    """(t, C) slice → (halo + t + halo, C): the left neighbour's last and
    the right neighbour's first ``halo`` frames around it, zeros at the
    sequence's ends."""
    n = torch.distributed.get_world_size(group)
    i = torch.distributed.get_rank(group)
    buf = torch.zeros((n, 2, halo) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    buf[i, 0] = x[:halo]
    buf[i, 1] = x[-halo:]
    torch.distributed.all_reduce(buf, group=group)
    zeros = torch.zeros_like(x[:halo])
    left = buf[i - 1, 1] if i > 0 else zeros
    right = buf[i + 1, 0] if i < n - 1 else zeros
    return torch.cat([left, x, right])


@torch.no_grad()
def seq_sharded_xvector(cfg: tdnn.TdnnConfig, params, state, x,
                        mesh: meshlib.Mesh,
                        valid_len: Optional[int] = None,
                        axis: str = "data") -> torch.Tensor:
    """Exact x-vector of one long utterance, its time axis split over the
    ranks of ``axis``.

    x: the whole (T, feat_dim) utterance (host array or tensor; each rank
    uses its slice) with T divisible by the axis size: pad with zeros and
    pass ``valid_len``.  ``params``/``state`` lie on the mesh's device.
    Returns (xvector_dim,) f32 on every rank."""
    if cfg.pooling not in ("stats", "attention"):
        raise ValueError(f"unknown pooling {cfg.pooling!r}")
    halo = sum((k - 1) // 2 * d
               for k, d in zip(cfg.kernel_sizes, cfg.dilations))
    x = torch.as_tensor(x)
    t_total = x.shape[0]
    n = mesh.shape[axis]
    if t_total % n:
        raise ValueError(f"sequence length {t_total} not divisible by "
                         f"{axis}={n}; pad and pass valid_len")
    if halo > t_total // n:
        raise ValueError(f"slices of {t_total // n} frames are shorter "
                         f"than the halo of {halo}")
    valid = t_total if valid_len is None else valid_len
    group = mesh.group(axis)
    t_local = t_total // n
    start = mesh.index(axis) * t_local
    xs = x[start:start + t_local].to(mesh.device, torch.float32)
    pos = torch.arange(start, start + t_local, device=mesh.device)
    mask = (pos < valid).to(torch.float32)[:, None]
    h = torch.cat([xs * mask, mask], dim=1)
    if group is not None:
        h = _halo_exchange(h, halo, group)
    else:   # one rank: the halo is the sequence's zero padding
        h = torch.nn.functional.pad(h, (0, 0, halo, halo))
    hh = tdnn.frame_stack(cfg, params, state, h[None, :, :-1],
                          h[None, :, -1])[0, halo:halo + t_local]
    m = mask
    if cfg.pooling == "attention":
        att = params["attention"]
        half = hh.shape[-1] // 2
        h1, h2 = hh[:, :half], hh[:, half:]
        scores = torch.tanh(h1 @ att["w"] + att["b"]) @ att["v"]   # (t,)
        scores = torch.where(m[:, 0] > 0, scores,
                             torch.full_like(scores, -1e30))
        g_max = meshlib.all_reduce_max(scores.max(), group)
        e = torch.exp(scores - g_max) * m[:, 0]
        sums = meshlib.all_reduce_sum(
            torch.cat([e.sum()[None], e @ h2, e @ h2.square()]), group)
        denom, s1, s2 = sums[0], sums[1:1 + half], sums[1 + half:]
        mean = s1 / denom
        var = s2 / denom - mean.square()
    else:
        c = hh.shape[-1]
        sums = meshlib.all_reduce_sum(
            torch.cat([m.sum()[None], (hh * m).sum(0),
                       (hh.square() * m).sum(0)]), group)
        count, s1, s2 = sums[0], sums[1:1 + c], sums[1 + c:]
        mean = s1 / count
        var = s2 / count - mean.square()
    pooled = torch.cat([mean, torch.sqrt(var.clamp(min=0.0)
                                         + tdnn.VAR2STD_EPSILON)])
    e0 = params["embed"][0]
    return (pooled @ e0["w"] + e0["b"]).to(torch.float32)
