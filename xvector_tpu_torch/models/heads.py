"""Classifier heads and losses.

Counterpart of ``xvector_tpu/models/heads.py``: :func:`softmax_ce`, the
reference's training objective (``models.py:511-517``,
``softmax_cross_entropy_with_logits`` → ``reduce_mean``), and
:func:`accuracy`, both weighted by a (B,) row weight that leaves pad rows
out.  ``am_softmax`` and ``sharded_softmax_ce`` are not ported yet.
"""

from __future__ import annotations

import torch

__all__ = ["softmax_ce", "accuracy"]


def _wmean(x: torch.Tensor, weight=None) -> torch.Tensor:
    """Weighted mean over rows; the weight sum is clamped at 1."""
    if weight is None:
        weight = torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
    return (x * weight).sum() / weight.sum().clamp(min=1.0)


def softmax_ce(logits: torch.Tensor, labels: torch.Tensor,
               weight=None) -> torch.Tensor:
    """Mean cross-entropy with integer labels (B,), stable log-softmax."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
    return _wmean(nll, weight)


def accuracy(logits: torch.Tensor, labels: torch.Tensor,
             weight=None) -> torch.Tensor:
    return _wmean((logits.argmax(-1) == labels.long()).to(torch.float32),
                  weight)
