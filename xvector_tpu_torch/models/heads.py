"""Classifier heads and losses.

Counterpart of ``xvector_tpu/models/heads.py``: :func:`softmax_ce`, the
reference's training objective (``models.py:511-517``,
``softmax_cross_entropy_with_logits`` → ``reduce_mean``), and
:func:`accuracy`, both weighted by a (B,) row weight that leaves pad rows
out; :func:`am_softmax`, the additive-margin (CosFace-style) head of the
"training tricks" configuration.  ``sharded_softmax_ce`` is not ported
yet: it needs a mesh.
"""

from __future__ import annotations

import torch

__all__ = ["softmax_ce", "accuracy", "am_softmax"]


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


def am_softmax(hidden: torch.Tensor, weight: torch.Tensor,
               labels: torch.Tensor, scale: float = 30.0,
               margin: float = 0.2, row_weight=None):
    """Additive-margin softmax loss: logits = s·(cos θ − m·1{target}).

    hidden: (B, D) embeddings; weight: (D, C) classifier (bias-free).  The
    rows are normalised with a floor of 1e-12 on their norm, the columns
    with none.  Returns (mean loss, margin-free cosine logits s·cos θ for
    accuracy)."""
    h = hidden / hidden.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    w = weight / weight.norm(dim=0, keepdim=True)
    cos = h @ w                                           # (B, C)
    onehot = torch.nn.functional.one_hot(labels.long(), cos.shape[-1]).to(
        cos.dtype)
    logits = scale * (cos - margin * onehot)
    return softmax_ce(logits, labels, row_weight), scale * cos
