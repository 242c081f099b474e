"""Classifier heads and losses.

Counterpart of ``xvector_tpu/models/heads.py``: :func:`softmax_ce`, the
reference's training objective (``models.py:511-517``,
``softmax_cross_entropy_with_logits`` → ``reduce_mean``), and
:func:`accuracy`, both weighted by a (B,) row weight that leaves pad rows
out; :func:`am_softmax`, the additive-margin (CosFace-style) head of the
"training tricks" configuration; :func:`sharded_softmax_ce`, the
cross-entropy over a classifier whose columns are split over the ranks of
a mesh's ``model`` axis.

``group`` (the data group of a mesh, ``parallel/mesh.py``) is the
counterpart of the JAX package's ``axis_name``: each rank holds a slice of
the batch rows, the weighted mean's numerator and denominator are summed
over the group, and every rank holds the mean of the whole batch.  The
sum's backward is the identity: each rank's rows get their own share of
the gradient, and the trainer sums the ranks' parameter gradients.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel import mesh as meshlib

__all__ = ["softmax_ce", "accuracy", "am_softmax", "sharded_softmax_ce",
           "local_sharded_softmax_ce"]


def _wmean(x: torch.Tensor, weight=None, group=None) -> torch.Tensor:
    """Weighted mean over rows; the weight sum is clamped at 1.  With
    ``group`` the numerator and denominator are summed over its ranks."""
    if weight is None:
        weight = torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
    num, den = (x * weight).sum(), weight.sum()
    if group is not None:
        num, den = meshlib.reduce_from_group(torch.stack([num, den]), group)
    return num / den.clamp(min=1.0)


def softmax_ce(logits: torch.Tensor, labels: torch.Tensor,
               weight=None, group=None) -> torch.Tensor:
    """Mean cross-entropy with integer labels (B,), stable log-softmax."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
    return _wmean(nll, weight, group)


def accuracy(logits: torch.Tensor, labels: torch.Tensor,
             weight=None, group=None) -> torch.Tensor:
    return _wmean((logits.argmax(-1) == labels.long()).to(torch.float32),
                  weight, group)


def local_sharded_softmax_ce(hidden: torch.Tensor, weight: torch.Tensor,
                             bias: torch.Tensor, labels: torch.Tensor,
                             mesh: meshlib.Mesh, row_weight=None,
                             axis: str = "model",
                             data_group=None) -> tuple:
    """Cross-entropy and accuracy from this rank's block of a classifier
    whose C columns are split over ``axis``: ``weight`` (D, C/M) and
    ``bias`` (C/M,) are the columns ``[i·C/M, (i+1)·C/M)`` of the rank at
    index ``i`` on the axis; labels are global class ids.

    No rank materialises the (B, C) logits.  Per row, three reductions
    cross the axis: the maximum logit (no gradient), the sum of
    exponentials and the target logit (only its owner contributes), both
    summed with an identity backward, since every rank holds the whole
    loss; ``hidden`` enters through an identity whose backward sums
    dL/dhidden over the axis, so each rank's trunk gets every block's
    share.  The prediction is the index the holder of the maximum
    reports.  ``data_group`` sums the row mean over a data axis too.
    Without ``mesh`` the block is the whole head."""
    group = None if mesh is None else mesh.group(axis)
    shard = 0 if mesh is None else mesh.index(axis)
    c_local = weight.shape[1]
    h = meshlib.copy_to_group(hidden, group)
    logits = h.to(torch.float32) @ weight.to(torch.float32) + bias
    m_local = logits.detach().max(dim=-1).values
    m = meshlib.all_reduce_max(m_local, group)          # stability only
    y = labels.long()
    local_label = y - shard * c_local
    owned = (local_label >= 0) & (local_label < c_local)
    idx = local_label.clamp(0, c_local - 1)
    tgt = logits.gather(-1, idx[:, None])[:, 0]
    sums = torch.stack([torch.exp(logits - m[:, None]).sum(-1),
                        torch.where(owned, tgt, torch.zeros_like(tgt))])
    sumexp, tgt = meshlib.reduce_from_group(sums, group)
    nll = m + torch.log(sumexp) - tgt
    # the global argmax: the rank holding the maximum reports its index
    holder = torch.where(m_local >= m, logits.detach().argmax(-1)
                         + shard * c_local, torch.full_like(y, -1))
    pred = meshlib.all_reduce_max(holder, group)
    correct = (pred == y).to(torch.float32)
    rw = (torch.ones(hidden.shape[0], dtype=torch.float32,
                     device=hidden.device)
          if row_weight is None else row_weight)
    return _wmean(nll, rw, data_group), _wmean(correct, rw, data_group)


def sharded_softmax_ce(hidden: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor, labels: torch.Tensor,
                       mesh: meshlib.Mesh, row_weight=None,
                       axis: str = "model") -> tuple:
    """The JAX package's signature: the whole (D, C) ``weight`` and (C,)
    ``bias``, of which this rank uses its block of columns
    (:func:`local_sharded_softmax_ce`; gradients reach only those columns
    here).  Returns (mean CE, accuracy), the values of the dense
    :func:`softmax_ce` and :func:`accuracy`.  C must be divisible by the
    axis size."""
    n_shards = mesh.shape[axis]
    c_total = weight.shape[1]
    if c_total % n_shards:
        raise ValueError(f"num classes {c_total} not divisible by "
                         f"{axis}={n_shards}")
    c_local = c_total // n_shards
    lo = mesh.index(axis) * c_local
    return local_sharded_softmax_ce(hidden, weight[:, lo:lo + c_local],
                                    bias[lo:lo + c_local], labels, mesh,
                                    row_weight, axis)


def am_softmax(hidden: torch.Tensor, weight: torch.Tensor,
               labels: torch.Tensor, scale: float = 30.0,
               margin: float = 0.2, row_weight=None,
               group: Optional[object] = None):
    """Additive-margin softmax loss: logits = s·(cos θ − m·1{target}).

    hidden: (B, D) embeddings; weight: (D, C) classifier (bias-free).  The
    rows are normalised with a floor of 1e-12 on their norm, the columns
    with none.  Returns (mean loss, margin-free cosine logits s·cos θ for
    accuracy).  ``group``: see :func:`softmax_ce`."""
    h = hidden / hidden.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    w = weight / weight.norm(dim=0, keepdim=True)
    cos = h @ w                                           # (B, C)
    onehot = torch.nn.functional.one_hot(labels.long(), cos.shape[-1]).to(
        cos.dtype)
    logits = scale * (cos - margin * onehot)
    return softmax_ce(logits, labels, row_weight, group), scale * cos
