"""Plain PyTorch reference of the x-vector TDNN, in float32.

A frozen, independent statement of the model the benchmark holds the port
to (Snyder et al. 2018; the E-TDNN of Snyder et al. 2019), written from the
published equations and the recipe's layer order:

    frame layer:  conv1d(SAME, dilation) + bias -> ReLU -> batch norm
    pooling:      mean || sqrt(var + 1e-5) over time
    embedding:    affine -> ReLU -> batch norm (layer 0's affine output is
                  the x-vector)
    head:         affine -> softmax cross-entropy, mean over rows
    batch norm:   eps 1e-3; train mode normalises with the batch's (biased)
                  moments, eval mode with the population statistics

Parameters are a tree ``{"frame": [{"w" (k, Cin, Cout), "b", "bn":
{"gamma", "beta"}}...], "embed": [...], "output": {"w" (D, C), "b"}}`` with
population statistics ``{"frame": [{"mean", "var"}...], "embed": [...]}``.
Adam is Kingma and Ba's Algorithm 1 with eps outside the root.

It imports nothing of the program.  ``lowp`` (see :mod:`.lowp`) rounds
every matrix product's operands, and the gradients that flow into them, to a
lower precision: the benchmark's control.  :func:`float32_exact` turns
TF32 off for its duration.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

BN_EPS = 1e-3
POOL_EPS = 1e-5


@contextlib.contextmanager
def float32_exact():
    """TF32 off for matmuls and cuDNN convolutions while inside."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _ident(x):
    return x


def conv_same(x, w, dilation: int, lowp=None):
    """(B, T, Cin) conv (k, Cin, Cout), SAME padding -> (B, T, Cout)."""
    q = lowp.operand if lowp else _ident
    k = w.shape[0]
    left = (k - 1) // 2 * dilation
    right = (k - 1) * dilation - left
    xt = F.pad(q(x).transpose(1, 2), (left, right))
    y = F.conv1d(xt, q(w).permute(2, 1, 0), dilation=dilation)
    y = y.transpose(1, 2)
    return lowp.grad(y) if lowp else y


def affine(x, w, b, lowp=None):
    q = lowp.operand if lowp else _ident
    y = q(x) @ q(w)
    return (lowp.grad(y) if lowp else y) + b


def _bn_train(h, bn, dims):
    mean = h.mean(dims, keepdim=True)
    var = (h - mean).square().mean(dims, keepdim=True)
    return (h - mean) * torch.rsqrt(var + BN_EPS) * bn["gamma"] + bn["beta"]


def _bn_eval(h, bn, stats):
    return ((h - stats["mean"]) * torch.rsqrt(stats["var"] + BN_EPS)
            * bn["gamma"] + bn["beta"])


def stats_pool(h):
    """(B, T, C) -> (B, 2C): mean || sqrt(biased variance + 1e-5)."""
    mean = h.mean(1)
    var = (h - mean[:, None]).square().mean(1)
    return torch.cat([mean, torch.sqrt(var + POOL_EPS)], dim=-1)


def train_loss(cfg, params, x, labels, lowp=None, share_rows=None):
    """Mean softmax cross-entropy of one minibatch in train mode; with
    ``share_rows``, the first that many rows' share of it (their summed
    loss over all the rows' count)."""
    h = x.to(torch.float32)
    for layer, d in zip(params["frame"], cfg["dilations"]):
        h = torch.relu(conv_same(h, layer["w"], d, lowp) + layer["b"])
        h = _bn_train(h, layer["bn"], (0, 1))
    h = stats_pool(h)
    for layer in params["embed"]:
        h = torch.relu(affine(h, layer["w"], layer["b"], lowp))
        h = _bn_train(h, layer["bn"], (0,))
    out = params["output"]
    logits = affine(h, out["w"], out["b"], lowp)
    nll = F.cross_entropy(logits, labels.long(), reduction="none")
    if share_rows is None:
        return nll.mean()
    return nll[:share_rows].sum() / nll.shape[0]


def frame_stack_eval(cfg, params, stats, feats, lowp=None):
    """(B, T, F) features -> (B, T, channels[-1]) in eval mode."""
    h = feats.to(torch.float32)
    for layer, st, d in zip(params["frame"], stats["frame"],
                            cfg["dilations"]):
        h = torch.relu(conv_same(h, layer["w"], d, lowp) + layer["b"])
        h = _bn_eval(h, layer["bn"], st)
    return h


def embed_eval(params, pooled, lowp=None):
    """Embedding layer 0's affine output: the x-vector."""
    e0 = params["embed"][0]
    return affine(pooled, e0["w"], e0["b"], lowp)


def leaves(tree) -> List[torch.Tensor]:
    """Leaves of a nest of dicts and lists, dict keys in sorted order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


class Adam:
    """Adam over a list of leaves, updated in place."""

    def __init__(self, params: List[torch.Tensor], lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params, self.lr = params, lr
        self.b1, self.b2, self.eps = b1, b2, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]):
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))


def train_steps(cfg, params, minibatches, lr: float, lowp=None,
                share_rows=None) -> Dict[str, object]:
    """Adam steps over ``minibatches`` [(x, labels)] from ``params`` (a
    tree, updated in place).  Returns each step's loss (before its update)
    and the first step's gradient, leaf by leaf in :func:`leaves` order.
    ``share_rows``: see :func:`train_loss`."""
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    opt = Adam(flat, lr)
    losses: List[float] = []
    first: Optional[List[torch.Tensor]] = None
    for x, y in minibatches:
        loss = train_loss(cfg, params, x, y, lowp, share_rows)
        grads = torch.autograd.grad(loss, flat)
        if first is None:
            first = [g.detach().clone() for g in grads]
        opt.step(grads)
        losses.append(float(loss.detach()))
    for p in flat:
        p.requires_grad_(False)
    return {"losses": losses, "first_grad": first}


def norm_gap(program: List[float], reference: List[float],
             keep: Optional[List[bool]] = None) -> float:
    """Worst leaf's |program norm - reference norm|, over the larger of the
    reference leaf's norm and the median reference leaf's."""
    ref = [r for i, r in enumerate(reference) if keep is None or keep[i]]
    med = sorted(ref)[len(ref) // 2] if ref else 0.0
    worst = 0.0
    for i, (p, r) in enumerate(zip(program, reference)):
        if keep is not None and not keep[i]:
            continue
        worst = max(worst, abs(p - r) / max(r, med, 1e-30))
    return worst


def leaf_gaps(program: List[float], reference: List[float]) -> List[float]:
    """Each leaf's |program norm - reference norm| over the larger of its
    reference norm and the median reference leaf's."""
    med = sorted(reference)[len(reference) // 2]
    return [abs(p - r) / max(r, med, 1e-30)
            for p, r in zip(program, reference)]


def moved_leaves(first_grad_norms: List[float], share: float = 1e-3
                 ) -> List[bool]:
    """Leaves the reference's first gradient moves: a norm at least
    ``share`` of the median leaf's (below it, Adam moves a leaf by
    round-off alone)."""
    med = sorted(first_grad_norms)[len(first_grad_norms) // 2]
    return [n >= share * med for n in first_grad_norms]


def rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b||."""
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def finite(x: float) -> float:
    return x if math.isfinite(x) else float("inf")
