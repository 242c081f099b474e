"""Final model combination.

Counterpart of ``xvector_tpu/train/combine.py``.  The reference computes
the set of end-of-training iterations whose models would enter a final
weighted combination (``ze_utils.py:76-108``), keeps those checkpoints out
of GC, and then raises if combination is requested
(``train_dnn.py:571-581``).  Here:

* :func:`combine_iterations` is the reference's candidate-set formula with
  integer semantics;
* :func:`optimize_combination` stacks the candidates' parameter trees
  along a leading model axis, parameterises a convex combination through a
  softmax over ``N`` logits, and fits the logits on held-out minibatches
  with Adam (lr 0.25; ``torch.optim.Adam`` adds ε after the bias
  correction, as ``optax.adam`` does, so the updates are the same).  The
  search starts at the logits ``[0, …, 0, 1]`` and falls back to the final
  model when the fit ends worse than it.  BN population statistics combine
  with the same weights.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..models import tdnn
from ..models.convert import tree_leaves, tree_map
from ..models.heads import softmax_ce

__all__ = ["combine_iterations", "combine_pytrees", "optimize_combination"]


def combine_iterations(num_iters: int, num_archives: int,
                       max_models_combine: int = 20,
                       num_jobs_final: int = 1) -> List[int]:
    """Iterations (1-based, ending at ``num_iters``) whose checkpoints form
    the combination candidate set — ``ze_utils.py:76-108`` semantics:
    combine over ~half an epoch (+1), capped at half of training, and
    sub-sampled down to ``max_models_combine`` models."""
    approx_iters_per_epoch_final = num_archives // max(num_jobs_final, 1)
    initial = min(approx_iters_per_epoch_final // 2 + 1, num_iters // 2)
    initial = max(initial, 1)
    if initial > max_models_combine:
        factor = initial // max_models_combine
        models = set(range(num_iters - initial + 1, num_iters + 1,
                           max(factor, 1)))
        models.add(num_iters)
    else:
        n = max(min(max_models_combine, num_iters // 2), 1)
        models = set(range(num_iters - n + 1, num_iters + 1))
    return sorted(m for m in models if m >= 1)


def _stack(trees: Sequence):
    """One tree whose leaves stack the trees' leaves along a new axis 0."""
    leaves = [tree_leaves(t) for t in trees]
    it = iter(torch.stack([l.detach() for l in ls]) for ls in zip(*leaves))
    return tree_map(lambda _: next(it), trees[0])


def _weighted(stacked, weights: torch.Tensor):
    return tree_map(lambda s: torch.tensordot(weights, s, dims=1), stacked)


def combine_pytrees(trees: Sequence, weights) -> object:
    """Convex combination of ``N`` identically-structured trees with
    ``weights`` (shape ``(N,)``): one stacked ``tensordot`` per leaf."""
    stacked = _stack(trees)
    dev = tree_leaves(stacked)[0].device
    return _weighted(stacked, torch.as_tensor(weights, dtype=torch.float32,
                                              device=dev))


def optimize_combination(model_cfg: tdnn.TdnnConfig,
                         params_list: Sequence,
                         state_list: Sequence,
                         batches: Sequence[Tuple[np.ndarray, np.ndarray,
                                                 int, int]],
                         compute_dtype=torch.float32,
                         steps: int = 80,
                         lr: float = 0.25) -> Tuple[object, object, Dict]:
    """Fit softmax combination weights over checkpoint models, on the
    device the models' tensors lie on.

    batches: materialised (feats (B, T, F), labels (B,), true_len, n_rows)
    eval minibatches.  Returns (combined_params, combined_state, info)
    where info carries the final weights and the before/after objective
    (the mean of the per-minibatch losses)."""
    n = len(params_list)
    if n != len(state_list) or n == 0:
        raise ValueError("need ≥1 model with matching state list")
    if not batches:
        raise ValueError("optimize_combination needs at least one minibatch")
    p_stacked, s_stacked = _stack(params_list), _stack(state_list)
    dev = tree_leaves(p_stacked)[0].device
    dev_batches = [(torch.from_numpy(np.array(f)).to(dev),
                    torch.from_numpy(np.array(l)).to(dev), int(t), int(r))
                   for f, l, t, r in batches]

    def model_loss(logits_w, feats, labels, t_len, n_rows):
        w = torch.softmax(logits_w, dim=0)
        b, t = feats.shape[:2]
        mask = (torch.arange(t, device=dev) < t_len).to(torch.float32)
        weight = (torch.arange(b, device=dev) < n_rows).to(torch.float32)
        out = tdnn.apply(model_cfg, _weighted(p_stacked, w),
                         _weighted(s_stacked, w), feats,
                         mask=mask.expand(b, t), train=False,
                         compute_dtype=compute_dtype)
        return softmax_ce(out["logits"], labels, weight)

    @torch.no_grad()
    def total_loss(lw):
        return float(np.mean([float(model_loss(lw, *fb))
                              for fb in dev_batches]))

    # start biased toward the newest model so the search begins near the
    # reference's default answer (the final iteration)
    logits_w = torch.zeros(n, device=dev)
    logits_w[-1] = 1.0
    logits_w.requires_grad_(True)
    opt = torch.optim.Adam([logits_w], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    final_only = torch.full((n,), -30.0, device=dev)   # ≈ one-hot final
    final_only[-1] = 30.0
    baseline = total_loss(final_only)

    i = 0
    while i < steps:
        for fb in dev_batches:
            if i >= steps:
                break
            opt.zero_grad(set_to_none=True)
            model_loss(logits_w, *fb).backward()
            opt.step()
            i += 1
    logits_w = logits_w.detach()
    combined_loss = total_loss(logits_w)
    # never worse than the final model on the combination data (Kaldi's
    # combine keeps the final model in its convex hull for the same reason)
    fell_back = combined_loss > baseline
    if fell_back:
        logits_w, combined_loss = final_only, baseline
    weights = torch.softmax(logits_w, dim=0)
    info = {
        "weights": weights.cpu().tolist(),
        "final_model_loss": baseline,
        "combined_loss": combined_loss,
        "fell_back": bool(fell_back),
        "num_models": n,
        "steps": i,
    }
    return _weighted(p_stacked, weights), _weighted(s_stacked, weights), info
