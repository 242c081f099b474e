"""Training step, block step and one training iteration.

Counterpart of ``xvector_tpu/train/trainer.py`` on one device:

* :func:`make_train_step`: one minibatch: forward in train mode, softmax CE
  (+ L2), backward, the optimizer update and the BN-state EMA;
* :func:`make_block_train_step`: a block of stacked minibatches run as a
  Python loop of updates; every step normalises with its batch moments
  and emits them, and :func:`~..models.tdnn.fold_bn_state` folds them into
  the population statistics after the block.  ``dense=True`` is the
  mask-free twin for blocks the host certifies full;
* :class:`Trainer.train_one_iteration`: one pass over one archive's
  minibatches: bucketing by padded shape, ``block_size`` stacking, dense
  certification on the host, ragged leftovers through the single step,
  float16 upload with the cast on the device, and a timer summary.

Parameters are a tree of leaf tensors that the optimizer updates in place;
a step returns the new BN state and its metrics as device tensors, so a
block queues its work without waiting for the card.  ``fused_conv_bwd``
defaults to True: the wide conv layers run the hand-written kernels of
``ops/conv_bwd`` (one GPU needs no partitioning rule, which is why the
JAX package left its Pallas kernels opt-in).

Not ported yet: ``Trainer.train`` with checkpoints, retries, background
diagnostics and ``metrics.jsonl``; the AM-softmax and sharded heads; the
shard_map step; final model combination.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from dataclasses import dataclass, replace
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..models import tdnn
from ..models.convert import tree_leaves, tree_map
from ..models.heads import accuracy, softmax_ce
from ..utils.profiling import StepTimer
from . import schedules
from .optim import make_optimizer, set_learning_rate

__all__ = ["TrainConfig", "Trainer", "make_train_step",
           "make_block_train_step", "make_eval_step"]


@dataclass(frozen=True)
class TrainConfig:
    model: str = "no_dropout"             # preset name (MODEL_ZOO)
    num_targets: int = 0
    initial_effective_lrate: float = 1e-3  # run_xvector.sh:99
    final_effective_lrate: float = 1e-4    # run_xvector.sh:100
    num_epochs: int = 2                    # run_xvector.sh:103
    dropout_schedule: str = "0,0@0.10,0.1@0.50,0"   # run_xvector.sh:83
    proportional_shrink: float = 0.0       # 10 in recipe but dead in TF
    apply_shrink: bool = False             # off for strict parity
    random_seed: int = 2468                # run_xvector.sh:85
    head: str = "softmax"                  # softmax (am_softmax not ported)
    am_scale: float = 30.0
    am_margin: float = 0.2
    preserve_model_interval: int = 10      # run_xvector.sh:106
    compute_dtype: str = "bfloat16"
    max_param_change: float = 0.0          # 0 = off (dead knob in reference)
    block_size: int = 16                   # minibatches per block
    optimizer: str = "adam"                # adam | tf_adam | sgd (optim.py)
    momentum: float = 0.5                  # sgd only (run_xvector.sh:96)
    adam_moments_dtype: str = "float32"    # bfloat16 is not ported
    max_iteration_retries: int = 0
    retry_backoff_s: float = 30.0
    fused_conv_bwd: bool = True            # ops/conv_bwd kernels (K2-K4)
    spmd_step: str = "gspmd"               # shard_map is not ported
    final_combine: bool = False            # not ported
    max_models_combine: int = 20           # ze_utils.py:76 default
    combine_opt_steps: int = 80
    dense_fastpath: bool = True            # mask-free twin for full blocks


def _device_mask(batch_shape, t_len: int, n_rows: int, device):
    """(B, T) frame mask and (B,) row weight built on the device from two
    host integers."""
    b, t = batch_shape[:2]
    mask = (torch.arange(t, device=device) < t_len).to(torch.float32)
    weight = (torch.arange(b, device=device) < n_rows).to(torch.float32)
    return mask.expand(b, t), weight


def _compute_dtype(cfg: TrainConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def _loss_fn(model_cfg: tdnn.TdnnConfig, cfg: TrainConfig, params, state,
             batch, labels, t_len, n_rows, dropout_keep, generator,
             bn_stats_out: bool = False, dense: bool = False):
    if dense:
        # the caller certified every row valid and every frame real
        mask, weight = None, None
    else:
        mask, weight = _device_mask(batch.shape, t_len, n_rows, batch.device)
    out = tdnn.apply(model_cfg, params, state, batch, mask=mask,
                     row_weight=weight, train=True,
                     dropout_keep=dropout_keep, generator=generator,
                     compute_dtype=_compute_dtype(cfg),
                     bn_stats_out=bn_stats_out,
                     fused_conv_bwd=cfg.fused_conv_bwd)
    logits = out["logits"]
    ce = softmax_ce(logits, labels, weight)
    acc = accuracy(logits, labels, weight)
    return ce + out["l2_loss"], (out["state"], ce, acc)


def _grad_and_update(model_cfg, cfg, optimizer, params, state, batch,
                     labels, t_len, n_rows, lr, dropout_keep, shrink,
                     generator, bn_stats_out: bool = False,
                     dense: bool = False):
    """Loss, gradients and one in-place optimizer update; returns (new BN
    state or batch moments, loss, accuracy) as detached device tensors."""
    loss, (state, _, acc) = _loss_fn(
        model_cfg, cfg, params, state, batch, labels, t_len, n_rows,
        dropout_keep, generator, bn_stats_out, dense)
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    if cfg.max_param_change > 0.0:
        gnorm = torch.sqrt(sum(g.square().sum() for g in grads))
        scale = torch.clamp(cfg.max_param_change / (gnorm * lr + 1e-20),
                            max=1.0)
        grads = [g * scale for g in grads]
    for p, g in zip(leaves, grads):
        p.grad = g
    set_learning_rate(optimizer, lr)
    optimizer.step()
    for p in leaves:
        p.grad = None
    if cfg.apply_shrink:
        with torch.no_grad():
            for p in leaves:
                p.mul_(shrink)
    return tree_map(torch.Tensor.detach, state), loss.detach(), acc.detach()


def make_train_step(model_cfg: tdnn.TdnnConfig, cfg: TrainConfig):
    """Single-minibatch step: ``step(params, optimizer, state, batch,
    labels, t_len, n_rows, lr, dropout_keep, shrink, generator) → (state,
    {"loss", "accuracy"})``, updating ``params`` in place."""

    def step(params, optimizer, state, batch, labels, t_len, n_rows, lr,
             dropout_keep, shrink, generator):
        state, loss, acc = _grad_and_update(
            model_cfg, cfg, optimizer, params, state, batch, labels, t_len,
            n_rows, lr, dropout_keep, shrink, generator)
        return state, {"loss": loss, "accuracy": acc}

    return step


def make_block_train_step(model_cfg: tdnn.TdnnConfig, cfg: TrainConfig,
                          dense: bool = False):
    """Step over a block of stacked minibatches: ``block(params, optimizer,
    state, xs (N, B, T, F), ys (N, B), t_lens, n_rows, lr, dropout_keep,
    shrink, generator) → (state, {"loss", "accuracy"})`` with N sequential
    in-place updates; ``t_lens`` and ``n_rows`` are N host integers each.
    Each step emits its raw batch moments, folded into the EMA in closed
    form after the block.  ``dense=True`` is the mask-free twin (t_lens
    and n_rows are then ignored)."""

    def block(params, optimizer, state, xs, ys, t_lens, n_rows, lr,
              dropout_keep, shrink, generator):
        moments, losses, accs = [], [], []
        for i in range(xs.shape[0]):
            m, loss, acc = _grad_and_update(
                model_cfg, cfg, optimizer, params, state, xs[i], ys[i],
                t_lens[i], n_rows[i], lr, dropout_keep, shrink, generator,
                bn_stats_out=True, dense=dense)
            moments.append(m)
            losses.append(loss)
            accs.append(acc)
        stacked = {part: [{key: torch.stack([m[part][l][key]
                                             for m in moments])
                           for key in layer}
                          for l, layer in enumerate(state[part])]
                   for part in state}
        with torch.no_grad():
            new_state = tdnn.fold_bn_state(state, stacked,
                                           model_cfg.bn_decay)
        return new_state, {"loss": torch.stack(losses).mean(),
                           "accuracy": torch.stack(accs).mean()}

    return block


def make_eval_step(model_cfg: tdnn.TdnnConfig, cfg: TrainConfig):
    """``step(params, state, batch, labels, t_len, n_rows) → (loss,
    accuracy)`` in eval mode."""

    @torch.no_grad()
    def step(params, state, batch, labels, t_len, n_rows):
        mask, weight = _device_mask(batch.shape, t_len, n_rows, batch.device)
        out = tdnn.apply(model_cfg, params, state, batch, mask=mask,
                         train=False, compute_dtype=_compute_dtype(cfg))
        return (softmax_ce(out["logits"], labels, weight),
                accuracy(out["logits"], labels, weight))

    return step


class Trainer:
    """Iteration-structured trainer over materialised archives, on one
    device (``"cuda"`` unless the caller asks for ``"cpu"``)."""

    def __init__(self, cfg: TrainConfig, work_dir: str, feat_dim: int = 23,
                 device="cuda"):
        if cfg.num_targets <= 0:
            raise ValueError("num_targets must be set")
        if cfg.head != "softmax":
            raise NotImplementedError(f"head={cfg.head!r} is not ported yet")
        if cfg.spmd_step == "shard_map":
            raise NotImplementedError("spmd_step='shard_map' is not ported")
        if cfg.spmd_step != "gspmd":
            raise ValueError(f"unknown spmd_step {cfg.spmd_step!r}")
        if cfg.final_combine:
            raise NotImplementedError("final_combine is not ported yet")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model_cfg = tdnn.MODEL_ZOO[cfg.model]
        if self.model_cfg.feat_dim != feat_dim:
            self.model_cfg = replace(self.model_cfg, feat_dim=feat_dim)
        self.work_dir = work_dir
        os.makedirs(work_dir, exist_ok=True)
        self._step_fn = make_train_step(self.model_cfg, cfg)
        self._block_fn = make_block_train_step(self.model_cfg, cfg)
        self._block_dense_fn = (make_block_train_step(self.model_cfg, cfg,
                                                      dense=True)
                                if cfg.dense_fastpath else None)
        self._eval_fn = make_eval_step(self.model_cfg, cfg)
        self._dropout_points = schedules.parse_dropout_schedule(
            cfg.dropout_schedule)
        params, state = tdnn.init_params(
            torch.Generator().manual_seed(cfg.random_seed), self.model_cfg,
            cfg.num_targets, device=self.device)
        self.set_params(params, state)

    def set_params(self, params, state):
        """Install ``(params, state)`` (trees of tensors on the trainer's
        device) and start the optimizer afresh, its moments at zero."""
        for p in tree_leaves(params):
            p.requires_grad_(True)
        self.params, self.state = params, state
        self.optimizer = make_optimizer(
            self.cfg.optimizer, tree_leaves(params),
            self.cfg.initial_effective_lrate, momentum=self.cfg.momentum,
            moments_dtype=self.cfg.adam_moments_dtype)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(a)).to(self.device)

    def _pinned(self, a: np.ndarray) -> torch.Tensor:
        """Host tensor over ``a``, in page-locked memory when the trainer
        runs on the card, so that its upload does not block the host."""
        t = torch.from_numpy(a)
        return t.pin_memory() if self.device.type == "cuda" else t

    def train_one_iteration(self, it: int, batches: Iterable, lr: float,
                            dropout: float, shrink: float,
                            attempt: int = 0) -> Dict[str, float]:
        """One pass over one archive's minibatches.

        ``batches`` yields (feats float16 (B, Tpad, F), labels (B,),
        true_len).  Minibatches of equal padded shape are stacked
        ``block_size`` at a time and run as one block (the dense twin when
        every frame and row of the block is real); the leftovers of each
        shape take the single step.  A worker thread stacks the next block
        into pinned memory while the current one runs; its float16 bytes
        go to the card and are cast there.  The dropout draws come from a
        generator seeded with ``random_seed + 1000·it`` (and ``attempt``).
        Returns mean loss and accuracy, the count of minibatches, of dense
        and masked blocks and of single steps, and the timer summary."""
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(
            cfg.random_seed + 1000 * it + (attempt << 32))
        keep = 1.0 - dropout
        pending: List[Tuple[Dict[str, torch.Tensor], int]] = []
        counts = {"dense_blocks": 0, "masked_blocks": 0, "single_steps": 0}
        buckets: Dict[Tuple[int, ...], List] = {}
        timer = StepTimer()
        uploader = cf.ThreadPoolExecutor(max_workers=1)
        inflight: List[cf.Future] = []

        def stack(items):
            xs = np.stack([i[0] for i in items])
            ys = np.stack([i[1] for i in items])
            tl = [int(i[2]) for i in items]
            nr = [int(i[3]) for i in items]
            dense = (self._block_dense_fn is not None
                     and all(t == xs.shape[2] for t in tl)
                     and all(n == xs.shape[1] for n in nr))
            return self._pinned(xs), self._pinned(ys), tl, nr, dense

        def dispatch(fut):
            with timer("upload_wait"):
                xs, ys, tl, nr, dense = fut.result()
            with timer("dispatch"):
                xs = xs.to(self.device, non_blocking=True)
                ys = ys.to(self.device, non_blocking=True)
                fn = self._block_dense_fn if dense else self._block_fn
                self.state, m = fn(self.params, self.optimizer, self.state,
                                   xs, ys, tl, nr, lr, keep, shrink, gen)
            counts["dense_blocks" if dense else "masked_blocks"] += 1
            pending.append((m, len(tl)))

        try:
            for feats, labels, true_len in batches:
                key = feats.shape
                buckets.setdefault(key, []).append(
                    (feats, labels, true_len, feats.shape[0]))
                if len(buckets[key]) >= cfg.block_size:
                    inflight.append(uploader.submit(stack, buckets.pop(key)))
                    while len(inflight) > 2:
                        dispatch(inflight.pop(0))
            while inflight:
                dispatch(inflight.pop(0))
        finally:
            uploader.shutdown(wait=False, cancel_futures=True)
        for key in sorted(buckets):            # ragged leftovers
            for feats, labels, true_len, n_rows in buckets[key]:
                with timer("dispatch"):
                    self.state, m = self._step_fn(
                        self.params, self.optimizer, self.state,
                        self._upload(feats), self._upload(labels),
                        int(true_len), n_rows, lr, keep, shrink, gen)
                counts["single_steps"] += 1
                pending.append((m, 1))

        with timer("device_drain"):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        tot_loss = tot_acc = n = 0.0
        for m, k in pending:        # read after the device queue drains
            tot_loss += float(m["loss"]) * k
            tot_acc += float(m["accuracy"]) * k
            n += k
        return {"loss": tot_loss / max(n, 1),
                "accuracy": tot_acc / max(n, 1),
                "minibatches": n, **counts, **timer.summary()}

    def evaluate(self, batches: Iterable, params=None,
                 state=None) -> Dict[str, float]:
        """Loss and accuracy over ``batches`` in eval mode, weighted by
        rows; ``params``/``state`` override the live ones."""
        params = self.params if params is None else params
        state = self.state if state is None else state
        tot_loss = tot_acc = tot_w = 0.0
        for feats, labels, true_len in batches:
            n_rows = feats.shape[0]
            loss, acc = self._eval_fn(
                params, state, self._upload(feats), self._upload(labels),
                int(true_len), n_rows)
            tot_loss += float(loss) * n_rows
            tot_acc += float(acc) * n_rows
            tot_w += n_rows
        return {"loss": tot_loss / max(tot_w, 1),
                "accuracy": tot_acc / max(tot_w, 1)}
