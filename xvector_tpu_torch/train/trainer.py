"""Training step, block step, the iteration and the outer training loop.

Counterpart of ``xvector_tpu/train/trainer.py``, on one device or on a
mesh of ranks (``parallel/mesh.py``):

* :func:`make_train_step`: one minibatch: forward in train mode, softmax
  CE or AM-softmax (+ L2), backward, the optimizer update and the BN-state
  EMA;
* :func:`make_block_train_step`: a block of stacked minibatches run as a
  Python loop of updates; every step normalises with its batch moments
  and emits them, and :func:`~..models.tdnn.fold_bn_state` folds them into
  the population statistics after the block.  ``dense=True`` is the
  mask-free twin for blocks the host certifies full;
* :meth:`Trainer.train_one_iteration`: one pass over one archive's
  minibatches: bucketing by padded shape, ``block_size`` stacking, dense
  certification on the host, ragged leftovers through the single step,
  float16 upload with the cast on the device, and a timer summary;
* :meth:`Trainer.train`: the reference's iteration semantics: one archive
  per iteration, the learning-rate, dropout and shrink schedules,
  per-iteration checkpoints (``model_0`` before any update) with ``done``
  sentinels, GC, resume-by-skip, retries that roll back to the last
  complete checkpoint, held-out diagnostics on a worker thread, a
  ``metrics.jsonl`` record per event, cooperative preemption, and the
  final model combination.

Parameters are a tree of leaf tensors that the optimizer updates in place;
a step returns the new BN state and its metrics as device tensors, so a
block queues its work without waiting for the card.  ``fused_conv_bwd``
defaults to True: the wide conv layers run the hand-written kernels of
``ops/conv_bwd`` (one GPU needs no partitioning rule, which is why the
JAX package left its Pallas kernels opt-in).

On a mesh of several ranks (``Trainer(..., mesh=...)``) every rank feeds
its own rows of each global minibatch (``parallel/launch.local_rows``,
which pads a minibatch the data axis does not divide with weight-0 rows
and names the true row count); the batch-norm moments and the loss's mean
are global (all-reduced over the data group), and after each backward the
gradients are summed over the data group in one flat all-reduce, so every
rank applies the same update to the same bits.  A stop request is agreed
over the ranks (the largest flag wins) at each iteration boundary and each
block boundary, so every rank stops at the same place.
``head="sharded_softmax"`` splits the head's columns over the model axis
(:func:`~..models.heads.local_sharded_softmax_ce`); ``"softmax"`` keeps it
whole on every rank.  Checkpoints are written by rank 0 in the
single-process layout; the held-out diagnostics run inline, read one
iteration later (:meth:`Trainer.evaluate_async`), because no collective
may run on a worker thread.  The JAX package's ``shard_map`` step exists
for ``pallas_call``'s lack of a partitioning rule and is not ported.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import os
import sys
import threading
import time
from dataclasses import dataclass, replace
from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from .. import resolve_device
from ..models import tdnn
from ..models.convert import tree_leaves, tree_map
from ..models.heads import (accuracy, am_softmax, local_sharded_softmax_ce,
                            softmax_ce)
from ..parallel import mesh as meshlib
from ..utils.profiling import StepTimer, device_forensics
from . import checkpoints, combine, schedules
from .preemption import PreemptedError
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
    head: str = "softmax"                  # softmax | am_softmax |
    # sharded_softmax (the head's columns split over the mesh's model axis)
    am_scale: float = 30.0
    am_margin: float = 0.2
    preserve_model_interval: int = 10      # run_xvector.sh:106
    compute_dtype: str = "bfloat16"
    max_param_change: float = 0.0          # 0 = off (dead knob in reference)
    block_size: int = 16                   # minibatches per block
    optimizer: str = "adam"                # adam | tf_adam | sgd (optim.py)
    momentum: float = 0.5                  # sgd only (run_xvector.sh:96)
    adam_moments_dtype: str = "float32"    # bfloat16 keeps Adam's first
    # moment in bf16 (optax mu_dtype); f32 for strict reference parity
    max_iteration_retries: int = 0         # a retry restores the last
    # complete checkpoint and reruns the iteration (train_dnn.py:364-397)
    retry_backoff_s: float = 30.0
    fused_conv_bwd: bool = True            # ops/conv_bwd kernels (K2-K4)
    spmd_step: str = "gspmd"               # shard_map is not ported
    final_combine: bool = False            # fit convex combination weights
    # over the last iterations' checkpoints (train/combine.py)
    max_models_combine: int = 20           # ze_utils.py:76 default
    combine_opt_steps: int = 80
    dense_fastpath: bool = True            # mask-free twin for full blocks


def _device_mask(batch_shape, t_len: int, n_rows: int, device,
                 first_row: int = 0):
    """(B, T) frame mask and (B,) row weight built on the device from host
    integers: the rows are rows ``first_row``.. of a global batch whose
    first ``n_rows`` rows are real."""
    b, t = batch_shape[:2]
    mask = (torch.arange(t, device=device) < t_len).to(torch.float32)
    weight = (torch.arange(first_row, first_row + b, device=device)
              < n_rows).to(torch.float32)
    return mask.expand(b, t), weight


def _first_row(mesh: Optional[meshlib.Mesh], local_rows: int) -> int:
    """Index in the global batch of this rank's first row."""
    return 0 if mesh is None else mesh.data_index * local_rows


def _compute_dtype(cfg: TrainConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def _loss_fn(model_cfg: tdnn.TdnnConfig, cfg: TrainConfig, params, state,
             batch, labels, t_len, n_rows, dropout_keep, generator,
             bn_stats_out: bool = False, dense: bool = False,
             mesh: Optional[meshlib.Mesh] = None):
    """Loss of this rank's rows (the global batch's on every rank under a
    mesh), with (new BN state or batch moments, CE, accuracy).
    ``n_rows`` counts the real rows of the global batch."""
    if dense:
        # the caller certified every row valid and every frame real
        mask, weight = None, None
    else:
        mask, weight = _device_mask(batch.shape, t_len, n_rows, batch.device,
                                    _first_row(mesh, batch.shape[0]))
    group = None if mesh is None else mesh.data_group
    sharded = cfg.head == "sharded_softmax"
    am = cfg.head == "am_softmax"
    out = tdnn.apply(model_cfg, params, state, batch, mask=mask,
                     row_weight=weight, train=True,
                     dropout_keep=dropout_keep, generator=generator,
                     compute_dtype=_compute_dtype(cfg),
                     bn_stats_out=bn_stats_out, skip_head=am or sharded,
                     fused_conv_bwd=cfg.fused_conv_bwd, group=group,
                     head_group=(mesh.model_group if sharded and mesh
                                 else None))
    if sharded:
        ce, acc = local_sharded_softmax_ce(
            out["hidden"], params["output"]["w"], params["output"]["b"],
            labels, mesh, row_weight=weight, data_group=group)
    else:
        if am:
            ce, logits = am_softmax(out["hidden"], params["output"]["w"],
                                    labels, cfg.am_scale, cfg.am_margin,
                                    row_weight=weight, group=group)
        else:
            logits = out["logits"]
            ce = softmax_ce(logits, labels, weight, group)
        acc = accuracy(logits, labels, weight, group)
    l2 = out["l2_loss"]
    if group is not None and mesh.data_index:
        # every data rank holds the whole L2 term; the gradient sum over
        # the data group must count it once
        l2 = l2.detach()
    return ce + l2, (out["state"], ce, acc)


def _grad_and_update(model_cfg, cfg, optimizer, params, state, batch,
                     labels, t_len, n_rows, lr, dropout_keep, shrink,
                     generator, bn_stats_out: bool = False,
                     dense: bool = False, mesh=None):
    """Loss, gradients (summed over the mesh's data group) and one in-place
    optimizer update; returns (new BN state or batch moments, loss,
    accuracy) as detached device tensors."""
    loss, (state, _, acc) = _loss_fn(
        model_cfg, cfg, params, state, batch, labels, t_len, n_rows,
        dropout_keep, generator, bn_stats_out, dense, mesh)
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    if mesh is not None:
        grads = meshlib.all_reduce_flat(grads, mesh.data_group)
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


def make_train_step(model_cfg: tdnn.TdnnConfig, cfg: TrainConfig,
                    mesh: Optional[meshlib.Mesh] = None):
    """Single-minibatch step: ``step(params, optimizer, state, batch,
    labels, t_len, n_rows, lr, dropout_keep, shrink, generator) → (state,
    {"loss", "accuracy"})``, updating ``params`` in place."""

    def step(params, optimizer, state, batch, labels, t_len, n_rows, lr,
             dropout_keep, shrink, generator):
        state, loss, acc = _grad_and_update(
            model_cfg, cfg, optimizer, params, state, batch, labels, t_len,
            n_rows, lr, dropout_keep, shrink, generator, mesh=mesh)
        return state, {"loss": loss, "accuracy": acc}

    return step


def make_block_train_step(model_cfg: tdnn.TdnnConfig, cfg: TrainConfig,
                          dense: bool = False,
                          mesh: Optional[meshlib.Mesh] = None):
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
                bn_stats_out=True, dense=dense, mesh=mesh)
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


def make_eval_step(model_cfg: tdnn.TdnnConfig, cfg: TrainConfig,
                   mesh: Optional[meshlib.Mesh] = None):
    """``step(params, state, batch, labels, t_len, n_rows) → (loss,
    accuracy)`` in eval mode, over the global batch under a mesh."""
    group = None if mesh is None else mesh.data_group
    sharded = cfg.head == "sharded_softmax"

    @torch.no_grad()
    def step(params, state, batch, labels, t_len, n_rows):
        mask, weight = _device_mask(batch.shape, t_len, n_rows, batch.device,
                                    _first_row(mesh, batch.shape[0]))
        out = tdnn.apply(model_cfg, params, state, batch, mask=mask,
                         train=False, compute_dtype=_compute_dtype(cfg),
                         skip_head=sharded)
        if sharded:
            return local_sharded_softmax_ce(
                out["hidden"], params["output"]["w"], params["output"]["b"],
                labels, mesh, row_weight=weight, data_group=group)
        return (softmax_ce(out["logits"], labels, weight, group),
                accuracy(out["logits"], labels, weight, group))

    return step


class Trainer:
    """Iteration-structured trainer over materialised archives, on one
    device (``"cuda"`` unless the caller asks for ``"cpu"``) or, with
    ``mesh``, as one rank of a mesh, on the mesh's device."""

    # process-local record kinds: one rank's view (it retried, its device
    # failed, it was preempted), written by that rank with its index
    _LOCAL_KINDS = ("retry", "forensics", "preempted")

    def __init__(self, cfg: TrainConfig, work_dir: str, feat_dim: int = 23,
                 device="cuda", mesh: Optional[meshlib.Mesh] = None):
        if cfg.num_targets <= 0:
            raise ValueError("num_targets must be set")
        if cfg.head not in ("softmax", "am_softmax", "sharded_softmax"):
            raise ValueError(f"unknown head {cfg.head!r}")
        if cfg.spmd_step == "shard_map":
            raise NotImplementedError("spmd_step='shard_map' is not ported")
        if cfg.spmd_step != "gspmd":
            raise ValueError(f"unknown spmd_step {cfg.spmd_step!r}")
        # no mesh: one process, whatever process group it may be in
        self.mesh = mesh if mesh is not None else meshlib.Mesh(
            1, 1, 0, resolve_device(device))
        if (cfg.head == "sharded_softmax"
                and cfg.num_targets % self.mesh.model):
            raise ValueError(f"num_targets {cfg.num_targets} not divisible "
                             f"by model={self.mesh.model}")
        self.device = resolve_device(self.mesh.device)
        self.cfg = cfg
        self.model_cfg = tdnn.MODEL_ZOO[cfg.model]
        if self.model_cfg.feat_dim != feat_dim:
            self.model_cfg = replace(self.model_cfg, feat_dim=feat_dim)
        self.work_dir = work_dir
        os.makedirs(work_dir, exist_ok=True)
        self._step_fn = make_train_step(self.model_cfg, cfg, self.mesh)
        self._block_fn = make_block_train_step(self.model_cfg, cfg,
                                               mesh=self.mesh)
        self._block_dense_fn = (make_block_train_step(self.model_cfg, cfg,
                                                      dense=True,
                                                      mesh=self.mesh)
                                if cfg.dense_fastpath else None)
        self._eval_fn = make_eval_step(self.model_cfg, cfg, self.mesh)
        self._metrics_path = os.path.join(work_dir, "metrics.jsonl")
        self._log_lock = threading.Lock()   # train + diagnostics threads
        self._dropout_points = schedules.parse_dropout_schedule(
            cfg.dropout_schedule)
        params, state = tdnn.init_params(
            torch.Generator().manual_seed(cfg.random_seed), self.model_cfg,
            cfg.num_targets, device=self.device)
        self._place_all(params, state)

    def _place_all(self, params, state):
        """Install whole ``(params, state)`` trees: every rank takes rank
        0's bits, and a sharded head keeps this rank's columns."""
        layout = (meshlib.param_shardings(self.mesh, params)
                  if self.cfg.head == "sharded_softmax"
                  else meshlib.replicated(self.mesh))
        self.set_params(meshlib.put_global(params, layout),
                        meshlib.put_global(state,
                                           meshlib.replicated(self.mesh)))

    def set_params(self, params, state):
        """Install ``(params, state)`` (trees of tensors on the trainer's
        device, in this rank's layout) and start the optimizer afresh, its
        moments at zero."""
        for p in tree_leaves(params):
            p.requires_grad_(True)
        self.params, self.state = params, state
        self.optimizer = make_optimizer(
            self.cfg.optimizer, tree_leaves(params),
            self.cfg.initial_effective_lrate, momentum=self.cfg.momentum,
            moments_dtype=self.cfg.adam_moments_dtype)

    def _global_rows(self, item: Tuple) -> int:
        """Real rows of the GLOBAL minibatch of which ``item`` (feats,
        labels, true_len[, global_rows]) holds this rank's rows: the ranks
        of one data index feed the same rows, and one rank the whole
        minibatch.  ``global_rows`` comes from a feeder that padded the
        minibatch to a multiple of the data axis
        (``parallel/launch.local_rows``, the JAX package's ``_pad_rows``);
        without it every row of every rank is real."""
        if len(item) > 3:
            return int(item[3])
        return item[0].shape[0] * self.mesh.data

    def _stop_agreed(self, stop_check) -> bool:
        """``stop_check()`` here, or on any rank of the mesh: the flag is
        all-reduced (its maximum) over every rank, which must all ask at
        the same point of the run.  A signal then stops every rank at the
        same place, and no rank leaves while its peers wait in a
        collective."""
        if stop_check is None:
            return False
        stop = bool(stop_check())
        if self.mesh.size == 1:
            return stop
        flag = torch.tensor([float(stop)], device=self.device)
        return bool(meshlib.all_reduce_max(flag, self.mesh.world_group)[0])

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(a)).to(self.device)

    def _pinned(self, a: np.ndarray) -> torch.Tensor:
        """Host tensor over ``a``, in page-locked memory when the trainer
        runs on the card, so that its upload does not block the host."""
        t = torch.from_numpy(a)
        return t.pin_memory() if self.device.type == "cuda" else t

    def train_one_iteration(self, it: int, batches: Iterable, lr: float,
                            dropout: float, shrink: float,
                            attempt: int = 0,
                            stop_check=None) -> Dict[str, float]:
        """One pass over one archive's minibatches.

        ``batches`` yields (feats float16 (B, Tpad, F), labels (B,),
        true_len).  Minibatches of equal padded shape are stacked
        ``block_size`` at a time and run as one block (the dense twin when
        every frame and row of the block is real); the leftovers of each
        shape take the single step.  A worker thread stacks the next block
        into pinned memory while the current one runs; its float16 bytes
        go to the card and are cast there.  The dropout draws come from a
        generator seeded with ``random_seed + 1000·it`` (a retry's ``attempt``
        and, on a mesh of several data ranks, the rank's data index hashed
        in).
        ``stop_check`` (e.g. a :class:`~.preemption.GracefulPreemption`) is
        polled before each minibatch, or on a mesh of several ranks before
        each block's worth of minibatches (every ``block_size``-th), agreed
        over the ranks (:meth:`_stop_agreed`); when it fires the iteration
        is abandoned with :class:`~.preemption.PreemptedError` — its
        partial updates live only in process memory, so a resume replays
        it from the checkpoint.  Returns mean loss and accuracy, the count
        of minibatches, of dense and masked blocks and of single steps, and
        the timer summary."""
        cfg = self.cfg
        seed = cfg.random_seed + 1000 * it
        if attempt or self.mesh.data > 1:
            # a retry draws other dropout masks, and each data rank draws
            # its own rows' (the ranks of one data index, the same); the
            # CPU generator keeps only a seed's low 32 bits, so they are
            # hashed in
            seed = int(np.random.SeedSequence(
                [seed, attempt] + ([self.mesh.data_index]
                                   if self.mesh.data > 1 else []))
                .generate_state(1)[0])
        gen = torch.Generator(device=self.device).manual_seed(seed)
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
                     and all(n == xs.shape[1] * self.mesh.data for n in nr))
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

        # one rank polls at every minibatch; several agree at each block
        # boundary, so that the poll adds no collective per minibatch
        several = self.mesh.size > 1
        try:
            for i, item in enumerate(batches):
                if ((not several or (i and i % cfg.block_size == 0))
                        and self._stop_agreed(stop_check)):
                    raise PreemptedError(f"iteration {it}")
                feats, labels, true_len = item[:3]
                key = feats.shape
                buckets.setdefault(key, []).append(
                    (feats, labels, true_len, self._global_rows(item)))
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
        return self.evaluate_async(batches, params, state)()

    def evaluate_async(self, batches: Iterable, params=None, state=None):
        """Run the eval steps over ``batches`` now and return a
        ``resolve() -> {"loss", "accuracy"}`` closure that reads their
        results later.

        The multi-rank diagnostics: every rank issues the eval's
        collectives inline at the iteration boundary, at the same point of
        its program (a worker thread's timing could order them differently
        on each rank), and the host reads the numbers one iteration later,
        so that the device work overlaps the next iteration's host work.
        The eval's kernels are queued on the stream before the next
        iteration's in-place updates, which therefore cannot change what
        they read."""
        params = self.params if params is None else params
        state = self.state if state is None else state
        parts = []
        for item in batches:
            feats, labels, true_len = item[:3]
            n_rows = self._global_rows(item)
            loss, acc = self._eval_fn(
                params, state, self._upload(feats), self._upload(labels),
                int(true_len), n_rows)
            parts.append((loss, acc, n_rows))

        def resolve() -> Dict[str, float]:
            tot_loss = tot_acc = tot_w = 0.0
            for loss, acc, w in parts:
                tot_loss += float(loss) * w
                tot_acc += float(acc) * w
                tot_w += w
            return {"loss": tot_loss / max(tot_w, 1),
                    "accuracy": tot_acc / max(tot_w, 1)}

        return resolve

    # -- metrics -----------------------------------------------------------
    def _log(self, record: Dict[str, Any]):
        """Append one record to ``metrics.jsonl`` with a ``time`` field;
        the training and diagnostics threads both write.  Ranks share the
        work dir: rank 0 writes the global records, and each rank its own
        ``_LOCAL_KINDS`` records, tagged with ``"process"``."""
        if self.mesh.size > 1:
            if (self.mesh.rank != 0
                    and record.get("kind") not in self._LOCAL_KINDS):
                return
            record["process"] = self.mesh.rank
        record["time"] = time.time()
        with self._log_lock, open(self._metrics_path, "a") as f:
            f.write(json.dumps(record, default=str) + "\n")

    # -- the outer loop ------------------------------------------------------
    def train(self, archive_batches: Callable[[int], Iterable],
              num_archives: int,
              valid_batches: Optional[Callable[[], Iterable]] = None,
              train_subset_batches: Optional[Callable[[], Iterable]] = None,
              start_iter: int = 0, preemption=None) -> int:
        """Full run.  ``archive_batches(i)`` yields the minibatches of
        archive ``i % num_archives``.  Returns the final iteration index
        (the number of COMPLETED iterations when preempted early).

        num_iters follows train_dnn.py:504 with num_jobs ≡ 1:
        ``num_epochs * num_archives``.  ``preemption`` (a
        :class:`~.preemption.GracefulPreemption` or any 0-arg callable)
        makes the run stop cleanly at the next safe point: the last
        complete checkpoint stays durable, no ``model_final`` is marked,
        and a rerun resumes bit-identically.  On a mesh of several ranks
        every rank passes one (or none), and a request on any rank stops
        them all at the same place (:meth:`_stop_agreed`).

        Held-out diagnostics run off the training path on one worker
        thread (the reference backgrounds them, train_dnn.py:429-460): the
        params and BN state are cloned on this thread before the next
        iteration's in-place updates are queued, and the worker evaluates
        the clones on the same CUDA stream.  A diagnostics failure
        surfaces at the next iteration boundary; while a training
        exception propagates, it is logged as ``diag_error`` instead of
        masking it.  On a mesh of several ranks there is no worker
        thread: the diagnostics run inline through
        :meth:`evaluate_async` and are logged at the next boundary."""
        cfg = self.cfg
        num_iters = cfg.num_epochs * num_archives
        has_diag = (valid_batches is not None
                    or train_subset_batches is not None)
        diag_ex = None
        deferred: List[Tuple[int, str, Callable]] = []
        if has_diag and self.mesh.size == 1:
            # the worker makes the trainer's card current before its first
            # CUDA call, which binds the device's primary context (the sm90
            # kernels' cuTensorMapEncodeTiled needs one)
            bind = {}
            if self.device.type == "cuda":
                index = self.device.index
                bind = dict(initializer=torch.cuda.set_device, initargs=(
                    torch.cuda.current_device() if index is None else index,))
            diag_ex = cf.ThreadPoolExecutor(max_workers=1, **bind)
        diag_futures: List[cf.Future] = []

        def run_diag(it: int, params, state):
            for kind, fn in (("valid", valid_batches),
                             ("train_subset", train_subset_batches)):
                if fn is not None:
                    v = self.evaluate(fn(), params=params, state=state)
                    self._log({"iteration": it, "kind": kind, **v})

        def check_diag(wait: bool = False):
            for f in list(diag_futures):
                if wait or f.done():
                    # remove BEFORE result(): if it raises, the finally
                    # block below must not log it a second time
                    diag_futures.remove(f)
                    f.result()

        def flush_deferred():
            for it_, kind, resolve in deferred:
                self._log({"iteration": it_, "kind": kind, **resolve()})
            deferred.clear()

        def submit_diag(it: int):
            if not has_diag:
                return
            if diag_ex is None:      # several ranks: inline, logged later
                flush_deferred()     # the previous boundary's diagnostics
                for kind, fn in (("valid", valid_batches),
                                 ("train_subset", train_subset_batches)):
                    if fn is not None:
                        deferred.append((it, kind,
                                         self.evaluate_async(fn())))
                return
            check_diag()
            p = tree_map(lambda t: t.detach().clone(), self.params)
            s = tree_map(torch.Tensor.clone, self.state)
            diag_futures.append(diag_ex.submit(run_diag, it, p, s))

        combine_set: List[int] = []
        if cfg.final_combine:
            combine_set = combine.combine_iterations(
                num_iters, num_archives, cfg.max_models_combine)

        checkpoints.pin_seed(self.work_dir, cfg.random_seed)
        start_iter = checkpoints.restore_latest(self, start_iter)
        if checkpoints.latest_complete(self.work_dir) is None:
            # model_0: the initial parameters, saved BEFORE any update
            # (train_dnn.py:494), so that a failure inside the first
            # attempted iteration can roll back
            checkpoints.save_iteration(self, 0)

        stop_check = preemption if callable(preemption) else None
        try:
            final_it = self._train_loop(start_iter, num_iters, num_archives,
                                        archive_batches, submit_diag,
                                        stop_check, combine_set)
        finally:
            if diag_ex is not None:
                diag_ex.shutdown(wait=True)
            if sys.exc_info()[0] is None:
                check_diag(wait=True)
                flush_deferred()
            else:
                for f in diag_futures:
                    exc = f.exception()
                    if exc is not None:
                        self._log({"kind": "diag_error", "error": repr(exc)})
        if final_it < num_iters:          # preempted
            return final_it
        if start_iter >= num_iters and checkpoints.is_complete(
                os.path.join(self.work_dir, "model_final")):
            # a finished run: resume-by-skip leaves its model_final as it is
            return num_iters
        if combine_set:
            self._final_combine(combine_set,
                                train_subset_batches or valid_batches)
        else:
            checkpoints.mark_final(self.work_dir, num_iters, self.mesh)
        return num_iters

    def _train_loop(self, start_iter: int, num_iters: int,
                    num_archives: int, archive_batches, submit_diag,
                    stop_check, combine_set) -> int:
        """The per-iteration scheduler loop; returns the number of
        completed iterations (== num_iters unless preempted)."""
        cfg = self.cfg
        for it in range(start_iter, num_iters):
            if self._stop_agreed(stop_check):
                self._log({"iteration": it, "kind": "preempted",
                           "where": "iteration_boundary"})
                return it
            lr = schedules.learning_rate(
                it, num_iters, cfg.initial_effective_lrate,
                cfg.final_effective_lrate,
                is_final_iter=(it + 1 >= num_iters))
            drop = schedules.dropout_proportion(self._dropout_points,
                                                (it + 1) / num_iters)
            shrink = (schedules.shrink_value(cfg.proportional_shrink, lr)
                      if cfg.apply_shrink and cfg.proportional_shrink > 0
                      else 1.0)
            t0 = time.monotonic()
            for attempt in range(cfg.max_iteration_retries + 1):
                try:
                    stats = self.train_one_iteration(
                        it, archive_batches(it % num_archives), lr, drop,
                        shrink, attempt=attempt, stop_check=stop_check)
                    break
                except PreemptedError:
                    self._log({"iteration": it, "kind": "preempted",
                               "where": "mid_iteration"})
                    return it
                except Exception:
                    # a device post-mortem beside the retry record (the
                    # reference dumps nvidia-smi/qstat on job failure,
                    # ze_utils.py:570-623)
                    if attempt >= cfg.max_iteration_retries:
                        self._log({"iteration": it, "kind": "forensics",
                                   **device_forensics()})
                        raise
                    self._log({"iteration": it, "kind": "retry",
                               "attempt": attempt,
                               "forensics": device_forensics()})
                    time.sleep(cfg.retry_backoff_s)
                    # roll back to the last complete checkpoint so that
                    # the rerun starts from a consistent state
                    checkpoints.restore_latest(self, 0)
            stats.update(iteration=it, lr=lr, dropout=drop,
                         seconds=time.monotonic() - t0, kind="train")
            self._log(stats)
            submit_diag(it)
            checkpoints.save_iteration(self, it + 1)
            checkpoints.collect_garbage(
                self.work_dir, it + 1, cfg.preserve_model_interval,
                keep=combine_set, mesh=self.mesh)
        return num_iters

    @staticmethod
    def _uniform_shape_batches(raw: Iterable[Tuple]) -> List[Tuple]:
        """Pad (feats, labels, true_len, n_rows) minibatches to ONE (B, T)
        shape; the masks built from true_len and n_rows make the padding
        exact."""
        batches = list(raw)
        if batches:
            b_max = max(f.shape[0] for f, *_ in batches)
            t_max = max(f.shape[1] for f, *_ in batches)
            batches = [
                (np.pad(f, ((0, b_max - f.shape[0]),
                            (0, t_max - f.shape[1]), (0, 0))),
                 np.pad(l, (0, b_max - l.shape[0])), t, r)
                for f, l, t, r in batches]
        return batches

    def _final_combine(self, combine_set: Sequence[int], batches_fn):
        """Fit combination weights over the candidate iterations'
        checkpoints on the diagnostics minibatches and install the result
        as ``model_combined`` → ``model_final``.  Each way the fit can be
        skipped is logged under its own reason, and ``model_final`` then
        points at the newest complete iteration.

        On a mesh of several ranks every rank loads the candidates whole;
        rank 0 alone fits the weights on its own diagnostics rows, with no
        collective, and broadcasts them with a flag that says its rows
        were empty, so that no peer waits in a collective rank 0 skips;
        every rank then applies the same weights to the same trees."""
        available = {it: path
                     for it, path in checkpoints.iteration_dirs(self.work_dir)
                     if checkpoints.is_complete(path)}
        cands = [it for it in combine_set if it in available]

        def skip(reason: str):
            self._log({"kind": "combine_skipped", "reason": reason})
            checkpoints.mark_final(self.work_dir,
                                   max(available) if available else 0,
                                   self.mesh)

        if not cands:
            return skip("no complete candidate checkpoints")
        if batches_fn is None:
            return skip("no diagnostics batches provided")
        t0 = time.monotonic()
        multi = self.mesh.size > 1
        # rank 0 holds the first rows of each global minibatch: its real
        # ones are the first min(rows, global_rows)
        batches = [] if multi and self.mesh.rank else \
            self._uniform_shape_batches(
                (b[0], b[1], b[2], min(b[0].shape[0], self._global_rows(b)))
                for b in batches_fn())
        if not multi and not batches:
            return skip("diagnostics batches yielded no data")
        loaded = [checkpoints.load_pytrees(self, available[it])
                  for it in cands]
        info: Dict[str, Any] = {}
        if batches:
            params, state, info = combine.optimize_combination(
                self.model_cfg, [p for p, _ in loaded],
                [s for _, s in loaded], batches,
                compute_dtype=_compute_dtype(self.cfg),
                steps=self.cfg.combine_opt_steps)
        if multi:
            # rank 0's answer for every rank: [no data, weights...]
            answer = torch.zeros(len(cands) + 1, dtype=torch.float32,
                                 device=self.device)
            if self.mesh.rank == 0:
                if batches:
                    answer[1:] = torch.tensor(info["weights"])
                else:
                    answer[0] = 1.0
            answer = meshlib.broadcast_tree(answer, self.mesh.world_group)
            if answer[0]:
                return skip("diagnostics batches yielded no data")
            weights = answer[1:]
            info = {**info, "weights": weights.cpu().tolist()}
            params = combine.combine_pytrees([p for p, _ in loaded], weights)
            state = combine.combine_pytrees([s for _, s in loaded], weights)
        if not np.all(np.isfinite(info["weights"])):
            return skip("non-finite combination weights")
        # the combined model keeps the last iteration's optimizer state, as
        # the JAX package's model_combined does
        opt_state = self.optimizer.state_dict()
        self._place_all(params, state)
        self.optimizer.load_state_dict(opt_state)
        checkpoints.save_named(self, "model_combined")
        checkpoints.mark_final(self.work_dir, "model_combined", self.mesh)
        self._log({"kind": "combine", "iterations": cands, **info,
                   "seconds": time.monotonic() - t0})
