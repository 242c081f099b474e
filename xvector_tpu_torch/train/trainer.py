"""Training step, block step, the iteration and the outer training loop.

Counterpart of ``xvector_tpu/train/trainer.py`` on one device:

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

Not ported yet: the sharded-softmax head and the shard_map step (they
need a mesh of several devices).
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
from ..models.heads import accuracy, am_softmax, softmax_ce
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
    head: str = "softmax"                  # softmax | am_softmax
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
    am = cfg.head == "am_softmax"
    out = tdnn.apply(model_cfg, params, state, batch, mask=mask,
                     row_weight=weight, train=True,
                     dropout_keep=dropout_keep, generator=generator,
                     compute_dtype=_compute_dtype(cfg),
                     bn_stats_out=bn_stats_out, skip_head=am,
                     fused_conv_bwd=cfg.fused_conv_bwd)
    if am:
        ce, logits = am_softmax(out["hidden"], params["output"]["w"], labels,
                                cfg.am_scale, cfg.am_margin,
                                row_weight=weight)
    else:
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
        if cfg.head == "sharded_softmax":
            raise NotImplementedError("head='sharded_softmax' is not ported: "
                                      "it needs a mesh of several devices")
        if cfg.head not in ("softmax", "am_softmax"):
            raise ValueError(f"unknown head {cfg.head!r}")
        if cfg.spmd_step == "shard_map":
            raise NotImplementedError("spmd_step='shard_map' is not ported")
        if cfg.spmd_step != "gspmd":
            raise ValueError(f"unknown spmd_step {cfg.spmd_step!r}")
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
        self._metrics_path = os.path.join(work_dir, "metrics.jsonl")
        self._log_lock = threading.Lock()   # train + diagnostics threads
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
        hashed in).
        ``stop_check`` (e.g. a :class:`~.preemption.GracefulPreemption`) is
        polled before each minibatch; when it fires the iteration is
        abandoned with :class:`~.preemption.PreemptedError` — its partial
        updates live only in process memory, so a resume replays it from
        the checkpoint.  Returns mean loss and accuracy, the count of minibatches, of dense
        and masked blocks and of single steps, and the timer summary."""
        cfg = self.cfg
        seed = cfg.random_seed + 1000 * it
        if attempt:
            # a retry draws other dropout masks; the CPU generator keeps
            # only a seed's low 32 bits, so the attempt is hashed in
            seed = int(np.random.SeedSequence([seed, attempt])
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
                if stop_check is not None and stop_check():
                    raise PreemptedError(f"iteration {it}")
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

    # -- metrics -----------------------------------------------------------
    def _log(self, record: Dict[str, Any]):
        """Append one record to ``metrics.jsonl`` with a ``time`` field;
        the training and diagnostics threads both write."""
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
        and a rerun resumes bit-identically.

        Held-out diagnostics run off the training path on one worker
        thread (the reference backgrounds them, train_dnn.py:429-460): the
        params and BN state are cloned on this thread before the next
        iteration's in-place updates are queued, and the worker evaluates
        the clones on the same CUDA stream.  A diagnostics failure
        surfaces at the next iteration boundary; while a training
        exception propagates, it is logged as ``diag_error`` instead of
        masking it."""
        cfg = self.cfg
        num_iters = cfg.num_epochs * num_archives
        has_diag = (valid_batches is not None
                    or train_subset_batches is not None)
        diag_ex = None
        if has_diag:
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

        def submit_diag(it: int):
            if diag_ex is None:
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
            checkpoints.mark_final(self.work_dir, num_iters)
        return num_iters

    def _train_loop(self, start_iter: int, num_iters: int,
                    num_archives: int, archive_batches, submit_diag,
                    stop_check, combine_set) -> int:
        """The per-iteration scheduler loop; returns the number of
        completed iterations (== num_iters unless preempted)."""
        cfg = self.cfg
        for it in range(start_iter, num_iters):
            if stop_check is not None and stop_check():
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
                keep=combine_set)
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
        points at the newest complete iteration."""
        available = {it: path
                     for it, path in checkpoints.iteration_dirs(self.work_dir)
                     if checkpoints.is_complete(path)}
        cands = [it for it in combine_set if it in available]

        def skip(reason: str):
            self._log({"kind": "combine_skipped", "reason": reason})
            checkpoints.mark_final(self.work_dir,
                                   max(available) if available else 0)

        if not cands:
            return skip("no complete candidate checkpoints")
        if batches_fn is None:
            return skip("no diagnostics batches provided")
        batches = self._uniform_shape_batches(
            (f, l, t, f.shape[0]) for f, l, t in batches_fn())
        if not batches:
            return skip("diagnostics batches yielded no data")
        t0 = time.monotonic()
        loaded = [checkpoints.load_pytrees(self, available[it])
                  for it in cands]
        params, state, info = combine.optimize_combination(
            self.model_cfg, [p for p, _ in loaded], [s for _, s in loaded],
            batches, compute_dtype=_compute_dtype(self.cfg),
            steps=self.cfg.combine_opt_steps)
        if not np.all(np.isfinite(info["weights"])):
            return skip("non-finite combination weights")
        # the combined model keeps the last iteration's optimizer state, as
        # the JAX package's model_combined does
        opt_state = self.optimizer.state_dict()
        self.set_params(params, state)
        self.optimizer.load_state_dict(opt_state)
        checkpoints.save_named(self, "model_combined")
        checkpoints.mark_final(self.work_dir, "model_combined")
        self._log({"kind": "combine", "iterations": cands, **info,
                   "seconds": time.monotonic() - t0})
