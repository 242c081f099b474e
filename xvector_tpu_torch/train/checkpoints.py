"""Iteration checkpoints with the reference's lifecycle, on ``torch.save``.

Counterpart of ``xvector_tpu/train/checkpoints.py`` with the same public
names and lifecycle (``models.py:130-162`` save/load,
``train_dnn.py:344-346`` resume-by-skip, ``ze_utils.py:186-194`` GC keeping
the last two + every ``preserve_model_interval``-th, ``train_dnn.py:583``
``model_final`` symlink, ``done`` sentinel ``ze_utils.py:561-567``).

Layout: ``<work_dir>/model_<iter>/{ckpt.pt, done}``; ``ckpt.pt`` holds
``{"params", "state", "optimizer": optimizer.state_dict()}``.  A save
commits atomically: ``ckpt.pt.tmp`` is written and synced, renamed into
place, and only then is ``done`` written.  ``model_final`` is a symlink to
the last iteration's directory (or to ``model_combined``).  One process
owns the work dir: the JAX package's cross-process barriers have no
counterpart until multi-process training is ported.
"""

from __future__ import annotations

import os
import shutil
from typing import TYPE_CHECKING

import torch

from ..models.convert import tree_map

if TYPE_CHECKING:
    from .trainer import Trainer

__all__ = ["save_iteration", "restore_latest", "restore_into",
           "collect_garbage", "mark_final", "iteration_dirs",
           "is_complete", "pin_seed", "load_pytrees", "save_named",
           "iteration_path", "latest_complete"]

CKPT = "ckpt.pt"


def pin_seed(work_dir: str, seed: int):
    """Seed-pinning guard (``train_dnn.py:323-338``): the first run writes
    ``srand`` into the work dir; a resume with a different ``random_seed``
    would silently diverge the dropout streams, so it raises instead."""
    os.makedirs(work_dir, exist_ok=True)
    path = os.path.join(os.path.abspath(work_dir), "srand")
    if os.path.exists(path):
        with open(path) as f:
            stored = int(f.read().strip())
        if stored != seed:
            raise ValueError(
                f"work dir {work_dir} was trained with --random-seed "
                f"{stored}; resuming with {seed} would diverge the "
                f"data/dropout streams (reference guard "
                f"train_dnn.py:323-338)")
        return
    # atomic: a crash mid-write must not leave a partial file that blocks
    # every future resume
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(f"{seed}\n")
    os.replace(tmp, path)


def _iter_dir(work_dir: str, it: int) -> str:
    return os.path.join(os.path.abspath(work_dir), f"model_{it}")


def iteration_path(work_dir: str, it: int) -> str:
    """Public path accessor for iteration ``it``'s checkpoint dir."""
    return _iter_dir(work_dir, it)


def latest_complete(work_dir: str):
    """Index of the newest COMPLETE iteration checkpoint, or None when the
    work dir holds none (``restore_latest``'s 0 can mean either)."""
    best = None
    for it, path in iteration_dirs(work_dir):
        if is_complete(path):
            best = it if best is None else max(best, it)
    return best


def is_complete(path: str) -> bool:
    return os.path.exists(os.path.join(path, "done"))


def _write(trainer: "Trainer", d: str) -> str:
    os.makedirs(d, exist_ok=True)
    done = os.path.join(d, "done")
    if os.path.exists(done):        # a rewrite is incomplete until it commits
        os.remove(done)
    path = os.path.join(d, CKPT)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        torch.save({"params": tree_map(torch.Tensor.detach, trainer.params),
                    "state": trainer.state,
                    "optimizer": trainer.optimizer.state_dict()}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    with open(done, "w") as f:
        f.write("done\n")
    return d


def save_iteration(trainer: "Trainer", it: int):
    """Save the trainer's params, BN state and optimizer state as
    iteration ``it``."""
    _write(trainer, _iter_dir(trainer.work_dir, it))


def save_named(trainer: "Trainer", name: str) -> str:
    """Save the trainer under ``<work_dir>/<name>`` with the layout of an
    iteration checkpoint (restorable by :func:`restore_into`)."""
    return _write(trainer, os.path.join(os.path.abspath(trainer.work_dir),
                                        name))


def restore_into(trainer: "Trainer", path: str):
    """Install a checkpoint dir's params and BN state in the trainer and
    rebuild its optimizer over the restored leaves (``tree_leaves`` order,
    the order its state dict is keyed by) with the saved state loaded."""
    ckpt = torch.load(os.path.join(path, CKPT), map_location=trainer.device,
                      weights_only=True)
    trainer.set_params(ckpt["params"], ckpt["state"])
    opt = ckpt["optimizer"]
    for st in opt["state"].values():
        # torch.optim.Adam keeps its step count on the CPU (capturable is
        # off); map_location moved it to the trainer's device
        if isinstance(st.get("step"), torch.Tensor):
            st["step"] = st["step"].cpu()
    trainer.optimizer.load_state_dict(opt)


def load_pytrees(trainer: "Trainer", path: str):
    """Read a checkpoint's (params, state) on the trainer's device WITHOUT
    touching the trainer — final combination gathers its candidates so.
    The file is memory-mapped and the optimizer state (2/3 of its bytes
    with Adam) is never read."""
    ckpt = torch.load(os.path.join(path, CKPT), map_location="cpu",
                      weights_only=True, mmap=True)

    def to_device(t):
        return t.to(trainer.device, copy=True)

    return tree_map(to_device, ckpt["params"]), \
        tree_map(to_device, ckpt["state"])


def iteration_dirs(work_dir: str):
    out = []
    if not os.path.isdir(work_dir):
        return out
    for name in os.listdir(work_dir):
        if name.startswith("model_") and name[6:].isdigit():
            out.append((int(name[6:]), os.path.join(work_dir, name)))
    return sorted(out)


def restore_latest(trainer: "Trainer", start_iter: int = 0) -> int:
    """Resume from the newest complete iteration checkpoint ≥ start_iter.
    Returns the iteration index to continue from."""
    best = None
    for it, path in iteration_dirs(trainer.work_dir):
        if it >= start_iter and is_complete(path):
            best = (it, path)
    if best is None:
        return start_iter
    restore_into(trainer, best[1])
    return best[0]


def collect_garbage(work_dir: str, current_iter: int,
                    preserve_interval: int, keep=()):
    """Keep the last two iterations + every preserve_interval-th
    (ze_utils.py:186-194) + explicit ``keep`` iterations (the combination
    candidate set, train_dnn.py:565-567)."""
    keep = set(keep)
    for it, path in iteration_dirs(work_dir):
        if it >= current_iter - 1 or it in keep:
            continue
        if preserve_interval > 0 and it % preserve_interval == 0:
            continue
        shutil.rmtree(path, ignore_errors=True)


def mark_final(work_dir: str, final_iter):
    """Point ``model_final`` at iteration ``final_iter`` (int) or at a
    named checkpoint dir (str, e.g. ``model_combined``); the link is
    replaced atomically."""
    link = os.path.join(work_dir, "model_final")
    target = (f"model_{final_iter}" if isinstance(final_iter, int)
              else final_iter)
    tmp = link + ".tmp"
    if os.path.islink(tmp) or os.path.exists(tmp):
        os.remove(tmp)
    os.symlink(target, tmp)
    os.replace(tmp, link)
