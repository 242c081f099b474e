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
the last iteration's directory (or to ``model_combined``).

Several ranks (``parallel/mesh.py``) share one work dir: every rank of the
trainer's mesh calls the save functions at the same point, the mesh's
coordinator (its rank 0) alone writes, marks ``done``, collects garbage
and marks ``model_final``, and every rank passes the same barriers
(``pre_save``, ``post_save``, ``post_done``, ``mark_final``) as the JAX
package's, on the mesh's world group.  The functions that take a work dir
instead of a trainer take its ``mesh`` (None: one process).  Under a head whose
columns are split over the ``model`` axis, the head and its optimizer
moments are gathered before the save, so the file has the single-process
layout whatever the mesh: ``cli.extract_embedding`` and a one-process
resume read it unchanged, and :func:`restore_into` splits it again.
"""

from __future__ import annotations

import os
import shutil
from typing import TYPE_CHECKING, Optional

import torch

from ..models.convert import (gather_params, shard_params, tree_leaves,
                              tree_map)
from ..parallel import mesh as meshlib

if TYPE_CHECKING:
    from .trainer import Trainer

__all__ = ["save_iteration", "restore_latest", "restore_into",
           "collect_garbage", "mark_final", "iteration_dirs",
           "is_complete", "pin_seed", "load_pytrees", "save_named",
           "iteration_path", "latest_complete"]

CKPT = "ckpt.pt"


def _is_coordinator(mesh: Optional[meshlib.Mesh]) -> bool:
    return mesh is None or mesh.rank == 0


def _sync(tag: str, mesh: Optional[meshlib.Mesh]):
    """Barrier over the mesh's ranks (nothing for one process).  Ranks that
    share a work dir need the coordinator's writes ordered against every
    rank's reads, and the ``done`` sentinel visible everywhere before any
    rank passes the iteration boundary.  ``tag`` names the barrier where
    it is called."""
    meshlib.barrier(None if mesh is None else mesh.world_group)


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


def _head_sharded(trainer: "Trainer") -> bool:
    return trainer.cfg.head == "sharded_softmax" and trainer.mesh.model > 1


def _map_head_moments(trainer: "Trainer", opt: dict, fn) -> dict:
    """``opt`` (a state dict, keyed by ``tree_leaves`` order) with
    ``fn(tensor, dim)`` applied to the per-element moments of the head's
    ``w`` and ``b``, whose columns run along dim 1 and 0 (the entries
    shaped like their parameter; step counts stay)."""
    out = trainer.params["output"]
    dims = {id(out["w"]): 1, id(out["b"]): 0}
    state = dict(opt["state"])
    for i, leaf in enumerate(tree_leaves(trainer.params)):
        if id(leaf) in dims and i in state:
            state[i] = {k: (fn(v, dims[id(leaf)])
                            if isinstance(v, torch.Tensor)
                            and v.dim() == leaf.dim() else v)
                        for k, v in state[i].items()}
    return {**opt, "state": state}


def _write(trainer: "Trainer", d: str) -> str:
    params = tree_map(torch.Tensor.detach, trainer.params)
    opt = trainer.optimizer.state_dict()
    if _head_sharded(trainer):
        group = trainer.mesh.model_group
        params = gather_params(params, trainer.mesh)
        opt = _map_head_moments(
            trainer, opt, lambda t, dim: meshlib.gather_dim(t, dim, group))
    done = os.path.join(d, "done")
    if _is_coordinator(trainer.mesh):
        os.makedirs(d, exist_ok=True)
        if os.path.exists(done):    # a rewrite is incomplete until it commits
            os.remove(done)
    _sync("pre_save", trainer.mesh)
    if _is_coordinator(trainer.mesh):
        path = os.path.join(d, CKPT)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            torch.save({"params": params, "state": trainer.state,
                        "optimizer": opt}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    _sync("post_save", trainer.mesh)
    if _is_coordinator(trainer.mesh):
        with open(done, "w") as f:
            f.write("done\n")
    _sync("post_done", trainer.mesh)
    return d


def save_iteration(trainer: "Trainer", it: int):
    """Save the trainer's params, BN state and optimizer state as
    iteration ``it`` (collective when several ranks train)."""
    _write(trainer, _iter_dir(trainer.work_dir, it))


def save_named(trainer: "Trainer", name: str) -> str:
    """Save the trainer under ``<work_dir>/<name>`` with the layout of an
    iteration checkpoint (restorable by :func:`restore_into`)."""
    return _write(trainer, os.path.join(os.path.abspath(trainer.work_dir),
                                        name))


def restore_into(trainer: "Trainer", path: str):
    """Install a checkpoint dir's params and BN state in the trainer and
    rebuild its optimizer over the restored leaves (``tree_leaves`` order,
    the order its state dict is keyed by) with the saved state loaded.
    Under a head split over the ``model`` axis, each rank keeps its
    columns of the head and of their moments."""
    ckpt = torch.load(os.path.join(path, CKPT), map_location=trainer.device,
                      weights_only=True)
    params, opt = ckpt["params"], ckpt["optimizer"]
    if _head_sharded(trainer):
        params = shard_params(params, trainer.mesh)
    trainer.set_params(params, ckpt["state"])
    if _head_sharded(trainer):
        opt = _map_head_moments(
            trainer, opt, lambda t, dim: meshlib.Sharding(
                trainer.mesh, "model", dim).local(t).contiguous())
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
                    preserve_interval: int, keep=(),
                    mesh: Optional[meshlib.Mesh] = None):
    """Keep the last two iterations + every preserve_interval-th
    (ze_utils.py:186-194) + explicit ``keep`` iterations (the combination
    candidate set, train_dnn.py:565-567).  On a mesh only its coordinator
    deletes (a shared work dir has one deleter)."""
    if not _is_coordinator(mesh):
        return
    keep = set(keep)
    for it, path in iteration_dirs(work_dir):
        if it >= current_iter - 1 or it in keep:
            continue
        if preserve_interval > 0 and it % preserve_interval == 0:
            continue
        shutil.rmtree(path, ignore_errors=True)


def mark_final(work_dir: str, final_iter,
               mesh: Optional[meshlib.Mesh] = None):
    """Point ``model_final`` at iteration ``final_iter`` (int) or at a
    named checkpoint dir (str, e.g. ``model_combined``); the mesh's
    coordinator replaces the link atomically, then every rank of the mesh
    passes a barrier."""
    link = os.path.join(work_dir, "model_final")
    target = (f"model_{final_iter}" if isinstance(final_iter, int)
              else final_iter)
    if _is_coordinator(mesh):
        tmp = link + ".tmp"
        if os.path.islink(tmp) or os.path.exists(tmp):
            os.remove(tmp)
        os.symlink(target, tmp)
        os.replace(tmp, link)
    _sync("mark_final", mesh)
