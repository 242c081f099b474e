"""Process group, ``(data, model)`` mesh and the collectives of multi-GPU
training.

Counterpart of ``xvector_tpu/parallel/mesh.py`` on ``torch.distributed``.
The reference's process-level "parallelism" (per-iteration SGE jobs whose
checkpoints are averaged on NFS, ``train_dnn.py:247-304``) becomes
synchronous data parallelism over a ``(data, model)`` mesh of processes,
one device each:

* rank ``r`` sits at ``(r // model, r % model)``, the layout of the JAX
  package's ``make_mesh`` (``devices.reshape(data, model)``);
* the batch rows are split over ``data``; after every backward the
  gradients are summed over the data group in one flat all-reduce;
* the classifier head's columns may be split over ``model``
  (``head="sharded_softmax"``); everything else is held whole by every
  rank.

The collectives are ``all_reduce``, ``broadcast`` and ``barrier`` only, so
that one program runs three ways: W gloo processes on the CPU, W gloo
processes sharing one card (gloo stages CUDA tensors through host memory),
and NCCL with one card per rank.  A gather is an ``all_reduce`` of a
zero-filled buffer in which each rank fills its own block, and a halo
exchange is the same (gloo has no ``all_gather`` or point-to-point on
CUDA tensors).

Convention: every collective here takes ``group=None`` to mean "no peers"
(a one-member axis) and then does nothing; a :class:`Mesh` holds ``None``
for each axis of size 1.  (``torch.distributed`` itself reads ``None`` as
the world group.)

Gradients of the collectives, by what the caller's loss is:

* :func:`all_reduce_sum`: sum forward, sum backward.  For a quantity built
  from every rank's rows whose loss is each rank's own share (batch-norm
  moments across ``data``: the objective is the sum of the ranks' losses).
* :func:`reduce_from_group` and :func:`copy_to_group`: sum forward with an
  identity backward, and an identity forward whose backward sums.  The
  pair for a loss that every rank of the group holds whole (the sharded
  head across ``model``, the mean loss across ``data``).
* :func:`all_reduce_max`: no gradient.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..models.convert import tree_leaves, tree_map, tree_map2

__all__ = ["make_mesh", "batch_sharding", "param_shardings",
           "replicated", "init_distributed", "put_batch", "put_global",
           "block_batch_sharding", "Mesh", "Sharding", "all_reduce_sum",
           "reduce_from_group", "copy_to_group", "all_reduce_max",
           "all_reduce_flat", "broadcast_tree", "gather_dim", "barrier"]


def init_distributed(backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     device=None) -> torch.device:
    """Join the process group; returns this rank's device, made current.

    ``backend`` defaults to ``"nccl"`` on a CUDA device and ``"gloo"`` on
    the CPU; ``init_method`` is ``"file://<path>"`` (a path no earlier
    group used) or ``"tcp://<host>:<port>"``.  ``device`` defaults to
    ``"cuda"``.  A single process (``world_size`` None or 1) joins nothing.

    Before any backend starts, the ranks exchange their device names
    through the rendezvous store: NCCL refuses two ranks on one device and
    can hang or abort the job on it, so that raises ``ValueError`` here."""
    device = torch.device("cuda" if device is None else device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if not world_size or world_size <= 1:
        return _make_current(resolve_device(device))
    if init_method is None:
        raise ValueError("init_method is required with world_size > 1")
    store, rank, world_size = next(dist.rendezvous(init_method, rank,
                                                   world_size))
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"backend 'nccl' needs a CUDA device, not "
                             f"{device}")
        # the card a rank drives: its host, the cards it can see, its index
        name = (f"{socket.gethostname()}/"
                f"{os.environ.get('CUDA_VISIBLE_DEVICES', '*')}/"
                f"{device.index or 0}")
        store.set(f"xvec_device_{rank}", name)
        names = [store.get(f"xvec_device_{r}").decode()
                 for r in range(world_size)]
        shared = sorted({n for n in names if names.count(n) > 1})
        if shared:
            raise ValueError(
                f"backend 'nccl' with several ranks on one device "
                f"({shared}); give each rank its own card, or pass "
                f"backend='gloo'")
    device = _make_current(resolve_device(device))
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size)
    return device


def _make_current(device: torch.device) -> torch.device:
    """Make ``device`` this process's current CUDA device (the sm90
    kernels encode their TMA maps in the primary context of the current
    device) and give it an index."""
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    return device


@dataclass(frozen=True, eq=False)
class Mesh:
    """A ``(data, model)`` grid of ranks, one device each: this rank's
    place in it and the process groups of its two axes (``None`` where the
    axis has one member)."""
    data: int
    model: int
    rank: int
    device: torch.device
    data_group: Any = None
    model_group: Any = None
    world_group: Any = None

    @property
    def shape(self):
        return {"data": self.data, "model": self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def group(self, axis: str):
        return {"data": self.data_group, "model": self.model_group}[axis]

    def index(self, axis: str) -> int:
        return {"data": self.data_index, "model": self.model_index}[axis]


def make_mesh(data: int = -1, model: int = 1, device=None) -> Mesh:
    """The ``(data, model)`` mesh over every rank of the process group (one
    rank without one); ``data=-1`` puts the remaining ranks on ``data``.
    Every rank must call it with the same arguments: it creates the axes'
    groups, which is collective.  ``device`` defaults to the current CUDA
    device."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if data == -1:
        if world % model:
            raise ValueError(f"{world} ranks not divisible by model={model}")
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} needs {data * model} ranks; "
                         f"the process group has {world}")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else "cuda")
    groups = {"data": None, "model": None}
    # every rank creates every group, in the same order
    for axis, members in (
            ("data", [[d * model + m for d in range(data)]
                      for m in range(model)]),
            ("model", [[d * model + m for m in range(model)]
                       for d in range(data)])):
        for ranks in members:
            if len(ranks) > 1:
                g = dist.new_group(ranks)
                if rank in ranks:
                    groups[axis] = g
    return Mesh(data, model, rank, resolve_device(device),
                groups["data"], groups["model"],
                dist.group.WORLD if world > 1 else None)


# ---------------------------------------------------------------------------
# Layouts: which block of a tensor a rank holds
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Sharding:
    """A tensor's layout over ``mesh``: whole on every rank (``axis`` None)
    or split into equal blocks along ``dim`` over a mesh axis, the block at
    the rank's coordinate on that axis held by the rank."""
    mesh: Mesh
    axis: Optional[str] = None
    dim: int = 0

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole tensor ``x``."""
        if self.axis is None:
            return x
        n = self.mesh.shape[self.axis]
        if x.shape[self.dim] % n:
            raise ValueError(f"dim {self.dim} of shape {tuple(x.shape)} not "
                             f"divisible by {self.axis}={n}")
        per = x.shape[self.dim] // n
        return x.narrow(self.dim, self.mesh.index(self.axis) * per, per)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh)


def batch_sharding(mesh: Mesh) -> Sharding:
    """Leading batch axis split over ``data``."""
    return Sharding(mesh, "data", 0)


def block_batch_sharding(mesh: Mesh) -> Sharding:
    """(num_minibatches, batch, ...) stacks: the batch axis (axis 1) split
    over ``data``."""
    return Sharding(mesh, "data", 1)


def param_shardings(mesh: Mesh, params: Any) -> Any:
    """Layout tree for the model's params: the classifier head's columns
    split over ``model`` (``params["output"]``: ``w`` (D, C), ``b`` (C,)),
    every other tensor whole."""
    def assign(tree, path=()):
        if isinstance(tree, dict):
            return {k: assign(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(assign(v, path) for v in tree)
        if "output" in path and path[-1] == "w":
            return Sharding(mesh, "model", 1)
        if "output" in path and path[-1] == "b":
            return Sharding(mesh, "model", 0)
        return Sharding(mesh)

    return assign(params)


def put_batch(x, sharding: Sharding) -> torch.Tensor:
    """This rank's rows of the global batch ``x`` (host array or tensor),
    on its device."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    return sharding.local(t).contiguous().to(sharding.mesh.device)


def put_global(tree: Any, shardings: Any) -> Any:
    """Place a tree every rank holds whole (params, BN state at init):
    rank 0's bits are broadcast, so every rank starts from the same
    numbers, and each leaf keeps this rank's block of its layout.
    ``shardings`` is a tree of the same structure or one
    :class:`Sharding` for every leaf."""
    mesh = tree_leaves(shardings)[0].mesh
    tree = broadcast_tree(tree_map(lambda t: t.to(mesh.device), tree),
                          mesh.world_group)
    if isinstance(shardings, Sharding):
        return tree_map(lambda t: shardings.local(t).contiguous(), tree)
    return tree_map2(lambda t, s: s.local(t).contiguous(), tree, shardings)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def _dense(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy (collectives work in place on dense tensors)."""
    return t.clone(memory_format=torch.contiguous_format)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = _dense(x)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = _dense(g)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = _dense(x)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = _dense(g)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group; the backward sums the gradient over it too."""
    return x if group is None else _AllReduceSum.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group for a loss every member holds whole: the
    backward passes the gradient through unchanged."""
    return x if group is None else _ReduceFromGroup.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the backward sums the gradient over the group
    (each member's part of the loss needs every member's share)."""
    return x if group is None else _CopyToGroup.apply(x, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise maximum over the group, without gradient."""
    y = _dense(x.detach())
    if group is not None:
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


def all_reduce_flat(tensors: Sequence[torch.Tensor],
                    group) -> List[torch.Tensor]:
    """Sum a list of same-dtype tensors over the group in ONE all-reduce of
    their concatenation; returns the summed tensors, shapes kept."""
    if group is None:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    return [p.view_as(t) for p, t in
            zip(torch.split(flat, [t.numel() for t in tensors]), tensors)]


def broadcast_tree(tree: Any, group, src: int = 0) -> Any:
    """Every leaf of ``tree`` with the bits of the group's rank ``src``
    (global rank numbering); new tensors, without gradient."""
    def bcast(t):
        t = _dense(t.detach())
        if group is not None:
            dist.broadcast(t, src, group=group)
        return t

    return tree_map(bcast, tree)


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's blocks of a tensor split along ``dim``, in group-rank
    order: one all-reduce of a zero-filled buffer in which each member
    fills its own block (a sum with zeros is exact)."""
    if group is None:
        return x
    n, i = dist.get_world_size(group), dist.get_rank(group)
    # a 16-bit float sums in float32 on the way: exact, and gloo's support
    # for bfloat16 differs between versions
    work = torch.float32 if x.dtype in (torch.bfloat16,
                                        torch.float16) else x.dtype
    shape = list(x.shape)
    per = shape[dim]
    shape[dim] = per * n
    full = torch.zeros(shape, dtype=work, device=x.device)
    full.narrow(dim, i * per, per).copy_(x.detach())
    dist.all_reduce(full, group=group)
    return full.to(x.dtype)


def barrier(group) -> None:
    """Wait for every member of the group (nothing without peers)."""
    if group is not None:
        dist.barrier(group=group)
