"""Multi-process launch utilities.

Counterpart of ``xvector_tpu/parallel/launch.py``.  The reference's SGE
job fabric (``queue.pl``/``run.pl`` selected in ``cmd.sh:14-26``, one job
per iteration per archive from ``train_dnn.py:270``) becomes ONE program
started once per rank; ``torch.distributed`` joins the ranks and
all-reduces replace checkpoint exchange over NFS.

Launch contract: every rank gets the rendezvous address, the number of
processes and its own index, as arguments or through the JAX package's
variables ``XVEC_COORDINATOR`` (``host:port``, or ``file://<path>``),
``XVEC_NUM_PROCESSES`` and ``XVEC_PROCESS_ID``; the port's own
``XVEC_BACKEND`` may name the backend (``gloo`` or ``nccl``; by default
NCCL on a card, gloo on the CPU).

Every card of the host: the JAX package's ``Trainer`` without a mesh
spans every local device, so its entry points train on every chip.  The
port's entry points do the same through :func:`run`: on a host with W > 1
visible cards (``CUDA_VISIBLE_DEVICES`` picks them) and none of the
variables set, the process builds the kernels once and starts W copies of
itself, rank ``r`` on ``cuda:r`` under NCCL (:func:`spawn_local_ranks`);
with the variables set it is one of those ranks (:func:`join`).

Per-rank data: each rank feeds only its rows of every global batch
(:func:`local_rows`, which pads a minibatch that the data axis does not
divide with weight-0 rows, as the JAX package's single controller does;
:func:`host_local_batch_slice` for a batch it divides);
:func:`shard_archives` splits archive indices round-robin over ranks,
replacing the reference's per-job archive assignment
(``train_dnn.py:247-252`` ``archive_index = k % num_archives``).
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import mesh as meshlib

__all__ = ["auto_initialize", "host_local_batch_slice", "shard_archives",
           "is_coordinator", "local_rows", "spawns", "spawn_local_ranks",
           "join", "run", "Rank0Stage", "leave_group"]

def auto_initialize(coordinator: Optional[str] = None,
                    num_processes: Optional[int] = None,
                    process_id: Optional[int] = None,
                    backend: Optional[str] = None, device=None):
    """Join the process group from the arguments or the ``XVEC_*``
    variables; a single process joins nothing.  Returns this rank's device
    (:func:`~.mesh.init_distributed`, which also says what ``backend`` and
    ``device`` default to)."""
    coordinator = coordinator or os.environ.get("XVEC_COORDINATOR")
    num_processes = num_processes or int(
        os.environ.get("XVEC_NUM_PROCESSES", "1"))
    process_id = (process_id if process_id is not None
                  else int(os.environ.get("XVEC_PROCESS_ID", "0")))
    if coordinator is not None and "://" not in coordinator:
        coordinator = f"tcp://{coordinator}"
    return meshlib.init_distributed(backend, coordinator, num_processes,
                                    process_id, device)


def _rank_and_size() -> Tuple[int, int]:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_coordinator() -> bool:
    return _rank_and_size()[0] == 0


def host_local_batch_slice(global_batch: int,
                           mesh: Optional[meshlib.Mesh] = None
                           ) -> Tuple[int, int]:
    """[begin, end) rows of a global batch this rank must provide: the
    rows are split over the ranks, or over the data axis of ``mesh`` (the
    ranks of one data index hold the same rows)."""
    if mesh is None:
        index, n = _rank_and_size()
    else:
        index, n = mesh.data_index, mesh.data
    if global_batch % n:
        raise ValueError(
            f"global batch {global_batch} not divisible by {n} ranks")
    per = global_batch // n
    return index * per, (index + 1) * per


def shard_archives(num_archives: int) -> List[int]:
    """Archive indices this rank materialises (round-robin over ranks),
    the per-rank fan-out replacing get_egs.sh's nj-way archive writers."""
    rank, n = _rank_and_size()
    return list(range(rank, num_archives, n))


def local_rows(batches: Iterable[Tuple], mesh: Optional[meshlib.Mesh]
               ) -> Iterable[Tuple]:
    """This rank's rows of each global minibatch ``(feats, labels,
    true_len)``, as ``(feats, labels, true_len, global_rows)``.

    A minibatch whose rows the data axis does not divide is first padded
    with zero rows to a multiple of it, as the JAX package's
    ``Trainer._pad_rows`` pads for its single controller; ``global_rows``
    is the true row count, so the trainer gives the pad rows weight 0.
    Without a mesh, or with one data index, the minibatches pass
    unchanged."""
    if mesh is None or mesh.data == 1:
        yield from batches
        return
    for feats, labels, true_len in batches:
        n = feats.shape[0]
        pad = (-n) % mesh.data
        if pad:
            feats = np.concatenate(
                [feats, np.zeros((pad,) + feats.shape[1:], feats.dtype)])
            labels = np.concatenate([labels, np.zeros(pad, labels.dtype)])
        lo, hi = host_local_batch_slice(n + pad, mesh)
        yield feats[lo:hi], labels[lo:hi], true_len, n


def spawns(device) -> bool:
    """Whether an entry point should start one rank per local card: no
    process group is joined, none of the launch variables is set, the
    device is CUDA with no card named (``cuda:N`` stays one process on
    card N) and more than one card is visible."""
    dev = torch.device(device)
    return (not dist.is_initialized()
            and "XVEC_NUM_PROCESSES" not in os.environ
            and dev.type == "cuda" and dev.index is None
            and torch.cuda.device_count() > 1)


def _build_once():
    """Build the CUDA kernels and libxta here, before the ranks start, so
    that W processes do not compile the same sources at once."""
    from ..ops import _build
    from ..runtime import native
    _build.build()
    native.available()


def spawn_local_ranks(command: Sequence[str], work_dir: str,
                      world: Optional[int] = None,
                      timeout: Optional[float] = None) -> None:
    """Run ``python <command>`` as ``world`` ranks (default: one per
    visible card) and return when every rank has ended well.

    Each child gets the launch variables: a fresh ``file://`` store under
    ``<work_dir>/.ranks/``, ``XVEC_NUM_PROCESSES`` and its
    ``XVEC_PROCESS_ID``, this package first on ``PYTHONPATH``, and
    (unless set) ``OMP_NUM_THREADS`` at its share of the host's cores; its
    output goes to this process's.  SIGTERM and SIGINT are forwarded to
    every child (a rank's ``GracefulPreemption`` stops at a safe point).
    When a rank fails, every other rank is killed and this process exits
    with that rank's code (128 + the signal for a rank a signal ended),
    after saying which rank it was; past ``timeout`` seconds (None: no
    limit, as for training) every rank is killed and the exit code is
    124."""
    world = world or torch.cuda.device_count()
    _build_once()
    store = os.path.join(os.path.abspath(work_dir), ".ranks",
                         str(time.time_ns()))
    os.makedirs(store)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    base = dict(os.environ)
    base["PYTHONPATH"] = repo + os.pathsep + base.get("PYTHONPATH", "")
    base["XVEC_COORDINATOR"] = "file://" + os.path.join(store, "rendezvous")
    base["XVEC_NUM_PROCESSES"] = str(world)
    # the ranks share the host's cores: W OpenMP pools of every core each
    # spin against one another
    base.setdefault("OMP_NUM_THREADS",
                    str(max(1, (os.cpu_count() or 1) // world)))
    procs: List[subprocess.Popen] = []

    def forward(signum, frame):
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    main_thread = threading.current_thread() is threading.main_thread()
    previous = {}
    if main_thread:
        for s in (signal.SIGTERM, signal.SIGINT):
            previous[s] = signal.signal(s, forward)
    try:
        for r in range(world):
            env = dict(base, XVEC_PROCESS_ID=str(r))
            procs.append(subprocess.Popen([sys.executable, *command],
                                          env=env))
        from .mc_harness import watch
        failed, timed_out = watch(procs, timeout)
    finally:
        for s, handler in previous.items():
            signal.signal(s, handler)
    shutil.rmtree(store, ignore_errors=True)
    if timed_out:
        print(f"launch: the {world} ranks ran past {timeout} s and were "
              "stopped", file=sys.stderr)
        raise SystemExit(124)
    if failed is not None:
        code = procs[failed].returncode
        print(f"launch: rank {failed} of {world} failed with exit code "
              f"{code}; the other ranks were stopped", file=sys.stderr)
        raise SystemExit(code if code > 0 else 128 - code)


def join(device) -> Tuple["torch.device", Optional[meshlib.Mesh]]:
    """This process's device and mesh under the launch contract.  With
    ``XVEC_NUM_PROCESSES`` > 1: rank ``r`` joins the group on ``cuda:r``
    (``cuda:0`` for every rank when one card is visible: gloo only) or on
    the CPU, and every rank builds the ``(data, 1)`` mesh over the group.
    Else one process on ``device`` and no mesh."""
    world = int(os.environ.get("XVEC_NUM_PROCESSES", "1"))
    dev = torch.device(device)
    if world <= 1:
        return auto_initialize(num_processes=1, device=dev), None
    rank = int(os.environ["XVEC_PROCESS_ID"])
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % max(torch.cuda.device_count(), 1))
    dev = auto_initialize(backend=os.environ.get("XVEC_BACKEND") or None,
                          device=dev)
    return dev, meshlib.make_mesh(device=dev)


def run(module: str, argv: Optional[Sequence[str]], device, work_dir: str,
        body: Callable[["torch.device", Optional[meshlib.Mesh]], Any],
        read_result: Optional[Callable[[], Any]] = None) -> Any:
    """An entry point on every local card: where :func:`spawns` says so,
    start the ranks and, once they have ended, return ``read_result()``
    (what rank 0 wrote, e.g. ``sre16_results.json``; None without it);
    else run ``body(device, mesh)`` as this process's rank (or alone) and
    return its result.

    The ranks run the same program: this process's own command line when
    the entry point was called as a program (``argv`` None), else
    ``python -m <module> <argv>``.  Every rank leaves the process group at
    the end."""
    if spawns(device):
        command = (sys.orig_argv[1:] if argv is None
                   else ["-m", module, *argv])
        spawn_local_ranks(command, work_dir)
        return None if read_result is None else read_result()
    dev, mesh = join(device)
    result = body(dev, mesh)
    if mesh is not None and dist.is_initialized():
        dist.destroy_process_group()
    return result


class Rank0Stage:
    """A stage that rank 0 alone runs while the other ranks wait for it,
    outside any collective: the recipes' host stages (corpus prep,
    features, egs), which may run for hours, longer than a collective
    may wait.

    >>> with Rank0Stage(mesh, work_dir, "egs") as stage:
    ...     if stage.runs_here:
    ...         stage.result = {"num_targets": make_egs()}
    >>> stage.result["num_targets"]

    Entering is one broadcast (a token that names this run's flag file);
    on leaving, rank 0 writes ``result`` (JSON) or its failure to the flag
    file, and every other rank waits for that file, with no time limit,
    and takes the result, or raises if rank 0 failed.  Without a mesh of
    several ranks the body runs here and nothing is waited for."""

    def __init__(self, mesh: Optional[meshlib.Mesh], work_dir: str,
                 name: str):
        self.mesh, self.name = mesh, name
        self.dir = os.path.join(os.path.abspath(work_dir), ".ranks")
        self.runs_here = mesh is None or mesh.rank == 0
        self.result: Any = None
        self._flag: Optional[str] = None

    def __enter__(self) -> "Rank0Stage":
        if self.mesh is not None and self.mesh.size > 1:
            token = torch.zeros(1, dtype=torch.int64,
                                device=self.mesh.device)
            if self.runs_here:
                token[0] = int.from_bytes(os.urandom(6), "little")
            token = meshlib.broadcast_tree(token, self.mesh.world_group)
            self._flag = os.path.join(self.dir,
                                      f"{self.name}.{int(token[0])}.json")
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._flag is None:
            return False
        if self.runs_here:
            os.makedirs(self.dir, exist_ok=True)
            for old in os.listdir(self.dir):   # earlier runs' flags
                if old.startswith(self.name + "."):
                    os.remove(os.path.join(self.dir, old))
            tmp = f"{self._flag}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump({"ok": exc_type is None,
                           "result": None if exc_type else self.result}, f)
            os.replace(tmp, self._flag)
            return False
        if exc_type is not None:
            return False
        while not os.path.exists(self._flag):
            time.sleep(0.2)
        with open(self._flag) as f:
            got = json.load(f)
        if not got["ok"]:
            raise RuntimeError(f"rank 0 failed in its {self.name!r} stage")
        self.result = got["result"]
        return False


def leave_group(mesh: Optional[meshlib.Mesh]) -> bool:
    """End the multi-rank part of an entry point: every rank waits for the
    others and leaves the process group; returns True on the rank that
    goes on alone (rank 0, or a process without a mesh)."""
    if mesh is None:
        return True
    meshlib.barrier(mesh.world_group)
    dist.destroy_process_group()
    return mesh.rank == 0
