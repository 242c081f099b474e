"""Multi-process launch utilities.

Counterpart of ``xvector_tpu/parallel/launch.py``.  The reference's SGE
job fabric (``queue.pl``/``run.pl`` selected in ``cmd.sh:14-26``, one job
per iteration per archive from ``train_dnn.py:270``) becomes ONE program
started once per rank; ``torch.distributed`` joins the ranks and
all-reduces replace checkpoint exchange over NFS.

Launch contract: every rank gets the rendezvous address, the number of
processes and its own index, as arguments or through the JAX package's
variables ``XVEC_COORDINATOR`` (``host:port``, or ``file://<path>``),
``XVEC_NUM_PROCESSES`` and ``XVEC_PROCESS_ID``.

Per-rank data: each rank feeds only its rows of every global batch
(:func:`host_local_batch_slice`); :func:`shard_archives` splits archive
indices round-robin over ranks, replacing the reference's per-job archive
assignment (``train_dnn.py:247-252`` ``archive_index = k % num_archives``).
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import torch.distributed as dist

from . import mesh as meshlib

__all__ = ["auto_initialize", "host_local_batch_slice", "shard_archives",
           "is_coordinator"]


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
