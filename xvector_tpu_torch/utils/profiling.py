"""Step-timing instrumentation.

Counterpart of ``xvector_tpu/utils/profiling.py``:

* :class:`StepTimer` — wall-clock per named phase, summarised the way the
  reference logs its disk-wait vs GPU-wait split (``models.py:240-289``);
* :func:`device_forensics` — a post-mortem snapshot of the card for the
  trainer's retry and failure records.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch

__all__ = ["StepTimer", "device_forensics"]


class StepTimer:
    """Accumulate wall-clock per named phase.

    >>> t = StepTimer()
    >>> with t("disk"): ...
    >>> with t("device"): ...
    >>> t.summary()   # {'disk': ..., 'device': ..., 'disk_pct': ...}
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, phase: str) -> Iterator[None]:
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.totals[phase] += time.monotonic() - t0
            self.counts[phase] += 1

    def summary(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        total = sum(self.totals.values()) or 1.0
        for phase, secs in self.totals.items():
            out[phase] = secs
            out[f"{phase}_pct"] = 100.0 * secs / total
            out[f"{phase}_mean_ms"] = 1e3 * secs / max(self.counts[phase], 1)
        return out


def device_forensics() -> Dict:
    """Post-mortem snapshot of the CUDA runtime, the counterpart of the
    reference's GPU-unavailability dump (nvidia-smi parse + ``qstat -xml``,
    ``ze_utils.py:570-623``): device names, free and total memory
    (``mem_get_info``), the caching allocator's ``memory_stats()`` and a
    census of live CUDA tensors.  Safe to call from any failure path: every
    probe is guarded.  Without a card it returns ``{"backend": "cpu"}``."""
    try:
        if not torch.cuda.is_available():
            return {"backend": "cpu"}
        count = torch.cuda.device_count()
        out: Dict = {"backend": "cuda", "device_count": count,
                     "devices": [torch.cuda.get_device_name(i)
                                 for i in range(count)]}
    except Exception as e:          # the runtime itself may be down
        return {"backend": "cuda", "runtime_error": repr(e)}
    mem = {}
    for i in range(count):
        entry: Dict = {}
        try:
            entry["free_bytes"], entry["total_bytes"] = \
                torch.cuda.mem_get_info(i)
        except Exception as e:
            entry["mem_get_info_error"] = repr(e)
        try:
            entry["memory_stats"] = torch.cuda.memory_stats(i)
        except Exception as e:
            entry["memory_stats_error"] = repr(e)
        mem[f"cuda:{i}"] = entry
    out["memory"] = mem
    try:
        import gc
        n = nbytes = 0
        for obj in gc.get_objects():
            if isinstance(obj, torch.Tensor) and obj.is_cuda:
                n += 1
                nbytes += obj.numel() * obj.element_size()
        out["live_tensors"] = n
        out["live_bytes"] = nbytes
    except Exception as e:
        out["census_error"] = repr(e)
    return out
