"""Step-timing and tracing instrumentation.

Counterpart of ``xvector_tpu/utils/profiling.py``:

* :func:`span` — a named range (``xv.<layer>.<part>``) in a running
  ``torch.profiler`` trace, and nothing when no profiler records the
  thread (:func:`tracing`);
* :class:`StepTimer` — wall-clock per named phase, summarised the way the
  reference logs its disk-wait vs GPU-wait split (``models.py:240-289``),
  each phase also a span;
* :func:`device_forensics` — a post-mortem snapshot of the card for the
  trainer's retry and failure records.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch

__all__ = ["span", "tracing", "StepTimer", "device_forensics"]

_NULL = contextlib.nullcontext()


def tracing() -> bool:
    """Whether a profiler records this thread (``torch.autograd
    ._profiler_enabled()``): a caller builds a span's ``args`` only then."""
    return torch.autograd._profiler_enabled()


def span(name: str, args: Optional[str] = None):
    """``torch.profiler.record_function(name, args)`` while a profiler
    records this thread, else one shared null context.  The ranges are
    kineto events of the profile they belong to, on its clock."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name, args)
    return _NULL


class StepTimer:
    """Accumulate wall-clock per named phase; each phase is also the span
    ``<namespace>.<phase>``.

    >>> t = StepTimer("xv.train")
    >>> with t("upload_wait"): ...
    >>> with t("dispatch"): ...
    >>> t.summary()   # {'upload_wait': ..., 'upload_wait_mean_ms': ...}
    """

    def __init__(self, namespace: str):
        self.namespace = namespace
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, phase: str) -> Iterator[None]:
        t0 = time.monotonic()
        try:
            with span(f"{self.namespace}.{phase}"):
                yield
        finally:
            self.totals[phase] += time.monotonic() - t0
            self.counts[phase] += 1

    def summary(self) -> Dict[str, float]:
        """Seconds of each phase and its mean milliseconds per call."""
        out: Dict[str, float] = {}
        for phase, secs in self.totals.items():
            out[phase] = secs
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
