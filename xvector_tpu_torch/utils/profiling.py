"""Step-timing instrumentation.

Counterpart of ``xvector_tpu/utils/profiling.py`` (``StepTimer`` only):
wall-clock per named phase, summarised the way the reference logs its
disk-wait vs GPU-wait split (``models.py:240-289``).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator

__all__ = ["StepTimer"]


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
