"""Preemption-safe training: SIGTERM → stop at the next safe point and
let the per-iteration checkpoint carry the run.

Own copy of ``xvector_tpu/train/preemption.py`` (pure Python).  Cluster
schedulers surface maintenance events and capacity reclaims as SIGTERM
with a short grace window.  The reference's recovery contract is job-level
retry plus ``--stage`` resume (``train_dnn.py:17,344-397``); here the same
contract is a signal flag checked at two safe points:

* between minibatches inside an iteration — the in-flight iteration is
  abandoned (its partial updates live only in process memory; the next
  run's ``checkpoints.restore_latest`` replays it from the last complete
  checkpoint with the same (seed, iteration) RNG, so a preempted+resumed
  run is bit-identical to an uninterrupted one);
* at the iteration boundary — the just-saved checkpoint is durable, the
  run exits cleanly before starting work it cannot finish.
"""

from __future__ import annotations

import signal
import threading
from typing import Iterable

__all__ = ["GracefulPreemption", "PreemptedError"]


class PreemptedError(Exception):
    """Raised at a safe point inside an iteration when a shutdown signal
    arrived; the trainer converts it into a clean early return."""


class GracefulPreemption:
    """Context manager that latches shutdown signals into a flag.

    >>> with GracefulPreemption() as pre:
    ...     trainer.train(batches, n, preemption=pre)

    The previous handlers are chained (a supervising runtime's own
    handler still runs) and restored on exit.
    """

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._event = threading.Event()
        self._prev = {}

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def __call__(self) -> bool:            # usable directly as stop_check
        return self._event.is_set()

    def trigger(self):
        """Set the flag programmatically (tests, cooperative shutdown)."""
        self._event.set()

    def _handle(self, signum, frame):
        self._event.set()
        prev = self._prev.get(signum)
        if callable(prev):
            prev(signum, frame)

    def __enter__(self) -> "GracefulPreemption":
        for s in self._signals:
            self._prev[s] = signal.getsignal(s)
            signal.signal(s, self._handle)
        return self

    def __exit__(self, *exc):
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()
        return False
