"""Helpers that every bench module shares: the card's identity, a refusal
to run without one, two clocks and the spread of a run's rounds.

A bench measures the card.  Without one it stops (:func:`require_card`);
it never falls back to the CPU, so no CPU time is ever printed under a
device metric's name.  The measuring functions themselves take a
``device`` so that the tests can run their arithmetic on the CPU."""

from __future__ import annotations

import statistics
import subprocess
import sys
import time
from typing import Callable, Dict, Sequence

import torch

__all__ = ["card", "card_line", "require_card", "cuda_ms", "host_ms",
           "spread", "CheckFailed"]


class CheckFailed(RuntimeError):
    """An output of a bench run is wrong; its ``main`` exits non-zero."""


def card_line() -> str:
    """The first card's name and power limit exactly as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def card() -> Dict[str, object]:
    """``{"name", "power_limit", "count"}`` of the machine's cards."""
    name, _, limit = card_line().partition(",")
    return {"name": name.strip(), "power_limit": limit.strip(),
            "count": torch.cuda.device_count()}


def require_card(tool: str) -> None:
    """Exit with code 1 and a message when no CUDA card is visible."""
    if not torch.cuda.is_available():
        print(f"{tool}: torch.cuda.is_available() is False; this bench "
              "measures an NVIDIA GPU and does not run on the CPU",
              file=sys.stderr)
        raise SystemExit(1)


def cuda_ms(fn: Callable[[], object], iters: int = 20,
            warmup: int = 3) -> float:
    """Device ms per call: CUDA events around ``iters`` back-to-back calls
    after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn: Callable[[], object], iters: int) -> float:
    """Host ms per call: a host clock around ``iters`` calls that ends in
    ``torch.cuda.synchronize()`` (the caller's whole cost, the host's
    dispatch included)."""
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def spread(samples: Sequence[float], best=min) -> Dict[str, float]:
    """Median, first and third quartile, ``best`` (``min`` for a time,
    ``max`` for a rate), the count, and ``window``, of a run's rounds.

    Every round does the same work, so ``window`` is the whole run's
    value, all of its work over all of its time: the mean of per-round
    times, or the harmonic mean of per-round rates.  Unlike the median,
    it moves when one round stalls."""
    xs = [float(x) for x in samples]
    if not xs:
        raise ValueError("spread of no samples")
    if len(xs) == 1:
        q1 = q3 = xs[0]
    else:
        q1, _, q3 = statistics.quantiles(xs, n=4, method="inclusive")
    window = (statistics.harmonic_mean(xs) if best is max
              else statistics.fmean(xs))
    return {"median": statistics.median(xs), "q1": q1, "q3": q3,
            "best": best(xs), "n": len(xs), "window": window}
