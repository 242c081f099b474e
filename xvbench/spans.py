#!/usr/bin/env python3
"""Credit of a traced part's device time and idle gaps to the program's
``xv.*`` spans, and the per-layer readings built on it.

The program opens ``xv.<layer>.<part>`` ranges (``torch.profiler
.record_function``) at its layer boundaries while a profiler runs.  Each
device operation is credited to the innermost ``xv.*`` span open on the
thread that launched it, at its launch (the CPU runtime call with the
operation's correlation id).  Where that thread holds no ``xv.*`` span then
(the autograd engine's thread launches the backward pass while
``xv.train.backward`` is open on the main thread), the credit goes to the
innermost span of the thread whose outermost open ``xv.*`` span began
first.  Each idle gap of at least ``trace.GAP_MIN_US`` is credited by the
same rule at its midpoint, on the thread that launched the operation that
ends it.  What no span holds is credited to ``"(none)"``.  Device time is
the union of the operations, as ``trace.Tracer`` counts ``busy_s``, so the
credited seconds add up to ``busy_s``.

:func:`credit` works on plain tuples; :func:`profile_events` takes them from
a ``torch.profiler`` profile.  ``trace.Tracer``'s summary does not carry
these keys yet; until it does, run a cell through this file::

    python3 xvbench/spans.py --workload <name> --seed <n> --seconds <s>

It runs the cell as ``run.py --trace 1`` does, adds the span credit to the
traced summary and the extractor's counters over the traced call to the
collected work, and prints the result line with a ``spans`` object: the
credit, the shares of ``busy_s`` and of the idle seconds that spans hold,
and the span readings of :func:`readings`.
"""

from __future__ import annotations

import bisect
import contextlib
import math
import os
import sys
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

NONE = "(none)"
PREFIX = "xv."

Span = Tuple[object, float, float, str]          # thread, start, end, name
Launch = Tuple[object, float]                    # thread, time
DeviceOp = Tuple[object, float, float]           # correlation, start, end


class _Timeline:
    """The stack of open spans of one thread at any moment: after each
    boundary (a span's start or end) the open spans, outermost first, as
    (start, name) pairs."""

    def __init__(self, spans: Iterable[Tuple[float, float, str]]):
        self.times: List[float] = []
        self.stacks: List[tuple] = []
        stack: List[Tuple[float, float, str]] = []

        def close_until(t: float):
            while stack and stack[-1][1] <= t:
                end = stack.pop()[1]
                self._mark(end, stack)

        for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
            close_until(s)
            if stack:               # a child never outlives its parent
                e = min(e, stack[-1][1])
            stack.append((s, e, name))
            self._mark(s, stack)
        close_until(math.inf)

    def _mark(self, t: float, stack):
        self.times.append(t)
        self.stacks.append(tuple((s, n) for s, _, n in stack))

    def at(self, t: float) -> tuple:
        i = bisect.bisect_right(self.times, t) - 1
        return self.stacks[i] if i >= 0 else ()


class _Locator:
    def __init__(self, spans: Iterable[Span]):
        by_thread: Dict[object, list] = {}
        for thread, s, e, name in spans:
            by_thread.setdefault(thread, []).append((s, e, name))
        self.lines = {th: _Timeline(v) for th, v in by_thread.items()}

    def stack(self, thread, t: float) -> tuple:
        """The open spans that take the credit of a launch on ``thread`` at
        ``t``: that thread's, else those of the thread whose outermost open
        span began first, else none."""
        line = self.lines.get(thread)
        own = line.at(t) if line is not None else ()
        if own:
            return own
        best = ()
        for other in self.lines.values():
            st = other.at(t)
            if st and (not best or st[0][0] < best[0][0]):
                best = st
        return best


def _add(out: Dict[str, float], key: str, v: float):
    out[key] = out.get(key, 0.0) + v


def credit(spans: Sequence[Span], launches: Mapping[object, Launch],
           device_ops: Sequence[DeviceOp], gap_min_us: float
           ) -> Dict[str, Dict[str, float]]:
    """Credit host spans, device time and idle gaps (times in
    microseconds; results in seconds).

    ``spans``: (thread, start, end, name) of every ``xv.*`` span;
    ``launches``: {correlation: (thread, time)} of the runtime calls that
    launched device work; ``device_ops``: (correlation, start, end) of each
    device operation; gaps shorter than ``gap_min_us`` are not idle
    gaps.  Returns ``span_s`` and ``span_n`` (host seconds and
    calls of each span), ``span_device_s`` and ``span_idle_s`` (credited
    to the innermost span) and ``span_device_incl_s`` and
    ``span_idle_incl_s`` (credited to every open span of the stack that
    took the credit, so a span's entry holds its children's too)."""
    span_s: Dict[str, float] = {}
    span_n: Dict[str, int] = {}
    for _, s, e, name in spans:
        _add(span_s, name, (e - s) * 1e-6)
        span_n[name] = span_n.get(name, 0) + 1
    where = _Locator(spans)
    dev: Dict[str, float] = {}
    dev_incl: Dict[str, float] = {}
    idle: Dict[str, float] = {}
    idle_incl: Dict[str, float] = {}

    def book(corr, t: Optional[float], secs: float, out, incl):
        launch = launches.get(corr)
        stack = where.stack(launch[0], launch[1] if t is None else t) \
            if launch is not None else ()
        _add(out, stack[-1][1] if stack else NONE, secs)
        for name in {n for _, n in stack} or (NONE,):
            _add(incl, name, secs)

    cur_e = None
    for corr, s, e in sorted(device_ops, key=lambda x: (x[1], x[2])):
        if cur_e is not None and s - cur_e >= gap_min_us:
            book(corr, 0.5 * (cur_e + s), (s - cur_e) * 1e-6, idle,
                 idle_incl)
        s0 = s if cur_e is None else max(s, cur_e)
        if e > s0:              # only the part no earlier operation covers
            book(corr, None, (e - s0) * 1e-6, dev, dev_incl)
        cur_e = e if cur_e is None else max(cur_e, e)
    return {"span_s": span_s, "span_n": span_n, "span_device_s": dev,
            "span_idle_s": idle, "span_device_incl_s": dev_incl,
            "span_idle_incl_s": idle_incl}


def profile_events(prof) -> Tuple[List[Span], Dict[object, Launch],
                                  List[DeviceOp]]:
    """The tuples of :func:`credit` from a finished ``torch.profiler``
    profile (CUDA activity; device copies of host annotations left out, as
    ``trace._raw_events`` leaves them)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    spans: List[Span] = []
    launches: Dict[object, Launch] = {}
    ops: List[DeviceOp] = []
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns() * 1e-3
        e = s + ev.duration_ns() * 1e-3
        name = ev.name()
        if ev.device_type() == cuda:
            if not ev.is_user_annotation():
                ops.append((ev.correlation_id(), s, e))
        elif name.startswith(PREFIX):
            spans.append((ev.start_thread_id(), s, e, name))
        elif name.startswith("cu"):         # runtime and driver API calls
            launches[ev.correlation_id()] = (ev.start_thread_id(), s)
    return spans, launches, ops


def summarize(prof) -> Dict[str, Dict[str, float]]:
    from xvbench import trace
    return credit(*profile_events(prof), gap_min_us=trace.GAP_MIN_US)


def _share(part: float, whole: float) -> Optional[float]:
    return 100.0 * part / whole if whole > 0 else None


def readings(collected: Mapping) -> Dict[str, float]:
    """The span readings of a run's ``collected`` (traces that carry
    :func:`credit`'s keys; the extractor's counters over the traced call
    under ``work["trace_counters"]``), the mean over the ranks' traces; a
    reading the run holds nothing for is left out."""
    out: Dict[str, List[float]] = {}
    counters = collected.get("work", {}).get("trace_counters") or {}
    for t in collected.get("traces") or []:
        if "span_device_s" not in t:
            continue
        dev, dev_in = t["span_device_s"], t["span_device_incl_s"]
        idle, idle_in = t["span_idle_s"], t["span_idle_incl_s"]
        busy, idle_all = t["busy_s"], sum(idle.values())
        found = {
            "device_credited_share": _share(busy - dev.get(NONE, 0.0), busy),
            "idle_credited_share": _share(idle_all - idle.get(NONE, 0.0),
                                          idle_all),
        }
        if "xv.extract.run" in t["span_s"]:
            found.update({
                "extract_idle_preprocess_share": _share(
                    idle_in.get("xv.extract.preprocess", 0.0), idle_all),
                "extract_cmvn_device_share": _share(
                    dev_in.get("xv.extract.cmvn", 0.0), busy),
                "extract_pack_share": _share(
                    t["span_s"].get("xv.extract.pack", 0.0), t["window_s"]),
                "extract_pooling_device_share": _share(
                    dev_in.get("xv.extract.pooling", 0.0)
                    + dev_in.get("xv.extract.embedding", 0.0), busy)})
        if "xv.train.optimizer" in t["span_s"]:
            n = t["span_n"]["xv.train.optimizer"]
            found.update({
                "train_optimizer_ms": 1e3 * t["span_s"]["xv.train.optimizer"]
                / n,
                "train_idle_dispatch_share": _share(
                    idle_in.get("xv.train.dispatch", 0.0), idle_all)})
        for k, v in found.items():
            if v is not None:
                out.setdefault(k, []).append(v)
    result = {k: sum(v) / len(v) for k, v in out.items()}
    if counters.get("frames_padded"):
        result["extract_padding_share"] = 100.0 * (
            1.0 - counters["frames_real"] / counters["frames_padded"])
    return result


def _rates(collected: Mapping) -> Dict[str, float]:
    """Frames per second of the untraced window and of the traced part
    (rows x frames a minibatch in training, real chunk frames in
    extraction): their ratio is what tracing costs, the profiler's own
    cost and the spans' together."""
    h, w = collected.get("host", {}), collected.get("work", {})
    traces = collected.get("traces") or []
    if not traces or not h.get("wall_s"):
        return {}
    if "minibatches" in w:
        window = sum(r * t for r, t in w["minibatches"])
        traced = sum(r * t for r, t in collected["trace_minibatches"][0])
    else:
        window, traced = w["real_frames"], w["trace_real_frames"]
    out = {"window_frames_per_s": window / h["wall_s"],
           "traced_frames_per_s": traced / traces[0]["window_s"]}
    out["traced_over_window"] = (out["traced_frames_per_s"]
                                 / out["window_frames_per_s"])
    return out


@contextlib.contextmanager
def instrumented():
    """Within: every ``trace.Tracer`` summary carries :func:`credit`'s keys,
    the extractors' counters over the traced call go into the collected
    work (``trace_counters``), and every result object carries ``spans``
    (the credit of each trace, the counters and :func:`readings`)."""
    from xvbench import harness, trace
    from xvector_tpu_torch.extract import extractor

    extractors: list = []
    counted: Dict[str, int] = {}
    made = extractor.XvectorExtractor.__init__
    tracer, line = trace.Tracer, harness.result_line

    def tracked(self, *a, **k):
        made(self, *a, **k)
        extractors.append(self)

    class SpanTracer(tracer):
        def start(self):
            # a program without counters reads none
            self._c0 = [dict(getattr(x, "counters", {})) for x in extractors]
            super().start()

        def stop(self):
            super().stop()
            counted.clear()
            for x, c0 in zip(extractors, self._c0):
                for k, v in getattr(x, "counters", {}).items():
                    counted[k] = counted.get(k, 0) + v - c0.get(k, 0)

        def summary(self, roles):
            out = super().summary(roles)
            out.update(summarize(self.prof))
            return out

    def with_spans(ctx, collected, *a, **k):
        result = line(ctx, collected, *a, **k)
        traces = collected.get("traces") or []
        spans = {"counters": dict(counted), "readings": readings(dict(
            collected, work=dict(collected.get("work", {}),
                                 trace_counters=dict(counted))))}
        for key in ("span_s", "span_n", "span_device_s", "span_idle_s",
                    "span_device_incl_s", "span_idle_incl_s"):
            spans[key] = [t[key] for t in traces if key in t]
        spans["rates"] = _rates(collected)
        result["spans"] = spans
        return result

    extractor.XvectorExtractor.__init__ = tracked
    trace.Tracer, harness.result_line = SpanTracer, with_spans
    try:
        yield
    finally:
        extractor.XvectorExtractor.__init__ = made
        trace.Tracer, harness.result_line = tracer, line


def main(argv: Optional[List[str]] = None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    if sys.path and os.path.abspath(sys.path[0] or ".") == here:
        sys.path[0] = root
    elif root not in sys.path:
        sys.path.insert(0, root)
    from xvbench import run
    args = list(sys.argv[1:] if argv is None else argv)
    with instrumented():
        return run.main(args + ["--trace", "1"])


if __name__ == "__main__":
    sys.exit(main())
