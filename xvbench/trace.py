"""The traced part of a run: ``torch.profiler`` over CPU and CUDA activity,
reduced to the device's busy time, seconds per kernel and per role, and the
device's idle gaps with what the host was doing in each.

The traced part starts and ends with a ``torch.cuda.synchronize()``, so that
it holds the device work of exactly the calls made inside it.
"""

from __future__ import annotations

import bisect
import glob
import json
import os
import re
import time
from typing import Dict, List, Mapping, Optional, Tuple

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
GAP_MIN_US = 20.0


def load_roles(directory: str = os.path.join(HERE, "kernels")
               ) -> List[Tuple["re.Pattern", str]]:
    """Every role table under ``kernels/``, merged in file-name order:
    [(compiled pattern, role)]."""
    out = []
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(path) as f:
            for entry in json.load(f)["roles"]:
                out.append((re.compile(entry["pattern"]), entry["role"]))
    return out


def role_of(name: str, roles) -> str:
    for pattern, role in roles:
        if pattern.search(name):
            return role
    return "other"


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Tracer:
    """Start, stop and reduce one profiled stretch of a run."""

    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None
        self.t0 = self.t1 = 0.0

    def start(self):
        """Start tracing; ``t0`` is when tracing began (a profiler's first
        start can take seconds, which the traced part leaves out)."""
        _sync(self.device)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self):
        _sync(self.device)
        self.t1 = time.perf_counter()
        self.prof.stop()

    def summary(self, roles) -> Dict[str, object]:
        """``window_s``, ``busy_s`` (the union of device activity),
        ``kernel_s`` (seconds per kernel name), ``role_s``, and the
        ``idle_gaps`` [(host activity, seconds)] summed by what the host
        was doing at each gap's midpoint."""
        dev, host = [], []
        for is_dev, s, e, name in _raw_events(self.prof):
            if is_dev:
                dev.append((s, e, name))
            elif e > s:
                host.append((s, e, name))
        dev.sort()
        kernel_s: Dict[str, float] = {}
        busy, gaps = 0.0, []
        cur_s = cur_e = None
        for s, e, name in dev:
            kernel_s[name] = kernel_s.get(name, 0.0) + (e - s) * 1e-6
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                    if s - cur_e >= GAP_MIN_US:
                        gaps.append((cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        role_s: Dict[str, float] = {}
        for name, secs in kernel_s.items():
            r = role_of(name, roles)
            role_s[r] = role_s.get(r, 0.0) + secs
        return {"window_s": self.t1 - self.t0, "busy_s": busy * 1e-6,
                "kernel_s": kernel_s, "role_s": role_s,
                "idle_gaps": _attribute(gaps, host)}


def _raw_events(prof):
    """(on the device, start us, end us, name) of every profiled event;
    the device's copies of host annotations are left out."""
    cuda = torch.autograd.DeviceType.CUDA
    for ev in prof.profiler.kineto_results.events():
        is_dev = ev.device_type() == cuda
        if is_dev and getattr(ev, "is_user_annotation", lambda: False)():
            continue
        if hasattr(ev, "start_ns"):
            s, d = ev.start_ns() * 1e-3, ev.duration_ns() * 1e-3
        else:
            s, d = float(ev.start_us()), float(ev.duration_us())
        yield is_dev, s, s + d, ev.name()


def _attribute(gaps, host) -> List[Tuple[str, float]]:
    """Sum each device gap's seconds under the innermost host event that
    covers its midpoint ("host, between traced ops" where none does:
    Python or other untraced host work)."""
    host.sort()
    starts = [h[0] for h in host]
    totals: Dict[str, float] = {}
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        best: Optional[Tuple[float, str]] = None
        i = bisect.bisect_right(starts, mid)
        # of nested events the inner one starts last: the first covering
        # event met going back is the innermost (within a bounded look)
        for s, e, name in reversed(host[max(0, i - 200):i]):
            if e >= mid:
                best = (e - s, name)
                break
        key = best[1] if best else "host, between traced ops"
        totals[key] = totals.get(key, 0.0) + (g1 - g0) * 1e-6
    return sorted(totals.items(), key=lambda kv: -kv[1])


def breakdown(summary: Mapping) -> Dict[str, list]:
    """The ten device operations that took most time and the ten host
    activities under which the device sat idle longest."""
    ops = sorted(summary["kernel_s"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in summary["idle_gaps"][:10]]}
