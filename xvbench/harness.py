"""What every cell shares: finding a cell's files by name, the run's
context, the per-layer readers, the correctness verdict and the result
line.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix.  The configuration is ``configs/<config>.json``, the traffic
``traffic/<traffic>.json`` (which names its driver, ``drivers/<driver>.py``),
the limits of the output check ``limits/<cell>.json``, and each per-layer
metric ``metrics/<metric>.py`` (a ``read(collected)`` that returns a number,
or None when the run holds nothing to read).  Kernel role tables are every
``kernels/*.json``.  Nothing here names a cell.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "xvector_tpu")


def process_start_epoch() -> float:
    """This process's start, in seconds since the epoch (Linux)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(root, "BENCHMARK.json")


def cell(bench: Mapping, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"xvbench: no workload {name!r} in BENCHMARK.json")


def cell_metrics(bench: Mapping, name: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that cell ``name``
    reports: those that list it, and those that list no cells."""
    return [m for m in bench[kind]
            if name in m.get("workloads", [name])]


def load_reader(metric: str, directory: str = os.path.join(HERE, "metrics")
                ) -> Callable:
    """``metrics/<metric>.py``'s ``read``, loaded by path (a metric's name
    may hold dots)."""
    path = os.path.join(directory, metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "xvbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def check_preset(cfg: Mapping, zoo_cfg) -> None:
    """Refuse to run when the program's preset has other widths than the
    configuration file states."""
    for key in ("feat_dim", "kernel_sizes", "dilations", "channels",
                "embed_dims", "activation", "pooling"):
        have = getattr(zoo_cfg, key)
        want = cfg[key]
        if (list(have) if isinstance(have, tuple) else have) != want:
            raise RuntimeError(f"preset {cfg['preset']!r}: {key} is {have!r}"
                               f" in the program, {want!r} in the "
                               "configuration file")


@dataclass
class Context:
    """One run of one cell."""
    workload: str
    seed: int
    seconds: float
    trace: bool
    cell: dict
    cfg: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    t_start: float                    # process start (the launcher's)
    device: object = None             # torch.device, set by the driver
    work_dir: str = ""
    owns_work_dir: bool = False

    @property
    def chips(self) -> int:
        return int(self.cell["chips"])


def make_context(args, root: str = ROOT, t_start: Optional[float] = None
                 ) -> Context:
    bench = benchmark(root)
    c = cell(bench, args.workload)
    cfg = load_json(HERE, "configs", c["config"] + ".json")
    traffic = load_json(HERE, "traffic", c["traffic"] + ".json")
    limits = load_json(HERE, "limits", c["name"] + ".json")
    work = os.environ.get("XVBENCH_WORK")
    owns = work is None
    if owns:
        work = tempfile.mkdtemp(prefix="xvbench_")
    t0 = os.environ.get("XVBENCH_T0")
    return Context(
        workload=c["name"], seed=args.seed, seconds=float(args.seconds),
        trace=bool(args.trace), cell=c, cfg=cfg, traffic=traffic,
        limits=limits,
        end_to_end=cell_metrics(bench, c["name"], "end_to_end"),
        per_layer=cell_metrics(bench, c["name"], "per_layer"),
        t_start=(float(t0) if t0 else
                 t_start if t_start is not None else process_start_epoch()),
        work_dir=work, owns_work_dir=owns)


def cleanup(ctx: Context) -> None:
    if ctx.owns_work_dir:
        shutil.rmtree(ctx.work_dir, ignore_errors=True)


class Phases:
    """Host seconds of the named stages of a run's set-up, printed to
    standard error (what a later change to set-up would shorten)."""

    def __init__(self):
        self.t = time.perf_counter()
        self.done: List[tuple] = []

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.done.append((name, now - self.t))
        self.t = now

    def report(self) -> None:
        print("setup " + " ".join(f"{n}={s:.3f}" for n, s in self.done),
              file=sys.stderr)


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def verdict(numbers: Mapping[str, float], limits: Mapping[str, float]
            ) -> Dict[str, Dict[str, float]]:
    """Each number that has a limit, beside it (one not worked out, or not
    finite, reads as infinite); the others go to standard error as
    readings."""
    for name, value in numbers.items():
        if name not in limits:
            print(f"reading {name} {float(value)!r} (not compared)",
                  file=sys.stderr)
    out = {}
    for name, limit in limits.items():
        v = float(numbers.get(name, float("inf")))
        out[name] = {"value": v if math.isfinite(v) else float("inf"),
                     "limit": float(limit)}
    return out


def correct(checks: Mapping[str, Mapping[str, float]]) -> bool:
    return bool(checks) and all(
        c["limit"] >= 0 and c["value"] <= c["limit"] for c in checks.values())


def result_line(ctx: Context, collected: Mapping, checks: Mapping,
                attempted: int, failed: int, device: Mapping,
                e2e: Mapping[str, float]) -> Dict:
    """The result object: with ``--trace 0`` the cell's end-to-end metrics,
    with ``--trace 1`` its per-layer metrics (read by ``metrics/*.py``;
    one that finds nothing is left out) and the breakdown."""
    metrics: Dict[str, Dict] = {}
    if ctx.trace:
        for m in ctx.per_layer:
            value = load_reader(m["name"])(collected)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in ctx.end_to_end:
            metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                  "unit": m["unit"]}
    out = {"correct": correct(checks) and failed == 0,
           "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": dict(device)}
    if ctx.trace and collected.get("breakdown"):
        out["breakdown"] = collected["breakdown"]
    out["checks"] = dict(checks)
    return out


def print_result(result: Mapping) -> int:
    """Print the checks as the last lines of standard error and the result
    as the last line of standard output; refuse (non-zero, no result) when
    a forbidden module is loaded in this process."""
    bad = forbidden_modules()
    if bad:
        print("xvbench: forbidden modules loaded: " + ", ".join(bad),
              file=sys.stderr)
        return 4
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
