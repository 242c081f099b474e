#!/usr/bin/env python3
"""Run one cell of the port's benchmark and print its result line.

    python3 xvbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``xvector_tpu_torch``.  The cell
(``BENCHMARK.json``'s ``workloads``) names its configuration, traffic and
chips; the traffic names the driver (``xvbench/drivers/``) that makes the
inputs from the seed, warms up, measures for ``--seconds`` and checks what
the timed path produced.  Without as many CUDA cards as the cell asks for,
or without the program beside it, it prints no result and exits non-zero.
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys


def _pin_cards(chips: int) -> None:
    """Keep the run to the first ``chips`` visible cards (an empty
    ``CUDA_VISIBLE_DEVICES`` stays empty: no card)."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = ([str(i) for i in range(chips)] if visible is None
           else [i for i in visible.split(",") if i.strip()])
    os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(ids[:chips])


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    if sys.path and os.path.abspath(sys.path[0] or ".") == here:
        sys.path[0] = root
    elif root not in sys.path:
        sys.path.insert(0, root)
    from xvbench import harness
    t_start = harness.process_start_epoch()

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0:
        p.error("--seed takes a whole number >= 0")
    if not os.path.isdir(os.path.join(root, "xvector_tpu_torch")):
        print(f"xvbench: no xvector_tpu_torch beside {here}; the benchmark "
              "measures that program", file=sys.stderr)
        return 2

    ctx = harness.make_context(args, root, t_start)
    try:
        # build and kernel caches live in the checkout, at fixed paths
        cache = os.path.join(here, ".cache")
        os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
        os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
        _pin_cards(ctx.chips)
        import torch
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < ctx.chips):
            print(f"xvbench: {ctx.workload} needs {ctx.chips} CUDA card(s); "
                  f"torch.cuda.is_available() is "
                  f"{torch.cuda.is_available()}, device_count() "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 3
        driver = importlib.import_module(
            "xvbench.drivers." + ctx.traffic["driver"])
        result = driver.run(ctx)
    finally:
        harness.cleanup(ctx)
    if result is None:            # a rank other than the one that reports
        return 0
    return harness.print_result(result)


if __name__ == "__main__":
    sys.exit(main())
