#!/usr/bin/env python3
"""Readings of the output check's control and planted faults, per seed.

    python3 xvbench/control.py --workload <name> --seeds 1,2,3

The control is the reference put in the program's place and computed a
precision step below the configuration's (bf16 -> fp8, ``reference/lowp``):
the same inputs, the same checked steps or utterances, compared with the
float32 reference by the numbers the cell's check compares.  Training cells
also read the faults planted in the reference: half of each minibatch left
out (the mean over the rest) and, on several ranks, the gradient exchange
left out (the first rank's rows' share of the loss only).  A state left
unchanged reads 1 by ``step_gap``'s definition and needs no run.  Prints
one JSON line per seed and reading, with ``correct`` as the cell's own
verdict (``harness.verdict`` against ``limits/<cell>.json``) gives it: a
control or a fault that the check catches reads false.  The benchmark's
own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def readings(ctx, seed: int, dev):
    """{reading name: {number: value}} of one seed."""
    import numpy as np
    from xvbench import generate
    from xvbench.reference import lowp, tdnn as ref
    ctx.seed = seed
    if ctx.traffic["driver"] == "train_egs":
        from xvbench.drivers import train_egs as T
        lengths = generate.archive_lengths(ctx.traffic, seed)
        base = T.reference_readings(ctx, dev, lengths)
        out = {"control_fp8": T.compare(
            T.reference_readings(ctx, dev, lengths, lowp.Fp8), base)}
        rows = ctx.traffic["rows"]
        out["half_batch"] = T.compare(
            T.reference_readings(ctx, dev, lengths, rows=rows // 2), base)
        ranks = int(ctx.traffic.get("ranks", 1))
        if ranks > 1:
            out["no_exchange"] = T.compare(T.reference_readings(
                ctx, dev, lengths, share_rows=rows // ranks), base)
        return out
    from xvbench.drivers import extract_feats as E
    pool = generate.extraction_pool(ctx.traffic, ctx.cfg, seed, dev)
    rng = np.random.default_rng(generate.derive(seed, "check"))
    sample = set(rng.choice(len(pool), ctx.traffic["check_utterances"],
                            replace=False).tolist())
    sample.add(int(np.argmax([len(f) for f, _ in pool])))
    base = E.reference_xvectors(ctx, dev, pool, sample)
    low = E.reference_xvectors(ctx, dev, pool, sample, lowp.Fp8)
    return {"control_fp8": {"xv_gap": max(
        ref.rel_gap(low[j], base[j]) for j in sample)}}


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    if sys.path and os.path.abspath(sys.path[0] or ".") == here:
        sys.path[0] = root
    import torch
    from xvbench import harness
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    args.seed, args.seconds, args.trace = 0, 0, 0
    ctx = harness.make_context(args, root, time.time())
    dev = torch.device(args.device)
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            for name, numbers in readings(ctx, seed, dev).items():
                # judged by the cell's own comparison and limits
                checks = harness.verdict(numbers, ctx.limits)
                print(json.dumps({"workload": ctx.workload, "seed": seed,
                                  "reading": name, **numbers,
                                  "correct": harness.correct(checks)}),
                      flush=True)
            print(f"seed {seed}: {time.perf_counter() - t0:.1f} s",
                  file=sys.stderr)
    finally:
        harness.cleanup(ctx)
    return 0


if __name__ == "__main__":
    sys.exit(main())
