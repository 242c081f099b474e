"""Extraction batch-shape sweep on one NVIDIA GPU: embeddings/s and
audio-s/s of the serving forward (bf16, ``no_dropout``) at 11 (batch,
frames) shapes, through the fused frame stack (K1) that
``XvectorExtractor`` runs and, beside it, the unfused stack.

    python -m xvector_tpu_torch.bench.extract_sweep [--out PATH]

The twin of the JAX package's ``tools/bench_extract_sweep.py``, over its
shapes.  Each shape is timed by CUDA events (``iters`` back-to-back calls
per round after a warm-up, ``rounds`` rounds; the value is the median
round).  Each row prints as one JSON line tagged with the card; the rows
and the card go to ``--out`` (default ``docs/extract_sweep_h100.json``).
The extractor's batch and bucket defaults are left as they are: the rows
are the evidence for choosing them.  Without a card it exits 1."""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict

import torch

from .. import resolve_device
from . import headline as H
from .common import card, card_line, cuda_ms, require_card, spread

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(REPO, "docs", "extract_sweep_h100.json")

# (batch, frames), tools/bench_extract_sweep.py:52-54
SHAPES = ((16, 1024), (32, 1024), (64, 1024), (128, 1024), (256, 1024),
          (32, 512), (64, 512), (128, 512), (256, 512), (128, 2048),
          (64, 2048))


def measure(b: int, t: int, rounds: int = 4, iters: int = 80,
            device="cuda", seed: int = 0, model=None) -> Dict:
    """One row: fused and unfused embeddings/s and audio-s/s of a (b, t)
    batch (``model``: (cfg, params, state) to reuse, else drawn from
    ``seed``), with the fused/unfused x-vectors' minimum cosine."""
    dev = resolve_device(device)
    cfg, params, state = model or H.extract_model(dev, seed)
    xn, mn = H.extract_inputs(b, t)
    x, mask = torch.from_numpy(xn).to(dev), torch.from_numpy(mn).to(dev)
    row = {"batch": b, "frames": t}
    vecs = {}
    for fused, name in ((True, "fused"), (False, "unfused")):
        ex = H.extractor(cfg, params, state, dev, fused)
        vecs[fused] = H.extract_batch(ex, x, mask)
        ms = [cuda_ms(lambda: H.extract_batch(ex, x, mask), iters)
              for _ in range(rounds)]
        emb = spread([b * 1e3 / m for m in ms], max)
        row[f"{name}_emb_per_s"] = emb["median"]
        row[f"{name}_audio_s_per_s"] = emb["median"] * t * H.FRAME_SHIFT_S
        row[f"{name}_spread"] = emb
    row["min_cosine"] = H.min_cosine(vecs[True], vecs[False])
    return row


def sweep(rounds: int = 4, iters: int = 80, device="cuda", seed: int = 0,
          shapes=SHAPES, tag: str = "") -> Dict:
    """Every shape's row, printed as it is measured; raises
    :class:`~.common.CheckFailed` if a shape's fused x-vectors leave the
    cosine bound of the unfused ones."""
    dev = resolve_device(device)
    model = H.extract_model(dev, seed)
    rows = []
    for b, t in shapes:
        row = measure(b, t, rounds, iters, dev, seed, model)
        print(json.dumps(row) + (f" [{tag}]" if tag else ""), flush=True)
        if not row["min_cosine"] >= H.COSINE_BOUND:
            raise H.CheckFailed(f"extract_sweep {b}x{t}: fused vs unfused "
                                f"min cosine {row['min_cosine']}")
        rows.append(row)
    return {"rows": rows, "rounds": rounds, "iters": iters, "seed": seed}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    require_card("bench.extract_sweep")
    try:
        out = sweep(tag=card_line())
    except H.CheckFailed as exc:
        print(f"bench.extract_sweep: check failed: {exc}", file=sys.stderr)
        return 1
    out["device"] = card()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
