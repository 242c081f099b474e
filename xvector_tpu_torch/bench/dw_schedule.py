"""Time K3 v2 (``csrc/conv_sm90.cu``) under every schedule it can take on
one NVIDIA GPU: tile width bn in (256, 128) and cluster size S in 1..8,
at the training shapes (64x304 frames, 512 -> 512 channels, k=5 and 7).

    python -m xvector_tpu_torch.bench.dw_schedule

Each line gives the ms per call (CUDA events over 20 calls after 3
warm-up calls), the blocks and waves of the grid, the error against the
plain version, and whether ``ops/conv_bwd.dw_schedule`` picks it; the
last line is a JSON object of all of them with the card's name and power
limit.  It exits non-zero without a card."""

from __future__ import annotations

import json
import sys

import torch

from ..ops import conv_bwd as CB
from .common import card_line, cuda_ms

B, T, C = 64, 304, 512


def main() -> int:
    if not torch.cuda.is_available():
        print("dw_schedule: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = card_line()
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clusters = CB.dw_max_clusters(dev)
    print("max active clusters (bn, S): " + ", ".join(
        f"{key}: {n}" for key, n in sorted(clusters.items())) + f" [{card}]")
    picked = CB.dw_schedule
    rows = []
    try:
        for k in (5, 7):
            gen = torch.Generator().manual_seed(k)
            x = torch.randn(B, T, C, generator=gen).to(dev, torch.bfloat16)
            g = torch.randn(B, T, C, generator=gen).to(dev, torch.bfloat16)
            want = CB.conv_dw_reference(x, g, k, 1)
            choice = picked(k, C, C, B, T, clusters)
            steps = len(CB.dw_stages(B, T))
            for bn in CB.DW_BNS:
                for s in range(1, CB.DW_MAX_SPLITS + 1):
                    CB.dw_schedule = lambda *a, _c=(bn, s): _c
                    err = float((CB.conv_dw(x, g, k, 1) - want).abs().max()
                                / want.abs().max())
                    ms = cuda_ms(lambda: CB.conv_dw(x, g, k, 1))
                    tiles = k * -(-C // CB.DW_BM) * -(-C // bn)
                    blocks = tiles * s
                    waves = tiles / clusters[(bn, s)]
                    rows.append({"k": k, "bn": bn, "splits": s, "ms": ms,
                                 "blocks": blocks, "waves": waves,
                                 "stages_per_block": -(-steps // s),
                                 "normalised_err": err,
                                 "picked": (bn, s) == choice})
                    print(f"K3 v2 k={k} bn={bn} S={s}: {ms:.4f} ms, "
                          f"{blocks} blocks = {waves:.2f} waves, "
                          f"{-(-steps // s)} stages per block, normalised "
                          f"error {err:.3g}"
                          + (" (dw_schedule's pick)" if (bn, s) == choice
                             else "") + f" [{card}]")
    finally:
        CB.dw_schedule = picked
    print(json.dumps({"card": card, "sms": sms, "rows": rows,
                      "max_clusters": {f"{bn}x{s}": n for (bn, s), n
                                       in sorted(clusters.items())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
