"""Model FLOPs of the window's training (forward and backward over the real
frames, no recomputation; ``work.train_flops``) over its wall time times
the chips' bf16 peak, in percent."""

from xvbench import work


def read(c):
    h, mbs = c.get("host", {}), c.get("work", {}).get("minibatches")
    if not mbs or not h.get("wall_s"):
        return None
    return 100.0 * work.train_flops(c["cfg"], mbs) / (
        h["wall_s"] * c["chips"] * work.PEAK_FLOPS)
