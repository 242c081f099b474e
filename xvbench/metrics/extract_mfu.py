"""FLOPs of the window's extraction (frame stack and stats pooling over the
real voiced frames, the embedding once per chunk; ``work.extract_flops``)
over its wall time times one chip's bf16 peak, in percent."""

from xvbench import work


def read(c):
    h, w = c.get("host", {}), c.get("work", {})
    if not w.get("real_frames") or not h.get("wall_s"):
        return None
    return 100.0 * work.extract_flops(c["cfg"], w["real_frames"],
                                      w["chunks"]) / (
        h["wall_s"] * work.PEAK_FLOPS)
