"""K1's share of its roofline in the traced part: the least time of the
eval frame stack over the real (unpadded) chunk frames that part fed
(``work.stack_least_time``), over the device time of the kernels the role
tables call ``frame_stack_fwd``."""

from xvbench import work


def read(c):
    traces = c.get("traces") or []
    frames = c.get("work", {}).get("trace_real_frames", 0)
    least = work.stack_least_time(c["cfg"], frames) if frames else 0.0
    spent = sum(t["role_s"].get("frame_stack_fwd", 0.0) for t in traces)
    return work.roofline(least, spent)
