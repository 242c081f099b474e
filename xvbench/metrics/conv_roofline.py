"""K2-K4's share of their roofline in the traced part: the least time of
the wide layers' forward, weight- and input-gradient convolutions at the
shapes each rank ran (``work.conv_least_time``), over the device time of
the kernels the role tables give those roles, summed over ranks."""

from xvbench import work


def read(c):
    traces, mbs = c.get("traces") or [], c.get("trace_minibatches") or []
    least = sum(work.conv_least_time(c["cfg"], m) for m in mbs)
    spent = sum(t["role_s"].get(r, 0.0) for t in traces
                for r in work.CONV_ROLES)
    return work.roofline(least, spent)
