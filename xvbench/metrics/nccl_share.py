"""Share of each rank's traced part spent in NCCL's kernels (the role
tables' ``nccl``), in percent, the mean over the ranks."""


def read(c):
    traces = [t for t in c.get("traces") or [] if t["window_s"] > 0]
    if len(traces) < 2:
        return None
    return sum(100.0 * t["role_s"].get("nccl", 0.0) / t["window_s"]
               for t in traces) / len(traces)
