"""Share of the traced part in which no operation ran on the device, in
percent, the mean over the ranks' traces."""


def read(c):
    traces = [t for t in c.get("traces") or [] if t["window_s"] > 0]
    if not traces or not any(t["busy_s"] > 0 for t in traces):
        return None
    return sum(100.0 * (1.0 - t["busy_s"] / t["window_s"])
               for t in traces) / len(traces)
