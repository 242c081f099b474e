"""Share of the window's wall time spent in ``preprocess`` (upload, sliding
CMVN, download, voiced-frame selection), by the benchmark's host clock
around each call, in percent."""


def read(c):
    h = c.get("host", {})
    if "preprocess_s" not in h or not h.get("wall_s"):
        return None
    return 100.0 * h["preprocess_s"] / h["wall_s"]
