"""Every audio-second trained in the window (rows x true frames x 10 ms,
all minibatches) over the window's wall time, closed by the iteration's
synchronise: the training rate, on the host's clock."""

from xvbench import work


def read(c):
    h, mbs = c.get("host", {}), c.get("work", {}).get("minibatches")
    if not mbs or not h.get("wall_s"):
        return None
    return sum(r * t for r, t in mbs) * work.FRAME_SECONDS / h["wall_s"]
