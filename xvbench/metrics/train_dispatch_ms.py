"""Host milliseconds per minibatch in the block step's dispatch
(``StepTimer``'s ``dispatch``: upload calls and the eager step's launches),
rank 0's on several ranks."""


def read(c):
    h = c.get("host", {})
    if "dispatch_s" not in h or not h.get("minibatches"):
        return None
    return 1e3 * h["dispatch_s"] / h["minibatches"]
