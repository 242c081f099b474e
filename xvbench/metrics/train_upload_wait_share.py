"""Share of the window's wall time in which ``train_one_iteration`` waited
for its worker thread's next stacked block (``StepTimer``'s
``upload_wait``), in percent."""


def read(c):
    h = c.get("host", {})
    if "upload_wait_s" not in h or not h.get("wall_s"):
        return None
    return 100.0 * h["upload_wait_s"] / h["wall_s"]
