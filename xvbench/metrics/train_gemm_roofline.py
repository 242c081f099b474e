"""The dense layers' share of their roofline in the traced part: the least
time of the train step's cuBLAS products (layer 0 unfolded, the k = 1
frame layers, the segment layers and the head; ``gemm_work.least_time``) at
the shapes each rank ran, over the device time of the kernels the role
tables call ``gemm``, summed over ranks."""

from xvbench import gemm_work, work


def read(c):
    traces, mbs = c.get("traces") or [], c.get("trace_minibatches") or []
    least = sum(gemm_work.least_time(c["cfg"], m) for m in mbs)
    spent = sum(t["role_s"].get("gemm", 0.0) for t in traces)
    return work.roofline(least, spent)
