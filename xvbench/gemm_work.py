"""Work of the training step's matrix products on cuBLAS, from shapes alone.

The yardstick of ``train_gemm_roofline``: the products the port hands to
cuBLAS in a train step (``models/tdnn.py`` ``_conv1d_same``'s ``dense`` and
``unfold`` routes, and ``_affine``), counted from the configuration's
widths and the minibatches' (rows, frames), as ``work.train_flops`` counts
them:

* layer 0, unfolded (k·F ≤ 160): forward and weight gradient, no input
  gradient (no parameter needs it);
* every k = 1 frame layer: forward, input and weight gradient;
* the two segment layers and the softmax head: the same three.

A product A (m × k) @ B (k × n) reads A and B and writes C once; its
input- and weight-gradient products read and write the same three
matrices, transposed, so all three have one bound.  Frame layers run in
bf16 (2 bytes an element), the segment layers and the head in f32 (4
bytes; ``_affine`` accumulates in f32).  Each call's bound is
``work.least_time``, on the bf16 peak whatever the dtype.  Not counted:
the batch-norm fold's small products after each block.
"""

from __future__ import annotations

from typing import Iterable, List, Mapping, Tuple

from xvbench import work


def products(cfg: Mapping, rows: int, frames: int
             ) -> List[Tuple[int, int, int, int, int]]:
    """(m, k, n, bytes an element, calls) of one minibatch's products:
    each forward product with the number of its direction products."""
    n = rows * frames
    out = []
    for i, (k, cin, cout, _) in enumerate(work.frame_layers(cfg)):
        if k == 1:
            out.append((n, cin, cout, 2, 3))
        elif k * cin <= 160:
            out.append((n, k * cin, cout, 2, 2 if i == 0 else 3))
    dims = [2 * cfg["channels"][-1], *cfg["embed_dims"], cfg["num_targets"]]
    for a, b in zip(dims, dims[1:]):
        out.append((rows, a, b, 4, 3))
    return out


def least_time(cfg: Mapping, minibatches: Iterable[Tuple[int, int]]
               ) -> float:
    """Least seconds of the products over (rows, frames) minibatches: the
    sum, over calls, of each call's own bound."""
    total = 0.0
    for rows, frames in minibatches:
        for m, k, n, size, calls in products(cfg, rows, frames):
            total += calls * work.least_time(
                2.0 * m * k * n, size * (m * k + k * n + m * n))
    return total
