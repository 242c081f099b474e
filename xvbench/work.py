"""Work of the x-vector model per role and per run, from shapes alone.

The benchmark's yardstick for rooflines and model utilisation.  Every
count comes from the configuration's widths and the cell's shapes, never
from a kernel, so it reads the same whatever implements the layer.

Peaks are one NVIDIA H100 SXM's published dense rates at its full power
limit: 989 TFLOP/s in bf16 and 3.35 TB/s of HBM.  A role's least time is
the larger of its operations over the peak rate and its bytes over the
peak bandwidth, each input byte read once and each output byte written
once.

Roles:

* ``conv_fwd``, ``conv_dw``, ``conv_dx``: the forward, weight-gradient and
  input-gradient convolutions of the training step's wide layers (k > 1 and
  k·Cin > 160), bf16 operands; the weight gradient is written in f32.
* ``frame_stack_fwd``: every layer of the eval frame stack over the real
  (unpadded) frames; layer 0 reads the f32 features, the last layer writes
  f32, the others read and write bf16.  Its weights count once per layer
  per window (a lower bound: how often a batch re-reads them is the
  program's choice).
"""

from __future__ import annotations

from typing import Iterable, List, Mapping, Tuple

PEAK_FLOPS = 989e12       # bf16 dense, H100 SXM
PEAK_BYTES = 3.35e12      # HBM3, H100 SXM
FRAME_SECONDS = 0.01      # 10 ms frame shift

CONV_ROLES = ("conv_fwd", "conv_dw", "conv_dx")


def frame_layers(cfg: Mapping) -> List[Tuple[int, int, int, int]]:
    """(k, Cin, Cout, dilation) of each frame layer of a configuration."""
    out, cin = [], cfg["feat_dim"]
    for k, d, c in zip(cfg["kernel_sizes"], cfg["dilations"],
                       cfg["channels"]):
        out.append((k, cin, c, d))
        cin = c
    return out


def stack_macs_per_frame(cfg: Mapping) -> int:
    """Multiply-accumulates of the frame stack per frame."""
    return sum(k * cin * cout for k, cin, cout, _ in frame_layers(cfg))


def head_macs_per_row(cfg: Mapping, classes: bool = True) -> int:
    """Multiply-accumulates per row after pooling: the embedding layers and,
    with ``classes``, the softmax head."""
    dims = [2 * cfg["channels"][-1], *cfg["embed_dims"]]
    if classes:
        dims.append(cfg["num_targets"])
    return sum(a * b for a, b in zip(dims, dims[1:]))


def wide_layers(cfg: Mapping) -> List[Tuple[int, int, int, int]]:
    """The training step's convolution layers that K2-K4 serve."""
    return [l for l in frame_layers(cfg) if l[0] > 1 and l[0] * l[1] > 160]


def least_time(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def conv_least_time(cfg: Mapping, minibatches: Iterable[Tuple[int, int]]
                    ) -> float:
    """Least seconds of K2-K4's work over (rows, frames) minibatches: the
    sum, over calls, of each call's own bound."""
    total = 0.0
    for rows, frames in minibatches:
        n = rows * frames
        for k, cin, cout, _ in wide_layers(cfg):
            flops = 2.0 * n * k * cin * cout
            x, y, w = 2.0 * n * cin, 2.0 * n * cout, 2.0 * k * cin * cout
            total += (least_time(flops, x + w + y)
                      + least_time(flops, x + y + 2.0 * w)
                      + least_time(flops, y + w + x))
    return total


def stack_least_time(cfg: Mapping, real_frames: float) -> float:
    """Least seconds of the eval frame stack over ``real_frames`` frames."""
    layers = frame_layers(cfg)
    total = 0.0
    for i, (k, cin, cout, _) in enumerate(layers):
        in_b = 4.0 if i == 0 else 2.0
        out_b = 4.0 if i == len(layers) - 1 else 2.0
        flops = 2.0 * real_frames * k * cin * cout
        nbytes = real_frames * (in_b * cin + out_b * cout) + 2.0 * k * cin * cout
        total += least_time(flops, nbytes)
    return total


def train_flops(cfg: Mapping, minibatches: Iterable[Tuple[int, int]]
                ) -> float:
    """Model FLOPs of forward and backward over (rows, frames) minibatches:
    every matrix product three times (forward, input and weight gradient)
    but layer 0's input gradient, which no parameter needs; no
    recomputation; elementwise work not counted."""
    k0, f, c0, _ = frame_layers(cfg)[0]
    stack, head = stack_macs_per_frame(cfg), head_macs_per_row(cfg)
    total = 0.0
    for rows, frames in minibatches:
        total += 2.0 * (rows * frames * (3 * stack - k0 * f * c0)
                        + rows * 3 * head)
    return total


def extract_flops(cfg: Mapping, real_frames: float, chunks: float) -> float:
    """FLOPs of extraction: the frame stack and stats pooling (sum and sum
    of squares, 3 per value) over the real frames, the embedding layer
    once per chunk."""
    pool = 3.0 * cfg["channels"][-1]
    embed = 2.0 * 2 * cfg["channels"][-1] * cfg["embed_dims"][0]
    return (real_frames * (2.0 * stack_macs_per_frame(cfg) + pool)
            + chunks * embed)


def roofline(least: float, spent: float):
    """Percent of ``least`` seconds over ``spent`` device seconds; None when
    no kernel of the role ran (a role with no kernel reads as missing,
    never as infinite)."""
    if spent <= 0.0 or least <= 0.0:
        return None
    return 100.0 * least / spent
