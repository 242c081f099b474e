"""The control: the reference with its matrix products in a lower precision.

The configurations state bf16 operands, so the control is the step below:
fp8.  Every operand of a matrix product (activations and weights) is rounded
to e4m3 and every gradient that flows into a product's output to e5m2, each
with a per-tensor scale that maps its largest magnitude to the format's
largest finite value (the usual fp8 recipe); the products themselves run in
float32.
"""

from __future__ import annotations

import torch

E4M3, E4M3_MAX = torch.float8_e4m3fn, 448.0
E5M2, E5M2_MAX = torch.float8_e5m2, 57344.0


def round_to(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().to(torch.float32).clamp(min=1e-30)
    scale = top / amax
    return ((x.to(torch.float32) * scale).to(dtype).to(torch.float32)
            / scale).to(x.dtype)


class _Operand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return round_to(x, E4M3, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return g


class _Grad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return round_to(g, E5M2, E5M2_MAX)


class Fp8:
    """``operand(x)``: x rounded to e4m3 (identity backward);
    ``grad(y)``: y unchanged, its gradient rounded to e5m2."""

    name = "fp8"

    @staticmethod
    def operand(x):
        return _Operand.apply(x)

    @staticmethod
    def grad(y):
        return _Grad.apply(y)
