"""Auxiliary NN building blocks.

Counterpart of ``xvector_tpu/models/blocks.py``, completing the reference's
``tf_block.py`` surface beyond what the model zoo uses: ``selu``
(tf_block.py:31-36), ``zrelu`` — the two-slope parametric ReLU with
trainable positive/negative gains (tf_block.py:50-56) — and
``flip_gradient``, the gradient-reversal identity behind the (unused)
adversarial hook (tf_block.py:59-77).  PReLU and the batch-norm wrapper
live in ``models/tdnn.py``.
"""

from __future__ import annotations

import torch

__all__ = ["selu", "zrelu", "flip_gradient"]

_SELU_ALPHA = 1.6732632423543772848170429916717
_SELU_SCALE = 1.0507009873554804934193349852946


def selu(x: torch.Tensor) -> torch.Tensor:
    """scale·(x if x≥0 else α·(eˣ−1)) with the canonical SELU constants."""
    return _SELU_SCALE * torch.where(x >= 0.0, x,
                                     _SELU_ALPHA * torch.expm1(x))


def zrelu(x: torch.Tensor, alpha1: torch.Tensor, alpha2: torch.Tensor
          ) -> torch.Tensor:
    """α₁·max(0,x) + α₂·min(0,x) with trainable scalar gains (init 1, 0.1
    in the reference).  ``maximum``/``minimum`` split the gradient at x = 0
    as JAX's do."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return alpha1 * torch.maximum(zero, x) + alpha2 * torch.minimum(zero, x)


class _FlipGradient(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.scale * g, None


def flip_gradient(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Identity forward, −scale·g backward (domain-adversarial training)."""
    return _FlipGradient.apply(x, scale)
