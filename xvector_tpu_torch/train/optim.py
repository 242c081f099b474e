"""Optimizers of the trainer: the port's counterpart of optax plus
``xvector_tpu/train/tf_adam.py``.

* ``adam``: ``torch.optim.Adam``, whose update ``-lr · m̂ / (√v̂ + ε)`` places
  ε as ``optax.adam`` does (Algorithm 1 of Kingma & Ba);
* ``tf_adam``: :class:`TfAdam`, TF1's ``tf.train.AdamOptimizer`` placement,
  ``-lr·√(1-β₂ᵗ)/(1-β₁ᵗ) · m / (√v + ε)``;
* ``sgd``: ``torch.optim.SGD(momentum=…)``, which matches
  ``optax.sgd(momentum=…)`` (dampening 0, no Nesterov);
* ``adam`` with ``moments_dtype="bfloat16"``: :class:`Bf16MomentAdam`,
  ``optax.adam(mu_dtype=bfloat16)``: the first moment is stored in bf16,
  the second in f32.

Each works over the leaves of the port's parameter tree and updates them
in place.  The learning rate is set before every step with
:func:`set_learning_rate`, as ``optax.inject_hyperparams`` does.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

__all__ = ["TfAdam", "Bf16MomentAdam", "make_optimizer",
           "set_learning_rate"]


class TfAdam(torch.optim.Optimizer):
    """Adam with TF1 ``tf.train.AdamOptimizer`` update semantics (defaults
    are TF's):

        m_t = b1·m + (1-b1)·g;  v_t = b2·v + (1-b2)·g²
        lr_t = lr · sqrt(1 - b2^t) / (1 - b1^t)
        θ  -= lr_t · m_t / (sqrt(v_t) + eps)
    """

    def __init__(self, params: Iterable[torch.Tensor], lr: float = 1e-3,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("TfAdam takes no closure")
        for group in self.param_groups:
            b1, b2, eps = group["b1"], group["b2"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["m"] = torch.zeros_like(p)
                    st["v"] = torch.zeros_like(p)
                st["step"] += 1
                t = st["step"]
                m, v, g = st["m"], st["v"], p.grad
                m.mul_(b1).add_(g, alpha=1.0 - b1)
                v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                lr_t = group["lr"] * (1.0 - b2 ** t) ** 0.5 / (1.0 - b1 ** t)
                p.addcdiv_(m, v.sqrt().add_(eps), value=-lr_t)


class Bf16MomentAdam(torch.optim.Optimizer):
    """``optax.adam(mu_dtype=bfloat16)``, step for step:

        mu_t  = (1-b1)·g + bf16(b1·mu)       (f32; mu is stored in bf16)
        nu_t  = (1-b2)·g² + b2·nu            (f32)
        θ    += -lr · (mu_t/(1-b1ᵗ)) / (sqrt(nu_t/(1-b2ᵗ)) + eps)
        mu    = bf16(mu_t)

    The update reads the f32 first moment before it is rounded for
    storage.  The decay meets the bf16 moment as a bf16 number and the
    product is rounded to bf16, as a Python float times a bf16 array is in
    JAX; the bias corrections are computed in f32."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float = 1e-3,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Bf16MomentAdam takes no closure")
        for group in self.param_groups:
            b1, b2, eps = group["b1"], group["b2"], group["eps"]
            b1_bf16 = float(torch.tensor(b1, dtype=torch.bfloat16))
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["mu"] = torch.zeros_like(p, dtype=torch.bfloat16)
                    st["nu"] = torch.zeros_like(p)
                st["step"] += 1
                t = np.float32(st["step"])
                g = p.grad
                # a restored state may hold mu in f32 (load_state_dict casts
                # to the parameter's dtype): its values are bf16 all the same
                decayed = (st["mu"].float() * b1_bf16).to(torch.bfloat16)
                mu = (1.0 - b1) * g + decayed
                nu = (1.0 - b2) * (g * g) + b2 * st["nu"]
                mu_hat = mu / float(np.float32(1) - np.float32(b1) ** t)
                nu_hat = nu / float(np.float32(1) - np.float32(b2) ** t)
                p.add_(mu_hat / (nu_hat.sqrt() + eps) * -group["lr"])
                st["mu"] = mu.to(torch.bfloat16)
                st["nu"] = nu


def make_optimizer(name: str, params: Iterable[torch.Tensor], lr: float,
                   momentum: float = 0.5,
                   moments_dtype: str = "float32") -> torch.optim.Optimizer:
    """The trainer's optimizer ``name`` (adam | tf_adam | sgd) over
    ``params``, starting at learning rate ``lr``."""
    params = list(params)
    if name == "adam":
        if moments_dtype == "bfloat16":
            return Bf16MomentAdam(params, lr=lr)
        if moments_dtype != "float32":
            raise ValueError(f"unknown adam_moments_dtype {moments_dtype!r}")
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if name == "tf_adam":
        return TfAdam(params, lr=lr)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=momentum)
    raise ValueError(f"unknown optimizer {name!r}")


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float):
    for group in optimizer.param_groups:
        group["lr"] = lr
