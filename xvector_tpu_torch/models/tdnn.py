"""TDNN x-vector model zoo — eval-mode PyTorch port.

Counterpart of ``xvector_tpu/models/tdnn.py``: the same config dataclass
and presets, the same parameter tree (``{"frame": [...], "embed": [...],
"output": {...}}`` with ``(K, Cin, Cout)`` conv weights) and the same
numerics for the extraction forward: conv1d(SAME) + bias → activation →
batch-norm folded to one affine → frame mask, masked stats pooling, and
the embed-0 pre-activation readout.

Train-mode ``apply``, ``attention_pooling`` and ``fold_bn_state`` are not
ported yet; ``extract_xvector`` raises on an attention-pooling config.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from .. import resolve_device
from .convert import tree_map

VAR2STD_EPSILON = 1e-5
BN_EPSILON = 1e-3
BN_DECAY = 0.95

Params = Dict[str, Any]
State = Dict[str, Any]


# ---------------------------------------------------------------------------
# Config + zoo (own copy of the JAX package's presets)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TdnnConfig:
    name: str = "no_dropout"
    feat_dim: int = 23
    kernel_sizes: Tuple[int, ...] = (5, 5, 7, 1, 1)
    dilations: Tuple[int, ...] = (1, 1, 1, 1, 1)
    channels: Tuple[int, ...] = (512, 512, 512, 512, 1536)
    embed_dims: Tuple[int, ...] = (512, 512)
    activation: str = "relu"          # relu | prelu | lrelu
    lrelu_alpha: float = 0.2
    use_dropout: bool = False
    l2_beta: float = 0.0
    pooling: str = "stats"            # stats | attention
    init: str = "trunc_normal"        # trunc_normal | he
    bn_decay: float = BN_DECAY
    bn_eps: float = BN_EPSILON

    @property
    def num_frame_layers(self) -> int:
        return len(self.kernel_sizes)

    @property
    def pooled_dim(self) -> int:
        if self.pooling == "attention":
            return self.channels[-1]
        return 2 * self.channels[-1]

    @property
    def xvector_dim(self) -> int:
        return self.embed_dims[0]

    @property
    def receptive_field(self) -> int:
        return 1 + sum((k - 1) * d
                       for k, d in zip(self.kernel_sizes, self.dilations))


MODEL_ZOO: Dict[str, TdnnConfig] = {
    "base": TdnnConfig(name="base", use_dropout=True),
    "no_dropout": TdnnConfig(name="no_dropout"),
    "tdnn_dilated": TdnnConfig(
        name="tdnn_dilated", kernel_sizes=(5, 3, 3, 1, 1),
        dilations=(1, 2, 3, 1, 1)),
    "prelu": TdnnConfig(name="prelu", activation="prelu"),
    "l2_prelu": TdnnConfig(name="l2_prelu", activation="prelu",
                           l2_beta=2e-4),
    "l2_lrelu": TdnnConfig(name="l2_lrelu", activation="lrelu",
                           l2_beta=2e-4),
    "l2_lrelu_attention": TdnnConfig(
        name="l2_lrelu_attention", activation="lrelu", l2_beta=2e-4,
        channels=(512, 512, 512, 512, 6 * 512), pooling="attention"),
    "l2_relu_he": TdnnConfig(name="l2_relu_he", l2_beta=2e-4, init="he"),
    # Extended TDNN (Snyder et al. 2019): dilated TDNN layers interleaved
    # with dense k=1 layers, 1500-channel pre-pooling layer.
    "etdnn": TdnnConfig(
        name="etdnn",
        kernel_sizes=(5, 1, 3, 1, 3, 1, 3, 1, 1, 1),
        dilations=(1, 1, 2, 1, 3, 1, 4, 1, 1, 1),
        channels=(512,) * 9 + (1500,)),
    # reduced-width config for CI / smoke runs
    "tiny": TdnnConfig(name="tiny", channels=(32, 32, 32, 32, 96),
                       embed_dims=(64, 64)),
}

# Reference TF class name → preset (``--tf-model-class`` spellings).
REFERENCE_CLASS_TO_PRESET = {
    "Model": "base",
    "ModelWithoutDropout": "no_dropout",
    "ModelWithoutDropoutTdnn": "tdnn_dilated",
    "ModelWithoutDropoutPRelu": "prelu",
    "ModelL2LossWithoutDropoutPRelu": "l2_prelu",
    "ModelL2LossWithoutDropoutLRelu": "l2_lrelu",
    "ModelL2LossWithoutDropoutLReluAttention": "l2_lrelu_attention",
    "ModelL2LossWithoutDropoutReluHeInit": "l2_relu_he",
}


# ---------------------------------------------------------------------------
# Initialisation
# ---------------------------------------------------------------------------

def init_params(generator: torch.Generator, cfg: TdnnConfig,
                num_classes: int, device="cuda") -> Tuple[Params, State]:
    """Build (params, bn_state) trees for a topology preset.

    Same shapes and distributions as the JAX package (truncated normal at
    ±2σ, Xavier-uniform head, He init for ``init="he"``); the numbers come
    from ``generator``, a CPU ``torch.Generator``, and differ from
    ``jax.random``'s.  Tensors are drawn on the CPU and moved to
    ``device``."""
    dev = resolve_device(device)

    def trunc_normal(shape, std):
        t = torch.empty(shape)
        torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                    generator=generator)
        return t

    def uniform(shape, limit):
        return torch.empty(shape).uniform_(-limit, limit,
                                           generator=generator)

    def bn(dim):
        return ({"gamma": torch.ones(dim), "beta": torch.zeros(dim)},
                {"mean": torch.zeros(dim), "var": torch.ones(dim)})

    def act_params(dim):
        if cfg.activation == "prelu":
            return {"alpha": torch.full((dim,), 0.1)}
        return {}

    params: Params = {"frame": [], "embed": []}
    state: State = {"frame": [], "embed": []}
    prev = cfg.feat_dim
    for k, ch in zip(cfg.kernel_sizes, cfg.channels):
        if cfg.init == "he":
            fan_in = k * prev
            w = trunc_normal((k, prev, ch), math.sqrt(2.0 / fan_in))
            b = uniform((ch,), math.sqrt(6.0 / fan_in))
        else:
            w = trunc_normal((k, prev, ch), 0.1)
            b = torch.full((ch,), 0.1)
        bn_p, bn_s = bn(ch)
        params["frame"].append({"w": w, "b": b, "bn": bn_p,
                                **act_params(ch)})
        state["frame"].append(bn_s)
        prev = ch

    if cfg.pooling == "attention":
        half = cfg.channels[-1] // 2
        params["attention"] = {"w": trunc_normal((half, half), 0.1),
                               "b": torch.full((half,), 0.1),
                               "v": torch.full((half,), 0.1)}

    prev = cfg.pooled_dim
    for dim in cfg.embed_dims:
        if cfg.init == "he":
            w = trunc_normal((prev, dim), math.sqrt(2.0 / prev))
            b = uniform((dim,), math.sqrt(6.0 / prev))
        else:
            w = trunc_normal((prev, dim), 0.1)
            b = torch.full((dim,), 0.1)
        bn_p, bn_s = bn(dim)
        params["embed"].append({"w": w, "b": b, "bn": bn_p,
                                **act_params(dim)})
        state["embed"].append(bn_s)
        prev = dim

    limit = math.sqrt(6.0 / (prev + num_classes))
    params["output"] = {"w": uniform((prev, num_classes), limit),
                        "b": torch.full((num_classes,), 0.1)}
    return tree_map(lambda t: t.to(dev), params), \
        tree_map(lambda t: t.to(dev), state)


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """f32 accumulation, or f64 when the input already is f64."""
    return torch.promote_types(dtype, torch.float32)


def _activate(cfg: TdnnConfig, layer: Params, x):
    if cfg.activation == "relu":
        return torch.relu(x)
    if cfg.activation == "lrelu":
        return F.leaky_relu(x, cfg.lrelu_alpha)
    if cfg.activation == "prelu":
        alpha = layer["alpha"].to(x.dtype)
        return x.clamp(min=0.0) + alpha * x.clamp(max=0.0)
    raise ValueError(cfg.activation)


def _masked_moments(x, mask, axes):
    """Mean and variance over ``axes`` as E[x²]−mean², ignoring positions
    where mask == 0.  Products run in x's dtype; the sums accumulate in
    f32 (f64 for f64 input).  ``mask`` broadcasts against x with a trailing
    feature dim of 1."""
    acc = _acc_dtype(x.dtype)
    if mask is None:
        count = math.prod(x.shape[a] for a in axes)
        mean = x.sum(axes, dtype=acc) / count
        var = x.square().sum(axes, dtype=acc) / count - mean.square()
        return mean, var
    m = mask.to(x.dtype)
    count = mask.to(acc).sum(axes).clamp(min=1.0)
    mean = (x * m).sum(axes, dtype=acc) / count
    var = (x.square() * m).sum(axes, dtype=acc) / count - mean.square()
    return mean, var


def _batch_norm_eval(x, bn_p, bn_s, cfg: TdnnConfig):
    """Eval-mode batch norm folded into one per-channel affine computed in
    f32 and applied in x's dtype."""
    inv = torch.rsqrt(bn_s["var"] + cfg.bn_eps)
    a = (inv * bn_p["gamma"]).to(x.dtype)
    b = (bn_p["beta"] - bn_s["mean"] * inv * bn_p["gamma"]).to(x.dtype)
    return x * a + b


def _conv1d_same(x, w, dilation: int):
    """(B, T, Cin) ⊛ (K, Cin, Cout) → (B, T, Cout), SAME padding, in the
    weight dtype.  Narrow inputs (k·Cin ≤ 160, the MFCC front layer) are
    unfolded into one matmul; wider ones take k shifted matmuls."""
    k, cin, cout = w.shape
    x = x.to(w.dtype)
    t = x.shape[1]
    left = (k - 1) // 2 * dilation
    right = (k - 1) * dilation - left
    if k == 1:
        return x @ w[0]
    xp = F.pad(x, (0, 0, left, right))
    if k * cin <= 160:
        xu = torch.cat([xp[:, j * dilation: j * dilation + t]
                        for j in range(k)], dim=-1)
        return xu @ w.reshape(k * cin, cout)
    out = None
    for j in range(k):
        term = xp[:, j * dilation: j * dilation + t] @ w[j]
        out = term if out is None else out + term
    return out


def _affine(x, w, b, compute_dtype):
    """x @ w + b with operands rounded to ``compute_dtype`` and the
    products accumulated in f32 (or wider), like ``preferred_element_type``
    in the JAX package."""
    acc = _acc_dtype(compute_dtype)
    return (x.to(compute_dtype).to(acc) @ w.to(compute_dtype).to(acc)) + b


def stats_pooling(h, mask=None, eps: float = VAR2STD_EPSILON):
    """mean ‖ sqrt(var + eps) over the time axis, masked for padded
    frames.  ``mask`` is (B, T, 1)."""
    mean, var = _masked_moments(h.to(_acc_dtype(h.dtype)), mask, (1,))
    return torch.cat([mean, torch.sqrt(var.clamp(min=0.0) + eps)], dim=-1)


# ---------------------------------------------------------------------------
# Forward pass (eval)
# ---------------------------------------------------------------------------

def frame_stack(cfg: TdnnConfig, params: Params, state: State, x,
                mask=None, compute_dtype=torch.float32):
    """Eval-mode frame-level stack: (B, T, F) → (B, T, channels[-1]),
    masked.  The plain path beside ``ops/tdnn_kernel.fused_frame_stack``."""
    m = None if mask is None else mask.to(torch.float32)[..., None]
    h = x.to(compute_dtype)
    if m is not None:
        h = h * m.to(h.dtype)
    for i, layer in enumerate(params["frame"]):
        h = _conv1d_same(h, layer["w"].to(compute_dtype),
                         cfg.dilations[i]) + layer["b"].to(compute_dtype)
        h = _activate(cfg, layer, h)
        h = _batch_norm_eval(h, layer["bn"], state["frame"][i], cfg)
        if m is not None:
            h = h * m.to(h.dtype)
    return h


def extract_xvector(cfg: TdnnConfig, params: Params, state: State, x,
                    mask=None, compute_dtype=torch.float32):
    """Embedding-only forward (no classifier head) for extraction:
    (B, T, F) features and optional (B, T) mask → (B, embed_dims[0]) f32."""
    if cfg.pooling != "stats":
        raise NotImplementedError(
            f"pooling={cfg.pooling!r} is not ported yet")
    m = None if mask is None else mask.to(torch.float32)[..., None]
    h = frame_stack(cfg, params, state, x, mask, compute_dtype)
    pooled = stats_pooling(h, m)
    e0 = params["embed"][0]
    return _affine(pooled, e0["w"], e0["b"],
                   compute_dtype).to(torch.float32)
