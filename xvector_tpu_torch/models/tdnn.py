"""TDNN x-vector model zoo — PyTorch port.

Counterpart of ``xvector_tpu/models/tdnn.py``: the same config dataclass
and presets, the same parameter tree (``{"frame": [...], "embed": [...],
"output": {...}}`` with ``(K, Cin, Cout)`` conv weights) and the same
numerics: conv1d(SAME) + bias → activation → batch norm (batch moments in
train mode, population statistics folded to one affine in eval mode) →
frame mask, masked stats or self-attentive pooling, the embed-0
pre-activation readout, the classifier head and the L2 term
(:func:`apply`), and the closed-form EMA fold of per-step batch moments
(:func:`fold_bn_state`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..ops import conv_bwd
from ..parallel import mesh as meshlib
from ..utils.profiling import span, tracing
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


def _masked_moments(x, mask, axes, centered: bool = False, group=None):
    """Mean and variance over ``axes``, ignoring positions where
    mask == 0.  Products run in x's dtype; the sums accumulate in f32 (f64
    for f64 input).  ``mask`` broadcasts against x with a trailing feature
    dim of 1.  The variance is E[x²]−mean², or with ``centered`` the mean
    of (x−mean)²: one elementwise pass more, but free of the cancellation
    that makes autograd through E[x²]−mean² lose most digits of the input
    gradient in f32 (the train-mode batch norm takes it).

    ``group`` (a process group, see ``parallel/mesh.py``) makes the moments
    global over its ranks' rows, the counterpart of the JAX package's
    ``axis_name``: the masked sums and counts are all-reduced (the
    centred variance takes a second all-reduce, of Σ(x−mean)²), and the
    backward all-reduces their gradients, since each rank's loss is its
    rows' share of the objective."""
    acc = _acc_dtype(x.dtype)
    if mask is None:
        m = None
        count = math.prod(x.shape[a] for a in axes)
        if group is not None:
            count = torch.tensor(float(count), dtype=acc, device=x.device)
    else:
        m = mask.to(x.dtype)
        count = mask.to(acc).sum(axes)

    def wsum(v):
        return (v if m is None else v * m).sum(axes, dtype=acc)

    def global_sums(*sums):
        """The sums and the count, all-reduced in one buffer."""
        parts = [*sums, count]
        flat = meshlib.all_reduce_sum(torch.cat([p.reshape(-1) for p in parts]),
                                   group)
        out, i = [], 0
        for p in parts:
            out.append(flat[i:i + p.numel()].view(p.shape))
            i += p.numel()
        return out

    if group is None:
        n = count if m is None else count.clamp(min=1.0)
        mean = wsum(x) / n
        if not centered:
            return mean, wsum(x.square()) / n - mean.square()
    elif centered:
        s1, n = global_sums(wsum(x))
        n = n.clamp(min=1.0)
        mean = s1 / n
    else:
        s1, s2, n = global_sums(wsum(x), wsum(x.square()))
        n = n.clamp(min=1.0)
        mean = s1 / n
        return mean, s2 / n - mean.square()
    mean_k = mean.to(x.dtype)
    for a in sorted(axes):
        mean_k = mean_k.unsqueeze(a)
    return mean, meshlib.all_reduce_sum(wsum((x - mean_k).square()), group) / n


def _batch_norm(x, bn_p, bn_s, mask, train: bool, cfg: TdnnConfig,
                stats_out: bool = False, group=None):
    """tf_block.batch_norm_wrapper semantics: train → batch moments (masked)
    and an EMA update of the population statistics; eval → population
    statistics.  ``stats_out=True`` (train only) returns the raw batch
    moments in place of the EMA'd state, for :func:`fold_bn_state`; the
    normalisation is the same either way.  (mean, var, γ, β) fold into one
    per-channel affine computed in f32 and applied in x's dtype.  ``group``
    makes the train-mode moments global (:func:`_masked_moments`)."""
    if train:
        mean, var = _masked_moments(x, mask, tuple(range(x.dim() - 1)),
                                    centered=True, group=group)
        if stats_out:
            new_s = {"mean": mean, "var": var}
        else:
            new_s = {"mean": bn_s["mean"] * cfg.bn_decay
                     + mean * (1 - cfg.bn_decay),
                     "var": bn_s["var"] * cfg.bn_decay
                     + var * (1 - cfg.bn_decay)}
    else:
        mean, var = bn_s["mean"], bn_s["var"]
        new_s = bn_s
    inv = torch.rsqrt(var + cfg.bn_eps)
    a = (inv * bn_p["gamma"]).to(x.dtype)
    b = (bn_p["beta"] - mean * inv * bn_p["gamma"]).to(x.dtype)
    return x * a + b, new_s


def fold_bn_state(state0: State, stacked: State, decay: float) -> State:
    """Fold N stacked per-step batch moments (leaves (N, C)) into the EMA
    population statistics: s_N = decay^N s_0 + (1-decay) Σ_i
    decay^(N-1-i) b_i, the result of applying the EMA update N times."""
    def fold(s0, bs):
        n = bs.shape[0]
        i = torch.arange(n, dtype=torch.float32, device=bs.device)
        w = (1.0 - decay) * torch.pow(decay, n - 1 - i)
        return decay ** n * s0 + torch.tensordot(w.to(bs.dtype), bs, dims=1)

    return {part: [{key: fold(s0[key], bs[key]) for key in s0}
                   for s0, bs in zip(state0[part], stacked[part])]
            for part in state0}


# Calls of each route of :func:`_conv1d_same` so far, the counterpart of
# ``ops/conv_bwd.route_launches``; the tests zero and read them.
route_calls = {"unfold": 0, "dense": 0, "fused": 0, "shifted": 0}


def conv_route(x_shape, w_shape, dilation: int, dtype,
               fused_bwd: bool = False) -> str:
    """The route :func:`_conv1d_same` takes for x (B, T, Cin) ⊛ w (K, Cin,
    Cout) in ``dtype``: ``"dense"`` (k = 1, one matmul), ``"unfold"``
    (k·Cin ≤ 160, the MFCC front layer unfolded into one matmul),
    ``"fused"`` (``fused_bwd``, a wide layer the kernels of
    ``ops/conv_bwd`` take: K2-K4) or ``"shifted"`` (k shifted matmuls)."""
    k, cin, _ = w_shape
    if k == 1:
        return "dense"
    if k * cin <= 160:
        return "unfold"
    if fused_bwd and conv_bwd.supports(x_shape, w_shape, dilation, dtype):
        return "fused"
    return "shifted"


def _conv1d_same(x, w, dilation: int, fused_bwd: bool = False):
    """(B, T, Cin) ⊛ (K, Cin, Cout) → (B, T, Cout), SAME padding, in the
    weight dtype, by the route :func:`conv_route` names (counted in
    :data:`route_calls`).

    ``fused_bwd`` sends a wide k > 1 layer (k·Cin > 160) in bf16 to
    ``ops/conv_bwd.conv1d_same_fused_bwd``: the hand-written forward and
    backward kernels on the card, their plain versions on the CPU.  A
    tensor the kernels refuse there raises; it never goes elsewhere.  In
    any other dtype (an f32 step) the layer takes the shifted matmuls:
    the kernels take bf16 operands only."""
    k, cin, cout = w.shape
    x = x.to(w.dtype)
    t = x.shape[1]
    route = conv_route(x.shape, w.shape, dilation, w.dtype, fused_bwd)
    route_calls[route] += 1
    if route == "dense":
        return x @ w[0]
    if route == "fused":
        return conv_bwd.conv1d_same_fused_bwd(x.contiguous(), w.contiguous(),
                                              dilation)
    left = (k - 1) // 2 * dilation
    xp = F.pad(x, (0, 0, left, (k - 1) * dilation - left))
    if route == "unfold":
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


def attention_pooling(h, att: Params, mask=None, eps: float = VAR2STD_EPSILON):
    """Self-attentive pooling (models.py:1039-1051): split the channels in
    two, scores from the first half, attention-weighted mean ‖ std of the
    second.  ``mask`` is (B, T, 1); masked frames score -1e30.

    The operands are rounded to h's dtype and every product runs in f32
    (f64 for f64 input), the JAX package's bf16 operands with
    ``preferred_element_type`` accumulation: a bf16 product is exact in
    f32, so only the order of the sums differs.  The softmax runs in f32
    and the variance is E[x²] − mean², not centred."""
    half = h.shape[-1] // 2
    acc = _acc_dtype(h.dtype)

    def rounded(t):
        return t.to(h.dtype).to(acc)

    h1, h2 = h[..., :half].to(acc), h[..., half:].to(acc)
    pre = h1 @ rounded(att["w"]) + att["b"]
    scores = rounded(torch.tanh(pre)) @ rounded(att["v"])      # (B, T)
    if mask is not None:
        scores = torch.where(mask[..., 0] > 0, scores,
                             torch.full_like(scores, -1e30))
    a = rounded(torch.softmax(scores, dim=1))
    mean = torch.einsum("btc,bt->bc", h2, a)
    ex2 = torch.einsum("btc,bt->bc", h2.square(), a)
    var = ex2 - mean.square()
    return torch.cat([mean, torch.sqrt(var.clamp(min=0.0) + eps)], dim=-1)


def _pool(cfg: TdnnConfig, params: Params, h, m):
    if cfg.pooling == "attention":
        return attention_pooling(h, params["attention"], m)
    return stats_pooling(h, m)


# ---------------------------------------------------------------------------
# Forward pass
# ---------------------------------------------------------------------------

def apply(cfg: TdnnConfig, params: Params, state: State, x, *, mask=None,
          row_weight=None, train: bool = False, dropout_keep: float = 1.0,
          generator: Optional[torch.Generator] = None,
          compute_dtype=torch.float32, bn_stats_out: bool = False,
          skip_head: bool = False,
          fused_conv_bwd: bool = False, group=None,
          head_group=None) -> Dict[str, Any]:
    """Forward pass, train or eval.

    x is (B, T, feat_dim); ``mask`` an optional (B, T) 1/0 frame mask;
    ``row_weight`` an optional (B,) 1/0 row validity, whose zero rows are
    left out of the batch-norm statistics.  Dropout (``cfg.use_dropout``
    and ``train``) draws from ``generator``, whose bits differ from
    ``jax.random``'s.  ``fused_conv_bwd`` routes the wide conv layers to
    ``ops/conv_bwd`` (see :func:`_conv1d_same`).  ``group`` (the data
    group of a mesh) makes the train-mode batch-norm moments global over
    its ranks' rows; ``head_group`` (the model group) sums the L2 term of
    a head whose columns are split over its ranks, with an identity
    backward.  Each frame layer (conv, bias, activation, batch norm, mask)
    is the span ``xv.model.frame``, whose args name the layer's index, k,
    dilation and :func:`conv_route`.

    Returns ``logits`` (B, num_classes) or None with ``skip_head``,
    ``xvector`` (the embed-0 pre-activation), ``hidden``, ``pooled``,
    ``l2_loss`` (already β-scaled) and ``state`` (the new BN state, or the
    raw batch moments with ``bn_stats_out``)."""
    m = None if mask is None else mask.to(torch.float32)[..., None]
    rw = (None if row_weight is None
          else row_weight.to(torch.float32)[:, None])
    if rw is not None:
        m = rw[..., None] if m is None else m * rw[..., None]
    new_state: State = {"frame": [], "embed": []}
    h = x.to(compute_dtype)

    def dropout(h):
        if not (cfg.use_dropout and train):
            return h
        if generator is None:
            raise ValueError("dropout requires a generator")
        keep = torch.rand(h.shape, generator=generator,
                          device=h.device) < dropout_keep
        return torch.where(keep, h / dropout_keep, torch.zeros_like(h))

    if m is not None:
        h = h * m.to(h.dtype)        # zero pad frames (SAME-style padding)
    traced = tracing()
    for i, layer in enumerate(params["frame"]):
        d = cfg.dilations[i]
        args = None
        if traced:
            route = conv_route(h.shape, layer["w"].shape, d, compute_dtype,
                               fused_conv_bwd)
            args = (f"layer={i} k={layer['w'].shape[0]} dilation={d} "
                    f"route={route}")
        with span("xv.model.frame", args):
            h = _conv1d_same(h, layer["w"].to(compute_dtype), d,
                             fused_bwd=fused_conv_bwd
                             ) + layer["b"].to(compute_dtype)
            h = _activate(cfg, layer, h)
            h, bn_s = _batch_norm(h, layer["bn"], state["frame"][i], m,
                                  train, cfg, stats_out=bn_stats_out,
                                  group=group)
            if m is not None:
                h = h * m.to(h.dtype)    # keep pad positions zero
        new_state["frame"].append(bn_s)
        if i != cfg.num_frame_layers - 1:
            h = dropout(h)

    pooled = _pool(cfg, params, h, m)
    acc = _acc_dtype(compute_dtype)
    l2 = torch.zeros((), dtype=acc, device=x.device)
    h = pooled
    xvector = None
    for i, layer in enumerate(params["embed"]):
        pre = _affine(h, layer["w"], layer["b"], compute_dtype)
        if i == 0:
            xvector = pre.to(acc)
        if cfg.l2_beta > 0.0:
            scale = 0.1 if i == 0 else 1.0     # models.py:811-817
            l2 = l2 + scale * 0.5 * (layer["w"].square().sum()
                                     + layer["b"].square().sum())
        h = _activate(cfg, layer, pre)
        h, bn_s = _batch_norm(h, layer["bn"], state["embed"][i], rw, train,
                              cfg, stats_out=bn_stats_out, group=group)
        new_state["embed"].append(bn_s)
        if i != len(cfg.embed_dims) - 1:
            h = dropout(h)

    out = params["output"]
    logits = (None if skip_head
              else _affine(h, out["w"], out["b"], compute_dtype))
    if cfg.l2_beta > 0.0:
        l2 = l2 + meshlib.reduce_from_group(
            0.5 * (out["w"].square().sum() + out["b"].square().sum()),
            head_group)
    return {
        "logits": None if logits is None else logits.to(acc),
        "xvector": xvector,
        "hidden": h.to(acc),
        "pooled": pooled,
        "l2_loss": cfg.l2_beta * l2,
        "state": new_state,
    }


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
        h, _ = _batch_norm(h, layer["bn"], state["frame"][i], m, False, cfg)
        if m is not None:
            h = h * m.to(h.dtype)
    return h


def extract_xvector(cfg: TdnnConfig, params: Params, state: State, x,
                    mask=None, compute_dtype=torch.float32):
    """Embedding-only forward (no classifier head) for extraction:
    (B, T, F) features and optional (B, T) mask → (B, embed_dims[0]) f32."""
    m = None if mask is None else mask.to(torch.float32)[..., None]
    h = frame_stack(cfg, params, state, x, mask, compute_dtype)
    pooled = _pool(cfg, params, h, m)
    e0 = params["embed"][0]
    return _affine(pooled, e0["w"], e0["b"],
                   compute_dtype).to(torch.float32)
