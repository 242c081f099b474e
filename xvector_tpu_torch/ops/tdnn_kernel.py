"""Fused TDNN frame stack (eval / extraction path): K1 on Hopper.

Counterpart of ``xvector_tpu/ops/tdnn_kernel.py``.  Each layer computes
conv1d(+dilation) with bf16 operands and f32 accumulation → bias →
activation → eval batch norm folded to ``y·scale + shift`` → frame mask;
the last layer's output is f32 (B, T, channels[-1]).

* :func:`fold_stack` folds the parameters once (batch norm into
  scale/shift, bf16 weights, channel counts zero-padded to multiples of 8,
  layer 0's weights packed for its kernel); :func:`fused_frame_stack`
  takes a :class:`FoldedStack` in place of ``(params, state)``;
* :func:`fused_frame_stack_reference` is the plain PyTorch version with
  exactly K1's numerics (the CPU path and the referee on the card), layer
  by layer (:func:`layer_reference`; layer 0 in its packed form,
  :func:`l0_reference`);
* :func:`fused_frame_stack` dispatches: CPU tensors take the plain version,
  CUDA tensors launch one hand-written kernel per layer, or raise;
  :func:`fused_layer` runs one layer the same way;
* :func:`layer_route` is the written rule that picks each layer's design:
  ``"l0_sm90"`` for layer 0 (``csrc/fwd_sm90.cu``'s layer-0 kernel: A
  built from the f32 features by producer warps, wgmma, TMA store) and
  ``"sm90"`` (K1 v5, ``csrc/fwd_sm90.cu``: the wgmma/TMA forward that K2
  v2 shares, with K1's epilogue) for every later layer.  ``"sm80"`` (K1
  v4, ``csrc/tdnn_stack.cu``: mma.sync, cp.async) runs a layer 0 that
  :func:`l0_takes` refuses (k·F beyond ~320), and every layer under
  ``design="sm80"``;
* :data:`launches` counts layer launches, :data:`route_launches` the same
  launches by design.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..models import tdnn
from . import _build
from .conv_bwd import _lib_fwd, _num_sms, _raise_on

__all__ = ["fused_frame_stack", "fused_frame_stack_reference", "supports",
           "layer_route", "launches", "route_launches", "fold_stack",
           "FoldedStack", "fused_layer", "layer_reference", "l0_reference",
           "l0_takes"]

SOURCE = "tdnn_stack.cu"
_ACT = {"relu": 0, "lrelu": 1, "prelu": 2}
# A block's shared memory and what the layer-0 kernel keeps there besides
# its A tiles, W stages, window and vectors: alignment, the two consumers'
# staging, the barriers (csrc/fwd_sm90.cu: L0_SMEM, l0_smem)
_L0_SMEM, _L0_FIXED = 232448, 1024 + 2 * 32768 + 8 * 16

# Kernel launches so far (one per layer), in all and by design;
# chip_smoke.py zeroes and reads them.
launches = 0
route_launches = {"l0_sm90": 0, "sm90": 0, "sm80": 0}


def supports(cfg: tdnn.TdnnConfig) -> bool:
    """Fused path covers the stats-pooling topologies (all activations);
    attention pooling's split head changes the output contract."""
    return cfg.pooling == "stats" and cfg.activation in ("relu", "lrelu",
                                                         "prelu")


def _halo(cfg: tdnn.TdnnConfig) -> int:
    return sum((k - 1) // 2 * d
               for k, d in zip(cfg.kernel_sizes, cfg.dilations))


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclass(frozen=True)
class FoldedStack:
    """K1's parameters as the kernels take them, made once by
    :func:`fold_stack`.  ``layers[l]`` is ``(w bf16 (k, Cin', Cout'), b,
    scale, shift, alpha or None)`` (f32 vectors of Cout'); ``w0`` is layer
    0's ``w`` as ``(kpad, Cout'_0)`` bf16 in (tap, channel) row order, rows
    ``k·F ..`` zero, ``kpad`` = k·F rounded up to 64.  With padding, Cout'
    is each Cout rounded up to 8 and Cin' the previous layer's Cout' (layer
    0: F): the padded columns carry exact zeros from layer to layer.
    ``out_dim`` is the stack's output width, channels[-1]."""
    layers: Tuple
    w0: torch.Tensor
    out_dim: int


def fold_stack(cfg: tdnn.TdnnConfig, params, state,
               pad: bool = True) -> FoldedStack:
    """Fold the eval batch norm (``scale = γ/√(var+ε)``, ``shift = β −
    mean·scale``, f32), round the weights to bf16 and, with ``pad``,
    zero-pad every channel count to a multiple of 8 (TMA's 16-byte
    strides): zero weights, bias, scale and shift make a padded column
    exactly 0 after every activation, and the next layer's zero rows ignore
    it.  Fold once per set of weights (an extractor does at construction)
    and pass the result to :func:`fused_frame_stack`; a fold made before
    the weights change is stale."""
    _check_supported(cfg)
    layers, cin_p = [], cfg.feat_dim
    for l, layer in enumerate(params["frame"]):
        bn_s = state["frame"][l]
        scale = layer["bn"]["gamma"] * torch.rsqrt(bn_s["var"] + cfg.bn_eps)
        shift = layer["bn"]["beta"] - bn_s["mean"] * scale
        cout = cfg.channels[l]
        cout_p = _round_up(cout, 8) if pad else cout
        w = layer["w"].to(torch.bfloat16)
        w = F.pad(w, (0, cout_p - cout, 0, cin_p - w.shape[1]))

        def vec(v):
            return F.pad(v.to(torch.float32), (0, cout_p - cout)).contiguous()

        alpha = vec(layer["alpha"]) if cfg.activation == "prelu" else None
        layers.append((w.contiguous(), vec(layer["b"]), vec(scale),
                       vec(shift), alpha))
        cin_p = cout_p
    w = layers[0][0]
    k0 = w.shape[0] * w.shape[1]
    w0 = F.pad(w.reshape(k0, w.shape[2]), (0, 0, 0, _round_up(k0, 64) - k0))
    return FoldedStack(tuple(layers), w0.contiguous(), cfg.channels[-1])


def _folded(cfg, params, state) -> FoldedStack:
    if isinstance(params, FoldedStack):
        return params
    return fold_stack(cfg, params, state)


def l0_takes(k: int, feat_dim: int, dilation: int = 1,
             cout: int = 512) -> bool:
    """Whether layer 0's kernel holds this layer in a block's shared memory:
    one A tile (128 rows × k·F rounded up to 64, bf16), the f32 window of
    features and mask its rows read (128 + (k−1)·d frames, in blocks of 256
    floats), the four f32 vectors of Cout rounded up to 128, and two W
    stages of 16 KB beside the fixed part; the same count as ``l0_smem`` in
    ``csrc/fwd_sm90.cu``.  At k = 5 and Cout 512 it takes F ≤ 64."""
    rows = 128 + (k - 1) * dilation
    window = (-(-rows * feat_dim // 256) + -(-rows // 256)) * 1024
    vecs = 16 * _round_up(cout, 128)
    return (_L0_FIXED + window + vecs + _round_up(k * feat_dim, 64) * 256
            + 2 * 16384 <= _L0_SMEM)


def layer_route(l: int, cin: int, cout: int, k: int = 1,
                dilation: int = 1) -> str:
    """The design that runs layer ``l`` (Cin → Cout, ``k`` taps) on the
    card: "l0_sm90" for layer 0, whose input is the f32 features (any F
    that :func:`l0_takes`; "sm80", K1 v4, beyond); "sm90" (K1 v5) for every
    later layer, at any channel counts, since the fold pads them to
    multiples of 8."""
    if l == 0:
        return "l0_sm90" if l0_takes(k, cin, dilation, cout) else "sm80"
    return "sm90"


def _layer_designs(cfg: tdnn.TdnnConfig, design=None):
    """Each layer's design: :func:`layer_route`'s, or ``design`` on every
    layer: "sm80" (K1 v4) takes every layer; "sm90" the Hopper designs
    (layer 0's kernel and v5), which raises where the rule gives a layer
    "sm80"."""
    cins = (cfg.feat_dim,) + tuple(cfg.channels[:-1])
    rule = [layer_route(l, cin, cout, k, d) for l, (cin, cout, k, d) in
            enumerate(zip(cins, cfg.channels, cfg.kernel_sizes,
                          cfg.dilations))]
    if design is None:
        return rule
    if design == "sm80":
        return ["sm80"] * len(rule)
    if design != "sm90":
        raise ValueError(f"unknown design {design!r}")
    if "sm80" in rule:
        raise ValueError("the sm90 kernels do not take this shape (its "
                         "route is sm80: layer 0 does not fit l0_takes)")
    return rule


def _check_supported(cfg):
    if not supports(cfg):
        raise ValueError(f"fused path does not support topology {cfg.name}")


def _epilogue(cfg, y, b, scale, shift, alpha, m):
    y = y + b
    if cfg.activation == "relu":
        y = torch.clamp(y, min=0.0)
    elif cfg.activation == "lrelu":
        y = torch.where(y >= 0.0, y, cfg.lrelu_alpha * y)
    else:
        y = y.clamp(min=0.0) + alpha * y.clamp(max=0.0)
    return (y * scale + shift) * m


def l0_reference(cfg: tdnn.TdnnConfig, folded: FoldedStack, x, mask):
    """Plain PyTorch version of layer 0 in its packed form: (B, T, F) f32
    features and (B, T) mask → (B, T, Cout'_0) f32.  The masked features
    are rounded to bf16 and unfolded into (tap, channel) columns, k·F
    zero-padded to W0's rows, multiplied by W0 in f32 (bf16 products are
    exact in f32), and the epilogue runs in f32, as the kernel does."""
    k, d = cfg.kernel_sizes[0], cfg.dilations[0]
    left = (k - 1) // 2 * d
    t = x.shape[1]
    m = mask.to(torch.float32)[..., None]
    xb = (x.to(torch.float32) * m).to(torch.bfloat16).to(torch.float32)
    hp = F.pad(xb, (0, 0, left, (k - 1) * d - left))
    cols = torch.cat([hp[:, j * d: j * d + t] for j in range(k)], dim=-1)
    w0 = folded.w0.to(torch.float32)
    cols = F.pad(cols, (0, w0.shape[0] - cols.shape[-1]))
    _, b, scale, shift, alpha = folded.layers[0]
    return _epilogue(cfg, cols @ w0, b, scale, shift, alpha, m)


def layer_reference(cfg: tdnn.TdnnConfig, folded: FoldedStack, l: int, h,
                    mask):
    """Plain PyTorch version of layer ``l`` of K1: its input ``h`` (the
    features for layer 0, else the previous layer's output) and the (B, T)
    mask → (B, T, Cout'_l) f32.  Layer 0 is :func:`l0_reference`; a later
    layer rounds its input to bf16 and sums the k shifted products in f32
    (bf16 products are exact in f32, so an f32 matmul of the rounded
    operands is a bf16-operand, f32-accumulate product); the epilogue runs
    in f32."""
    if l == 0:
        return l0_reference(cfg, folded, h, mask)
    w, b, scale, shift, alpha = folded.layers[l]
    k, d = cfg.kernel_sizes[l], cfg.dilations[l]
    left = (k - 1) // 2 * d
    t = h.shape[1]
    hp = F.pad(h.to(torch.bfloat16).to(torch.float32),
               (0, 0, left, (k - 1) * d - left))
    wf = w.to(torch.float32)
    y = None
    for j in range(k):
        term = hp[:, j * d: j * d + t] @ wf[j]
        y = term if y is None else y + term
    return _epilogue(cfg, y, b, scale, shift, alpha,
                     mask.to(torch.float32)[..., None])


def fused_frame_stack_reference(cfg: tdnn.TdnnConfig, params, state, x,
                                mask=None):
    """Plain PyTorch version of K1: (B, T, F) → (B, T, channels[-1]) f32,
    layer by layer through :func:`layer_reference`.  ``params`` is the raw
    parameters (folded here) or a :class:`FoldedStack` (``state``
    unused)."""
    _check_supported(cfg)
    folded = _folded(cfg, params, state)
    if mask is None:
        mask = torch.ones(x.shape[:2], dtype=torch.float32, device=x.device)
    cur = x
    for l in range(len(folded.layers)):
        cur = layer_reference(cfg, folded, l, cur, mask)
    if cur.shape[-1] != folded.out_dim:
        cur = cur[..., :folded.out_dim].contiguous()
    return cur


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if lib.tdnn_layer_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.tdnn_layer_launch.argtypes = [
            p, i, p, p, p, p, p, p, p, i,        # x .. out, out_f32
            i, i, i, i, i, i, i, i,              # B T Cin Cout out_cols K dil
            ctypes.c_float, p]                   # act, lrelu alpha, stream
        lib.tdnn_layer_launch.restype = ctypes.c_int
    return lib


def _require(t: torch.Tensor, name: str, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _launch(cfg, folded: FoldedStack, l: int, design: str, h, mask):
    """Layer ``l`` on the card by ``design``: (B, T, out_cols) bf16, or f32
    for the last layer, where out_cols is the padded Cout' (carried on to
    the next layer) or, for the last layer, channels[-1] when its f32 rows
    stay 16-byte multiples."""
    global launches
    dev = h.device
    bsz, t = h.shape[:2]
    w, b, scale, shift, alpha = folded.layers[l]
    k, d = cfg.kernel_sizes[l], cfg.dilations[l]
    cin, cout = w.shape[1], w.shape[2]
    _require(h, f"layer {l} input", torch.float32 if l == 0
             else torch.bfloat16, (bsz, t, cin), dev)
    _require(mask, "mask", torch.float32, (bsz, t), dev)
    _require(w, f"layer {l} w", torch.bfloat16, (k, cin, cout), dev)
    for name, v in (("b", b), ("scale", scale), ("shift", shift),
                    ("alpha", alpha)):
        if v is not None:
            _require(v, f"layer {l} {name}", torch.float32, (cout,), dev)
    last = l == len(folded.layers) - 1
    out_cols = (folded.out_dim if last and folded.out_dim % 4 == 0
                else cout)
    out = torch.empty((bsz, t, out_cols), device=dev,
                      dtype=torch.float32 if last else torch.bfloat16)
    act, slope = _ACT[cfg.activation], float(cfg.lrelu_alpha)
    vecs = (b.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            None if alpha is None else alpha.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if design == "l0_sm90":
            w0 = folded.w0
            _require(w0, "w0", torch.bfloat16, (w0.shape[0], cout), dev)
            rc = _lib_fwd().tdnn_l0_sm90_launch(
                h.data_ptr(), mask.data_ptr(), w0.data_ptr(), *vecs,
                out.data_ptr(), int(last), _num_sms(dev), bsz, t, cin,
                w0.shape[0], cout, out_cols, k, d, act, slope, stream)
        elif design == "sm90":
            rc = _lib_fwd().tdnn_layer_sm90_launch(
                h.data_ptr(), mask.data_ptr(), w.data_ptr(), *vecs,
                out.data_ptr(), int(last), _num_sms(dev), bsz, t, cin, cout,
                out_cols, k, d, act, slope, stream)
        else:
            rc = _lib().tdnn_layer_launch(
                h.data_ptr(), int(l == 0), mask.data_ptr(), w.data_ptr(),
                *vecs, out.data_ptr(), int(last), bsz, t, cin, cout,
                out_cols, k, d, act, slope, stream)
    _raise_on(rc, f"K1 {design} layer {l} (k={k}, dilation={d})")
    launches += 1
    route_launches[design] += 1
    return out


def _check_input(cfg, x, mask):
    """The features (B, T, F) f32 checked, and the mask (all ones when
    None)."""
    if x.dim() != 3 or x.shape[0] == 0 or x.shape[1] == 0:
        raise ValueError(f"x must be a non-empty (B, T, F) tensor, got "
                         f"{tuple(x.shape)}")
    _require(x, "x", torch.float32, (*x.shape[:2], cfg.feat_dim), x.device)
    if mask is None:
        mask = torch.ones(x.shape[:2], dtype=torch.float32, device=x.device)
    return mask


def fused_layer(cfg: tdnn.TdnnConfig, folded: FoldedStack, l: int, h,
                mask, design: Optional[str] = None):
    """Layer ``l`` of K1 alone, as the stack runs it, on its input ``h``
    and the (B, T) f32 mask: CPU tensors take :func:`layer_reference`
    (f32); CUDA tensors launch the layer's kernel (:func:`layer_route`, or
    ``design``) and give what the stack passes on (bf16 (B, T, Cout'), f32
    for the last layer)."""
    _check_supported(cfg)
    design = _layer_designs(cfg, design)[l]
    if h.device.type == "cpu":
        return layer_reference(cfg, folded, l, h, mask)
    if h.device.type != "cuda":
        raise ValueError(f"no fused frame stack for device {h.device}")
    if l == 0:
        mask = _check_input(cfg, h, mask)
    return _launch(cfg, folded, l, design, h, mask)


def fused_frame_stack(cfg: tdnn.TdnnConfig, params, state, x, mask=None,
                      design: Optional[str] = None):
    """(B, T, F) → (B, T, channels[-1]) f32 frame-level activations,
    matching K1 (eval mode).  ``params`` is the raw parameters (folded on
    every call) or a :class:`FoldedStack` from :func:`fold_stack` (``state``
    unused).  CPU tensors take the plain version; CUDA tensors launch each
    layer's kernel (:func:`layer_route`, or ``design``), or raise."""
    _check_supported(cfg)
    designs = _layer_designs(cfg, design)
    if x.device.type == "cpu":
        return fused_frame_stack_reference(cfg, params, state, x, mask)
    if x.device.type != "cuda":
        raise ValueError(f"no fused frame stack for device {x.device}")
    mask = _check_input(cfg, x, mask)
    folded = _folded(cfg, params, state)
    cur = x
    for l, design in enumerate(designs):
        cur = _launch(cfg, folded, l, design, cur, mask)
    return cur[..., :folded.out_dim]
