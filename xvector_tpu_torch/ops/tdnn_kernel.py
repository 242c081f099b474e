"""Fused TDNN frame stack (eval / extraction path): K1 on Hopper.

Counterpart of ``xvector_tpu/ops/tdnn_kernel.py``.  Each layer computes
conv1d(+dilation) with bf16 operands and f32 accumulation → bias →
activation → eval batch norm folded to ``y·scale + shift`` → frame mask;
the last layer's output is f32 (B, T, channels[-1]).

* :func:`fused_frame_stack_reference` is the plain PyTorch version with
  exactly K1's numerics (the CPU path and the referee on the card);
* :func:`fused_frame_stack` dispatches: CPU tensors take the plain version,
  CUDA tensors launch one hand-written kernel per layer, or raise;
* :func:`layer_route` is the written rule that picks each layer's design:
  ``"sm90"`` (K1 v5, ``csrc/fwd_sm90.cu``: the wgmma/TMA forward that K2
  v2 shares, with K1's epilogue) for a layer after the first whose channel
  counts are multiples of 8; ``"sm80"`` (K1 v4, ``csrc/tdnn_stack.cu``:
  mma.sync, cp.async) for layer 0, which reads the f32 features, and for
  channel counts off 8 (etdnn's 1500).  ``design=`` forces one;
* :data:`launches` counts layer launches, :data:`route_launches` the same
  launches by design.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..models import tdnn
from . import _build
from .conv_bwd import _design, _lib_fwd, _num_sms, _raise_on

__all__ = ["fused_frame_stack", "fused_frame_stack_reference", "supports",
           "layer_route", "launches", "route_launches"]

SOURCE = "tdnn_stack.cu"
_ACT = {"relu": 0, "lrelu": 1, "prelu": 2}

# Kernel launches so far (one per layer), in all and by design;
# chip_smoke.py zeroes and reads them.
launches = 0
route_launches = {"sm90": 0, "sm80": 0}


def supports(cfg: tdnn.TdnnConfig) -> bool:
    """Fused path covers the stats-pooling topologies (all activations);
    attention pooling's split head changes the output contract."""
    return cfg.pooling == "stats" and cfg.activation in ("relu", "lrelu",
                                                         "prelu")


def _halo(cfg: tdnn.TdnnConfig) -> int:
    return sum((k - 1) // 2 * d
               for k, d in zip(cfg.kernel_sizes, cfg.dilations))


def _flatten_params(cfg: tdnn.TdnnConfig, params, state):
    """Per layer ``(w bf16 (K, Cin, Cout), b, scale, shift, alpha or
    None)`` with the eval batch norm folded: ``scale = γ/√(var+ε)``,
    ``shift = β − mean·scale`` (f32)."""
    flat = []
    for l, layer in enumerate(params["frame"]):
        bn_s = state["frame"][l]
        scale = layer["bn"]["gamma"] * torch.rsqrt(bn_s["var"] + cfg.bn_eps)
        shift = layer["bn"]["beta"] - bn_s["mean"] * scale
        alpha = (layer["alpha"].to(torch.float32).contiguous()
                 if cfg.activation == "prelu" else None)
        flat.append((layer["w"].to(torch.bfloat16).contiguous(),
                     layer["b"].to(torch.float32).contiguous(),
                     scale.to(torch.float32).contiguous(),
                     shift.to(torch.float32).contiguous(), alpha))
    return flat


def layer_route(l: int, cin: int, cout: int) -> str:
    """The design that runs layer ``l`` (Cin → Cout) on the card: "sm80"
    (K1 v4) for layer 0, whose input is the f32 features, and for a channel
    count off 8 (TMA's global strides are multiples of 16 bytes); "sm90"
    (K1 v5) for every other layer."""
    return "sm80" if l == 0 or cin % 8 or cout % 8 else "sm90"


def _layer_designs(cfg: tdnn.TdnnConfig, design=None):
    """Each layer's design: :func:`layer_route`'s, or ``design`` on every
    layer.  "sm80" takes every layer; "sm90" raises, since layer 0 never
    takes it."""
    cins = (cfg.feat_dim,) + tuple(cfg.channels[:-1])
    return [_design(design, layer_route(l, cin, cout))
            for l, (cin, cout) in enumerate(zip(cins, cfg.channels))]


def _check_supported(cfg):
    if not supports(cfg):
        raise ValueError(f"fused path does not support topology {cfg.name}")


def fused_frame_stack_reference(cfg: tdnn.TdnnConfig, params, state, x,
                                mask=None):
    """Plain PyTorch version of K1: (B, T, F) → (B, T, channels[-1]) f32.

    The masked f32 input and every layer input are rounded to bf16, the
    k shifted products accumulate in f32 (bf16 products are exact in f32,
    so an f32 matmul of the rounded operands is a bf16-operand,
    f32-accumulate product), and the epilogue runs in f32."""
    _check_supported(cfg)
    if mask is None:
        mask = torch.ones(x.shape[:2], dtype=torch.float32, device=x.device)
    m = mask.to(torch.float32)[..., None]
    cur = x.to(torch.float32) * m
    t = x.shape[1]
    for l, (w, b, scale, shift, alpha) in enumerate(
            _flatten_params(cfg, params, state)):
        k, d = cfg.kernel_sizes[l], cfg.dilations[l]
        left = (k - 1) // 2 * d
        hp = F.pad(cur.to(torch.bfloat16).to(torch.float32),
                   (0, 0, left, (k - 1) * d - left))
        wf = w.to(torch.float32)
        y = None
        for j in range(k):
            term = hp[:, j * d: j * d + t] @ wf[j]
            y = term if y is None else y + term
        y = y + b
        if cfg.activation == "relu":
            y = torch.clamp(y, min=0.0)
        elif cfg.activation == "lrelu":
            y = torch.where(y >= 0.0, y, cfg.lrelu_alpha * y)
        else:
            y = y.clamp(min=0.0) + alpha * y.clamp(max=0.0)
        cur = (y * scale + shift) * m
    return cur


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if lib.tdnn_layer_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.tdnn_layer_launch.argtypes = [
            p, i, p, p, p, p, p, p, p, i,        # x .. out, out_f32
            i, i, i, i, i, i, i, ctypes.c_float,  # B T Cin Cout K dil act a
            p]                                   # stream
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


def _fused_cuda(cfg, params, state, x, mask, designs):
    global launches
    dev = x.device
    if x.dim() != 3 or x.shape[0] == 0 or x.shape[1] == 0:
        raise ValueError(f"x must be a non-empty (B, T, F) tensor, got "
                         f"{tuple(x.shape)}")
    bsz, t, _ = x.shape
    if mask is None:
        mask = torch.ones((bsz, t), dtype=torch.float32, device=dev)
    _require(x, "x", torch.float32, (bsz, t, cfg.feat_dim), dev)
    _require(mask, "mask", torch.float32, (bsz, t), dev)
    layers = _flatten_params(cfg, params, state)
    cur, cin = x, cfg.feat_dim
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for l, (w, b, scale, shift, alpha) in enumerate(layers):
            k, d = cfg.kernel_sizes[l], cfg.dilations[l]
            cout = cfg.channels[l]
            _require(w, f"layer {l} w", torch.bfloat16, (k, cin, cout), dev)
            for name, v in (("b", b), ("scale", scale), ("shift", shift),
                            ("alpha", alpha)):
                if v is not None:
                    _require(v, f"layer {l} {name}", torch.float32, (cout,),
                             dev)
            last = l == len(layers) - 1
            out = torch.empty((bsz, t, cout), device=dev,
                              dtype=torch.float32 if last else torch.bfloat16)
            alpha_ptr = None if alpha is None else alpha.data_ptr()
            if designs[l] == "sm90":
                rc = _lib_fwd().tdnn_layer_sm90_launch(
                    cur.data_ptr(), mask.data_ptr(), w.data_ptr(),
                    b.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                    alpha_ptr, out.data_ptr(), int(last), _num_sms(dev), bsz,
                    t, cin, cout, k, d, _ACT[cfg.activation],
                    float(cfg.lrelu_alpha), stream)
            else:
                rc = _lib().tdnn_layer_launch(
                    cur.data_ptr(), int(l == 0), mask.data_ptr(),
                    w.data_ptr(), b.data_ptr(), scale.data_ptr(),
                    shift.data_ptr(), alpha_ptr, out.data_ptr(), int(last),
                    bsz, t, cin, cout, k, d, _ACT[cfg.activation],
                    float(cfg.lrelu_alpha), stream)
            _raise_on(rc, f"K1 {designs[l]} layer {l} (k={k}, dilation={d})")
            launches += 1
            route_launches[designs[l]] += 1
            cur, cin = out, cout
    return cur


def fused_frame_stack(cfg: tdnn.TdnnConfig, params, state, x, mask=None,
                      design=None):
    """(B, T, F) → (B, T, channels[-1]) f32 frame-level activations,
    matching K1 (eval mode).  CPU tensors take the plain version; CUDA
    tensors launch each layer's kernel (:func:`layer_route`, or
    ``design``), or raise."""
    _check_supported(cfg)
    designs = _layer_designs(cfg, design)
    if x.device.type == "cpu":
        return fused_frame_stack_reference(cfg, params, state, x, mask)
    if x.device.type != "cuda":
        raise ValueError(f"no fused frame stack for device {x.device}")
    return _fused_cuda(cfg, params, state, x, mask, designs)
