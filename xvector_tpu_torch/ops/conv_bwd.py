"""SAME 1-D conv of the wide TDNN layers with hand-written forward and
backward kernels: K2, K3 and K4 on Hopper.

Counterpart of ``xvector_tpu/ops/conv_bwd.py``.  For x (B, T, Cin) and
w (K, Cin, Cout), with ``left = (K-1)//2 * dilation`` and zeros outside
[0, T) of each row:

* K2, the forward: ``y[b,t] = Σ_j x[b, t-left+j·d] @ w[j]``;
* K3, the weight gradient: ``dW[j] = Σ_{b,t} x[b, t-left+j·d]ᵀ g[b,t]``,
  kept in f32;
* K4, the input gradient: ``dx[b,t] = Σ_j g[b, t+left-j·d] @ w[j]ᵀ``.

Each sums all of its products in f32 (f64 for f64 inputs) and rounds once
to the output dtype.  :func:`conv1d_same_fused_bwd` is the
``torch.autograd.Function`` that joins them, as the JAX package's custom
VJP does: the backward casts the cotangent to ``w.dtype``, runs K3 and, when
x needs a gradient, K4, and casts dW to ``w.dtype``.

Dispatch is by device.  CPU tensors take the plain PyTorch versions
(:func:`conv_fwd_reference`, :func:`conv_dw_reference`,
:func:`conv_dx_reference`); CUDA tensors launch the kernels in
``csrc/conv_bwd.cu`` or raise.  :func:`supports` is the card's rule: bf16
operands of matching shapes.  :data:`launches` counts kernel calls, one
per call of each kernel (a K3 call with a split reduction is two CUDA
launches and counts once).
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["conv1d_same_fused_bwd", "conv_fwd", "conv_dw", "conv_dx",
           "conv_fwd_reference", "conv_dw_reference", "conv_dx_reference",
           "supports", "launches"]

SOURCE = "conv_bwd.cu"

# Kernel calls so far, per kernel; chip_smoke.py zeroes and reads them.
launches = {"fwd": 0, "dw": 0, "dx": 0}

_BM = _BN = 128        # K3 output tile (csrc/conv_bwd.cu)
_BK = 64               # K3 rows per pipeline step
_BLOCKS_PER_SM = 2


def _left(k: int, dilation: int) -> int:
    return (k - 1) // 2 * dilation


def supports(x_shape, w_shape, dilation: int, dtype) -> bool:
    """The kernels' rule: bf16 operands, x (B, T, Cin) and w (K, Cin, Cout)
    with every extent ≥ 1 and dilation ≥ 1.  Ragged B, T and channel
    counts are taken; tensors must also be contiguous and 16-byte aligned
    (the wrappers check that and raise)."""
    return (dtype == torch.bfloat16 and len(x_shape) == 3
            and len(w_shape) == 3 and x_shape[2] == w_shape[1]
            and min(*x_shape, *w_shape) >= 1 and dilation >= 1)


# ---------------------------------------------------------------------------
# Plain versions: the CPU path and the referee on the card
# ---------------------------------------------------------------------------

def _acc(dtype):
    return torch.promote_types(dtype, torch.float32)


def _shifted(a, k: int, dilation: int, first: int):
    """The k slices ``a[:, t + first + j·d]`` for j in 0..k-1, zero outside
    [0, T) of each row, in ``a``'s dtype."""
    t = a.shape[1]
    lo = max(0, -first)
    hi = max(0, first + (k - 1) * dilation)
    ap = F.pad(a, (0, 0, lo, hi))
    return [ap[:, lo + first + j * dilation: lo + first + j * dilation + t]
            for j in range(k)]


def conv_fwd_reference(x, w, dilation: int):
    """K2's function: (B, T, Cin) ⊛ (K, Cin, Cout) → (B, T, Cout) in x's
    dtype, all k products summed in f32 (f64 for f64) and rounded once."""
    k = w.shape[0]
    acc = _acc(x.dtype)
    wa = w.to(acc)
    y = None
    for j, xs in enumerate(_shifted(x.to(acc), k, dilation,
                                    -_left(k, dilation))):
        term = xs @ wa[j]
        y = term if y is None else y + term
    return y.to(x.dtype)


def conv_dw_reference(x, g, k: int, dilation: int):
    """K3's function: dW (K, Cin, Cout) in f32 (f64 for f64 inputs) from
    x (B, T, Cin) and the cotangent g (B, T, Cout)."""
    acc = _acc(x.dtype)
    g2 = g.to(acc).reshape(-1, g.shape[-1])
    return torch.stack([
        xs.reshape(-1, x.shape[-1]).T @ g2
        for xs in _shifted(x.to(acc), k, dilation, -_left(k, dilation))])


def conv_dx_reference(g, w, dilation: int):
    """K4's function: dx (B, T, Cin) in g's dtype from the cotangent
    g (B, T, Cout) and w (K, Cin, Cout)."""
    k = w.shape[0]
    acc = _acc(g.dtype)
    wa = w.to(acc)
    left = _left(k, dilation)
    # tap j reads g at t + left - j·d: the slices at first = left-(k-1)·d,
    # in reverse order
    gs = _shifted(g.to(acc), k, dilation, left - (k - 1) * dilation)
    dx = None
    for j in range(k):
        term = gs[k - 1 - j] @ wa[j].T
        dx = term if dx is None else dx + term
    return dx.to(g.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if lib.conv_fwd_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.conv_fwd_launch, lib.conv_dx_launch):
            fn.argtypes = [p, p, p, i, i, i, i, i, i, p]
            fn.restype = ctypes.c_int
        lib.conv_dw_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, p]
        lib.conv_dw_launch.restype = ctypes.c_int
    return lib


def _require(t: torch.Tensor, name: str, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.bfloat16:
        raise ValueError(f"{name} has dtype {t.dtype}, expected "
                         "torch.bfloat16")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check(x_shape, w_shape, dilation, dtype):
    if not supports(x_shape, w_shape, dilation, dtype):
        raise ValueError(
            f"conv kernels do not take x {tuple(x_shape)}, w "
            f"{tuple(w_shape)}, dilation {dilation}, dtype {dtype}")


def _kernel_device(t: torch.Tensor) -> torch.device:
    """The CUDA device of ``t``; anything else raises (CPU tensors never
    reach here: they take the plain versions)."""
    if t.device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(
            f"the conv kernels take cuda tensors (torch.cuda.is_available() "
            f"is {torch.cuda.is_available()}), got one on {t.device}; CPU "
            "tensors take the plain versions")
    return t.device


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} failed: cudaError {rc}")


def _dw_splits(tiles: int, steps: int, slots: int) -> int:
    """Splits of the B·T rows for K3: the count in 1..16 whose grid fills
    the card's block slots best (blocks / whole waves), the smallest on a
    tie."""
    best, best_fill = 1, 0.0
    for s in range(1, min(16, steps) + 1):
        blocks = tiles * s
        fill = blocks / (math.ceil(blocks / slots) * slots)
        if fill > best_fill + 1e-9:
            best, best_fill = s, fill
    return best


def conv_fwd(x, w, dilation: int):
    """K2: y (B, T, Cout).  CPU tensors take :func:`conv_fwd_reference`;
    CUDA tensors launch the kernel, or raise."""
    if x.device.type == "cpu":
        return conv_fwd_reference(x, w, dilation)
    dev = _kernel_device(x)
    _check(x.shape, w.shape, dilation, x.dtype)
    bsz, t, cin = x.shape
    k, _, cout = w.shape
    _require(x, "x", (bsz, t, cin), dev)
    _require(w, "w", (k, cin, cout), dev)
    y = torch.empty((bsz, t, cout), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().conv_fwd_launch(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                                    bsz, t, cin, cout, k, dilation,
                                    _stream(dev))
    _raise_on(rc, f"conv_fwd_launch (k={k}, dilation={dilation})")
    launches["fwd"] += 1
    return y


def conv_dx(g, w, dilation: int):
    """K4: dx (B, T, Cin) from the cotangent g (B, T, Cout).  CPU tensors
    take :func:`conv_dx_reference`; CUDA tensors launch the kernel, or
    raise."""
    if g.device.type == "cpu":
        return conv_dx_reference(g, w, dilation)
    dev = _kernel_device(g)
    k, cin, cout = w.shape
    _check((*g.shape[:2], cin), w.shape, dilation, g.dtype)
    bsz, t, _ = g.shape
    _require(g, "g", (bsz, t, cout), dev)
    _require(w, "w", (k, cin, cout), dev)
    dx = torch.empty((bsz, t, cin), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().conv_dx_launch(g.data_ptr(), w.data_ptr(), dx.data_ptr(),
                                   bsz, t, cin, cout, k, dilation,
                                   _stream(dev))
    _raise_on(rc, f"conv_dx_launch (k={k}, dilation={dilation})")
    launches["dx"] += 1
    return dx


def conv_dw(x, g, k: int, dilation: int):
    """K3: dW (K, Cin, Cout) in f32.  CPU tensors take
    :func:`conv_dw_reference`; CUDA tensors launch the kernel (a split
    over the B·T rows into an f32 workspace, then an ordered sum), or
    raise."""
    if x.device.type == "cpu":
        return conv_dw_reference(x, g, k, dilation)
    dev = _kernel_device(x)
    bsz, t, cin = x.shape
    cout = g.shape[-1]
    _check(x.shape, (k, cin, cout), dilation, x.dtype)
    _require(x, "x", (bsz, t, cin), dev)
    _require(g, "g", (bsz, t, cout), dev)
    steps = -(-bsz * t // _BK)
    tiles = -(-k * cin // _BM) * -(-cout // _BN)
    slots = (torch.cuda.get_device_properties(dev).multi_processor_count
             * _BLOCKS_PER_SM)
    split_steps = -(-steps // _dw_splits(tiles, steps, slots))
    splits = -(-steps // split_steps)
    dw = torch.empty((k, cin, cout), dtype=torch.float32, device=dev)
    ws = (torch.empty((splits, k * cin, cout), dtype=torch.float32,
                      device=dev) if splits > 1 else None)
    with torch.cuda.device(dev):
        rc = _lib().conv_dw_launch(
            x.data_ptr(), g.data_ptr(), None if ws is None else ws.data_ptr(),
            dw.data_ptr(), splits, split_steps * _BK, bsz, t, cin, cout, k,
            dilation, _stream(dev))
    _raise_on(rc, f"conv_dw_launch (k={k}, dilation={dilation})")
    launches["dw"] += 1
    return dw


class _ConvSame(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, dilation):
        ctx.save_for_backward(x, w)
        ctx.dilation = dilation
        return conv_fwd(x, w, dilation)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        d = ctx.dilation
        g = g.to(w.dtype).contiguous()
        dx = conv_dx(g, w, d) if ctx.needs_input_grad[0] else None
        dw = (conv_dw(x, g, w.shape[0], d).to(w.dtype)
              if ctx.needs_input_grad[1] else None)
        return dx, dw, None


def conv1d_same_fused_bwd(x, w, dilation: int):
    """(B, T, Cin) ⊛ (K, Cin, Cout) SAME conv → (B, T, Cout) in x's dtype,
    K2 forward and K3/K4 backward.  x and w share one dtype; on the card
    it must be bf16 (:func:`supports`)."""
    if x.dtype != w.dtype:
        raise ValueError(f"x is {x.dtype} and w is {w.dtype}; the conv "
                         "takes one dtype")
    return _ConvSame.apply(x, w, dilation)
