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
:func:`conv_dx_reference`); CUDA tensors launch a kernel or raise.
:func:`supports` is the card's rule: bf16 operands of matching shapes.
Each kernel has two designs, picked by the written shape rule
:func:`route`: ``"sm90"`` for every channel count a multiple of 8 (every
wide zoo layer), ``"sm80"`` for the rest.  ``"sm90"`` is written for
Hopper's own instructions (wgmma, TMA, warp specialisation): K2 v2 is
``csrc/fwd_sm90.cu``'s persistent forward with no epilogue (the kernel K1
v5's layers share), K3 v2 and K4 v2 are ``csrc/conv_sm90.cu`` (K3 one
cluster launch with an ordered reduction in distributed shared memory,
scheduled by :func:`dw_schedule`; K4 a persistent grid).  ``"sm80"`` is
``csrc/conv_bwd.cu`` (mma.sync, cp.async; K2 and K4 its
``shift_gemm_kernel``).  Each wrapper takes ``design=`` to force one.

:data:`launches` counts kernel calls, one per call of each kernel (a K3
v1 call with a split reduction is two CUDA launches and counts once);
:data:`route_launches` counts the calls of each kernel by design.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["conv1d_same_fused_bwd", "conv_fwd", "conv_dw", "conv_dx",
           "conv_fwd_reference", "conv_dw_reference", "conv_dx_reference",
           "supports", "route", "dw_schedule", "dw_stages", "dw_ranges",
           "dw_max_clusters", "launches", "route_launches"]

SOURCE = "conv_bwd.cu"
SOURCE_SM90 = "conv_sm90.cu"
SOURCE_FWD = "fwd_sm90.cu"

# Kernel calls so far, per kernel and per design; chip_smoke.py zeroes and
# reads them.
launches = {"fwd": 0, "dw": 0, "dx": 0}
route_launches = {"fwd_sm90": 0, "fwd_sm80": 0, "dw_sm90": 0, "dw_sm80": 0,
                  "dx_sm90": 0, "dx_sm80": 0}

_BM = _BN = 128        # K3 v1 output tile (csrc/conv_bwd.cu)
_BK = 64               # K3 v1 rows per pipeline step
_BLOCKS_PER_SM = 2     # K3 v1 blocks resident per SM

# K3 v2 (csrc/conv_sm90.cu): output rows per tile, stage box of
# DW_TT frames x DW_BB batch rows, cluster limit (portable size)
DW_BM, DW_TT, DW_BB = 128, 16, 4
DW_MAX_SPLITS = 8
DW_BNS = (256, 128)
# dw_schedule's cost model of one K3 v2 block: a stage of 64 rows costs
# (bn + DW_STAGE_COLS) units (the A tile and the pipeline step cost as much
# as ~320 more output columns), and a block DW_FIXED_STAGES stages more
# (ring prologue, partial, ordered sum, store)
DW_STAGE_COLS = 320
DW_FIXED_STAGES = 10
_INT32 = 2 ** 31


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


def _lib_sm90() -> ctypes.CDLL:
    lib = _build.load(SOURCE_SM90)
    if lib.conv_dw_sm90_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.conv_dw_sm90_launch.argtypes = [p, p, p, i, i, i, i, i, i, i, i,
                                            p]
        lib.conv_dx_sm90_launch.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
        lib.conv_dw_sm90_launch.restype = ctypes.c_int
        lib.conv_dx_sm90_launch.restype = ctypes.c_int
        lib.conv_dw_sm90_max_clusters.argtypes = [i, i,
                                                  ctypes.POINTER(i)]
        lib.conv_dw_sm90_max_clusters.restype = ctypes.c_int
    return lib


def _lib_fwd() -> ctypes.CDLL:
    """``csrc/fwd_sm90.cu``: K2 v2, K1 v5's layers and K1's layer 0."""
    lib = _build.load(SOURCE_FWD)
    if lib.conv_fwd_sm90_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.conv_fwd_sm90_launch.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
        lib.conv_fwd_sm90_launch.restype = ctypes.c_int
        lib.tdnn_layer_sm90_launch.argtypes = [
            p, p, p, p, p, p, p, p, i,  # x .. out, out_f32
            i, i, i, i, i, i,           # blocks B T Cin Cout out_cols
            i, i, i, ctypes.c_float, p]  # K dil act, lrelu alpha, stream
        lib.tdnn_layer_sm90_launch.restype = ctypes.c_int
        lib.tdnn_l0_sm90_launch.argtypes = [
            p, p, p, p, p, p, p, p, i,  # x .. out, out_f32
            i, i, i, i, i, i, i,        # blocks B T F kpad Cout out_cols
            i, i, i, ctypes.c_float, p]  # K dil act, lrelu alpha, stream
        lib.tdnn_l0_sm90_launch.restype = ctypes.c_int
    return lib


_clusters = {}


def dw_max_clusters(dev):
    """``max_clusters`` of :func:`dw_schedule` for the card ``dev``,
    asked of the CUDA runtime once per device."""
    if dev not in _clusters:
        lib, out = _lib_sm90(), {}
        with torch.cuda.device(dev):
            for bn in DW_BNS:
                for s in range(1, DW_MAX_SPLITS + 1):
                    n = ctypes.c_int(0)
                    _raise_on(lib.conv_dw_sm90_max_clusters(
                        bn, s, ctypes.byref(n)),
                        f"cudaOccupancyMaxActiveClusters (bn={bn}, S={s})")
                    out[(bn, s)] = n.value
        _clusters[dev] = out
    return _clusters[dev]


_sms = {}


def _num_sms(dev) -> int:
    """The card's SM count, read once per device (a host-bound step calls
    the wrappers hundreds of times)."""
    if dev not in _sms:
        _sms[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _sms[dev]


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


# error codes of csrc/sm90.cuh beyond cudaError_t's range
_ERR_NO_ENCODER, _ERR_ENCODE = 10000, 10001


def _raise_on(rc: int, what: str):
    if rc == _ERR_NO_ENCODER:
        raise RuntimeError(f"{what} failed: libcuda has no "
                           "cuTensorMapEncodeTiled")
    if rc >= _ERR_ENCODE:
        raise RuntimeError(f"{what} failed: cuTensorMapEncodeTiled returned "
                           f"CUresult {rc - _ERR_ENCODE}")
    if rc != 0:
        raise RuntimeError(f"{what} failed: cudaError {rc}")


def route(x_shape, w_shape, dilation: int) -> str:
    """Which design runs K2, K3 and K4 for x (B, T, Cin) and w (K, Cin,
    Cout):
    ``"sm90"`` when every channel count is a multiple of 8 (TMA's global
    strides are multiples of 16 bytes) and every extent and tap reach fits
    the kernels' int32 coordinates; ``"sm80"`` otherwise.  The sm90 boxes
    are fixed (64 x 16 x 4 or 8, 64 x 128 x 1, 128 or 256 x 8 x 1), all
    within TMA's 256 per dimension, so no other shape limit applies."""
    b, t, cin = x_shape
    k, _, cout = w_shape
    fits = max(b, t + (k - 1) * dilation, cin, cout, k) < _INT32
    return "sm90" if cin % 8 == 0 and cout % 8 == 0 and fits else "sm80"


def dw_stages(b: int, t: int):
    """K3 v2's contraction stages in order: the (b0, t0) origin of each
    box of DW_BB batch rows x DW_TT frames (the kernel's step i is
    ``(i // nt * DW_BB, i % nt * DW_TT)``)."""
    nt = -(-t // DW_TT)
    return [(i // nt * DW_BB, i % nt * DW_TT)
            for i in range(-(-b // DW_BB) * nt)]


def dw_ranges(steps: int, splits: int):
    """The stage range [begin, end) of each cluster rank, as the kernel
    computes it: balanced, so none is empty when splits <= steps."""
    return [(r * steps // splits, (r + 1) * steps // splits)
            for r in range(splits)]


def dw_schedule(k: int, cin: int, cout: int, b: int, t: int,
                max_clusters):
    """K3 v2's schedule ``(bn, splits)``: the tile width (256 or 128
    columns of Cout) and the cluster size S (1..8) whose grid runs in the
    fewest, fullest waves at the least modelled cost.  Each output tile is
    one cluster of S blocks; ``max_clusters[(bn, S)]`` is how many such
    clusters the card holds at once (``cudaOccupancyMaxActiveClusters``:
    clusters are placed within a GPC, so an odd S can leave SMs idle).
    Cost = waves x (stages per block + DW_FIXED_STAGES) x
    (bn + DW_STAGE_COLS); ties go to fewer splits, then the wider tile."""
    steps = len(dw_stages(b, t))
    m_tiles = k * -(-cin // DW_BM)
    best = None
    for bn in DW_BNS:
        tiles = m_tiles * -(-cout // bn)
        for s in range(1, min(DW_MAX_SPLITS, steps) + 1):
            slots = max_clusters.get((bn, s), 0)
            if slots < 1:
                continue
            waves = -(-tiles // slots)
            cost = (waves * (-(-steps // s) + DW_FIXED_STAGES)
                    * (bn + DW_STAGE_COLS))
            key = (cost, s, -bn)
            if best is None or key < best[0]:
                best = (key, (bn, s))
    if best is None:
        raise ValueError("no K3 v2 cluster fits the card")
    return best[1]


def sm80_dw_splits(tiles: int, steps: int, slots: int) -> int:
    """Splits of the B·T rows for K3 v1 (the "sm80" route): the count in
    1..16 whose grid fills the card's block slots best (blocks / whole
    waves), the smallest on a tie."""
    best, best_fill = 1, 0.0
    for s in range(1, min(16, steps) + 1):
        blocks = tiles * s
        fill = blocks / (math.ceil(blocks / slots) * slots)
        if fill > best_fill + 1e-9:
            best, best_fill = s, fill
    return best


def conv_fwd(x, w, dilation: int, design=None):
    """K2: y (B, T, Cout).  CPU tensors take :func:`conv_fwd_reference`;
    CUDA tensors launch the kernel that :func:`route` names (or
    ``design``), or raise."""
    if x.device.type == "cpu":
        return conv_fwd_reference(x, w, dilation)
    dev = _kernel_device(x)
    _check(x.shape, w.shape, dilation, x.dtype)
    bsz, t, cin = x.shape
    k, _, cout = w.shape
    _require(x, "x", (bsz, t, cin), dev)
    _require(w, "w", (k, cin, cout), dev)
    design = _design(design, route(x.shape, w.shape, dilation))
    y = torch.empty((bsz, t, cout), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        if design == "sm90":
            rc = _lib_fwd().conv_fwd_sm90_launch(
                x.data_ptr(), w.data_ptr(), y.data_ptr(), _num_sms(dev), bsz,
                t, cin, cout, k, dilation, _stream(dev))
        else:
            rc = _lib().conv_fwd_launch(x.data_ptr(), w.data_ptr(),
                                        y.data_ptr(), bsz, t, cin, cout, k,
                                        dilation, _stream(dev))
    _raise_on(rc, f"conv_fwd {design} (k={k}, dilation={dilation})")
    launches["fwd"] += 1
    route_launches["fwd_" + design] += 1
    return y


def _design(design, shape_route: str) -> str:
    """The design a CUDA call runs: the route's, or one the caller names
    (chip_smoke.py times both designs at one shape).  "sm80" takes every
    shape; naming "sm90" for a shape its rule refuses raises.  K1's layers
    (ops/tdnn_kernel.py) take the same rule."""
    if design is None:
        return shape_route
    if design not in ("sm90", "sm80"):
        raise ValueError(f"unknown design {design!r}")
    if design == "sm90" and shape_route != "sm90":
        raise ValueError("the sm90 kernels do not take this shape "
                         "(its route is sm80)")
    return design


def conv_dx(g, w, dilation: int, design=None):
    """K4: dx (B, T, Cin) from the cotangent g (B, T, Cout).  CPU tensors
    take :func:`conv_dx_reference`; CUDA tensors launch the kernel that
    :func:`route` names (or ``design``), or raise."""
    if g.device.type == "cpu":
        return conv_dx_reference(g, w, dilation)
    dev = _kernel_device(g)
    k, cin, cout = w.shape
    _check((*g.shape[:2], cin), w.shape, dilation, g.dtype)
    bsz, t, _ = g.shape
    _require(g, "g", (bsz, t, cout), dev)
    _require(w, "w", (k, cin, cout), dev)
    design = _design(design, route((bsz, t, cin), w.shape, dilation))
    dx = torch.empty((bsz, t, cin), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        if design == "sm90":
            rc = _lib_sm90().conv_dx_sm90_launch(
                g.data_ptr(), w.data_ptr(), dx.data_ptr(), _num_sms(dev),
                bsz, t, cin, cout, k, dilation, _stream(dev))
        else:
            rc = _lib().conv_dx_launch(g.data_ptr(), w.data_ptr(),
                                       dx.data_ptr(), bsz, t, cin, cout, k,
                                       dilation, _stream(dev))
    _raise_on(rc, f"conv_dx {design} (k={k}, dilation={dilation})")
    launches["dx"] += 1
    route_launches["dx_" + design] += 1
    return dx


def conv_dw(x, g, k: int, dilation: int, design=None):
    """K3: dW (K, Cin, Cout) in f32.  CPU tensors take
    :func:`conv_dw_reference`; CUDA tensors launch the kernel that
    :func:`route` names (or ``design``), or raise.  "sm90": one cluster launch, scheduled
    by :func:`dw_schedule`; "sm80": a split over the B·T rows into an f32
    workspace, then an ordered sum.  Both give the same bits on every
    run."""
    if x.device.type == "cpu":
        return conv_dw_reference(x, g, k, dilation)
    dev = _kernel_device(x)
    bsz, t, cin = x.shape
    cout = g.shape[-1]
    _check(x.shape, (k, cin, cout), dilation, x.dtype)
    _require(x, "x", (bsz, t, cin), dev)
    _require(g, "g", (bsz, t, cout), dev)
    design = _design(design, route(x.shape, (k, cin, cout), dilation))
    dw = torch.empty((k, cin, cout), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        if design == "sm90":
            bn, splits = dw_schedule(k, cin, cout, bsz, t,
                                     dw_max_clusters(dev))
            rc = _lib_sm90().conv_dw_sm90_launch(
                x.data_ptr(), g.data_ptr(), dw.data_ptr(), bn, splits, bsz,
                t, cin, cout, k, dilation, _stream(dev))
        else:
            steps = -(-bsz * t // _BK)
            tiles = -(-k * cin // _BM) * -(-cout // _BN)
            slots = _num_sms(dev) * _BLOCKS_PER_SM
            split_steps = -(-steps // sm80_dw_splits(tiles, steps, slots))
            splits = -(-steps // split_steps)
            ws = (torch.empty((splits, k * cin, cout), dtype=torch.float32,
                              device=dev) if splits > 1 else None)
            rc = _lib().conv_dw_launch(
                x.data_ptr(), g.data_ptr(),
                None if ws is None else ws.data_ptr(), dw.data_ptr(), splits,
                split_steps * _BK, bsz, t, cin, cout, k, dilation,
                _stream(dev))
    _raise_on(rc, f"conv_dw {design} (k={k}, dilation={dilation})")
    launches["dw"] += 1
    route_launches["dw_" + design] += 1
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
