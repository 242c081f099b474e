"""Card-only tests of the PyTorch port: the hand-written CUDA kernels
against their plain PyTorch versions, on an NVIDIA GPU.  They skip where
``torch.cuda.is_available()`` is False.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch:

    timeout 900 python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_cuda.py

A phase bug in an mbarrier pipeline hangs rather than fails (the sm90
kernels trap after ~4 s of waiting), so run them under ``timeout``.

Bounds, as max |kernel − plain| / max |plain|: 1e-2 for K1, K2 and K4,
whose outputs are bf16 (both round the same operands to bf16 and
accumulate in f32; a different summation order can flip the bf16 rounding
of an output or an intermediate, nothing more); 1e-3 for K3's f32 output,
where only the order of the f32 sums differs."""

import numpy as np
import pytest
import torch

from xvector_tpu_torch.extract import extractor as TE
from xvector_tpu_torch.models import tdnn as tt
from xvector_tpu_torch.ops import conv_bwd as CB
from xvector_tpu_torch.ops import tdnn_kernel as TK
from xvector_tpu_torch.train import trainer as TR

BOUND = 1e-2
DW_BOUND = 1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain version in f32
    return torch.device("cuda")


def _model(name, dev, seed=0):
    cfg = tt.MODEL_ZOO[name]
    return (cfg, *tt.init_params(torch.Generator().manual_seed(seed), cfg,
                                 10, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("t", [5, 333])
@pytest.mark.parametrize("name", ["no_dropout", "prelu", "l2_lrelu",
                                  "tdnn_dilated", "etdnn"])
def test_kernel_matches_plain(name, t, cuda_device):
    cfg, params, state = _model(name, cuda_device)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, t, cfg.feat_dim, generator=g).to(cuda_device)
    mask = torch.ones(3, t)
    mask[1, t * 2 // 3:] = 0.0
    mask = mask.to(cuda_device)
    TK.launches = 0
    got = TK.fused_frame_stack(cfg, params, state, x, mask)
    torch.cuda.synchronize()
    assert TK.launches == cfg.num_frame_layers
    assert got.dtype == torch.float32
    assert got.shape == (3, t, cfg.channels[-1])
    want = TK.fused_frame_stack_reference(cfg, params, state, x, mask)
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= BOUND, err
    assert not got[mask == 0].any()


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    cfg, params, state = _model("tiny", cuda_device)
    x = torch.randn(2, 40, cfg.feat_dim, device=cuda_device)
    with pytest.raises(ValueError, match="dtype"):
        TK.fused_frame_stack(cfg, params, state, x.double())
    with pytest.raises(ValueError, match="contiguous"):
        TK.fused_frame_stack(cfg, params, state,
                             x.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError, match="shape"):
        TK.fused_frame_stack(cfg, params, state, x[..., :5].contiguous())


@pytest.mark.cuda
def test_fused_extraction_matches_unfused(cuda_device):
    cfg, params, state = _model("no_dropout", cuda_device)
    rng = np.random.RandomState(0)
    utts = [(f"u{i}", rng.randn(n, 23).astype(np.float32))
            for i, n in enumerate([30, 300, 1100, 64, 700])]
    out = {}
    for fused in (False, True):
        TK.launches = 0
        ex = TE.XvectorExtractor(cfg, params, state, TE.ExtractorConfig(
            compute_dtype="bfloat16", use_fused=fused, batch_size=2))
        out[fused] = ex.extract(utts)
        assert (TK.launches > 0) == fused
    for utt, _ in utts:
        a, b = out[False][utt], out[True][utt]
        cos = float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))
        assert cos >= 0.999, (utt, cos)


def _err(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def _conv_inputs(b, t, cin, cout, k, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, t, cin, generator=g).to(dev, torch.bfloat16),
            (0.05 * torch.randn(k, cin, cout, generator=g)).to(
                dev, torch.bfloat16),
            torch.randn(b, t, cout, generator=g).to(dev, torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("k,d,b,t,cin,cout", [
    (5, 1, 3, 37, 64, 64),        # one tile column, ragged T
    (7, 1, 2, 301, 384, 640),     # C off the 128 tile, T off 16
    (3, 4, 5, 7, 24, 40),         # rows shorter than the taps' reach
    (3, 2, 6, 301, 12, 20),       # C % 8 != 0: scalar loads
    (5, 1, 1, 1, 16, 8),          # a single frame
])
def test_conv_kernels_match_plain(k, d, b, t, cin, cout, cuda_device):
    x, w, g = _conv_inputs(b, t, cin, cout, k, cuda_device)
    before = dict(CB.launches)
    routes = dict(CB.route_launches)
    y, dx, dw = CB.conv_fwd(x, w, d), CB.conv_dx(g, w, d), \
        CB.conv_dw(x, g, k, d)
    torch.cuda.synchronize()
    assert {n: CB.launches[n] - before[n] for n in before} == \
        {"fwd": 1, "dw": 1, "dx": 1}
    design = CB.route(x.shape, w.shape, d)
    assert _routes_delta(routes) == {"dx_" + design: 1, "dw_" + design: 1}
    assert (y.dtype, dx.dtype, dw.dtype) == (torch.bfloat16, torch.bfloat16,
                                             torch.float32)
    assert _err(y, CB.conv_fwd_reference(x, w, d)) <= BOUND
    assert _err(dx, CB.conv_dx_reference(g, w, d)) <= BOUND
    assert _err(dw, CB.conv_dw_reference(x, g, k, d)) <= DW_BOUND


def _routes_delta(before):
    return {n: CB.route_launches[n] - before[n] for n in before
            if CB.route_launches[n] != before[n]}


@pytest.mark.cuda
@pytest.mark.parametrize("k,d,b,t,cin,cout", [
    (3, 1, 1, 64, 64, 64),        # one tile: brings up the descriptors
    (5, 1, 64, 304, 512, 512),    # the training shapes
    (7, 1, 64, 304, 512, 512),
    (5, 1, 6, 301, 384, 640),     # ragged B, T, and C off the tiles
    (7, 1, 6, 301, 640, 384),
    (3, 4, 8, 300, 512, 512),     # dilated
    (5, 1, 3, 37, 40, 512),       # Cin = 40 (feat_dim 40 front layer)
])
def test_conv_sm90_kernels_match_plain(k, d, b, t, cin, cout, cuda_device):
    """K3 v2 and K4 v2 (the "sm90" route) against the plain versions."""
    assert CB.route((b, t, cin), (k, cin, cout), d) == "sm90"
    x, w, g = _conv_inputs(b, t, cin, cout, k, cuda_device)
    before = dict(CB.route_launches)
    dx, dw = CB.conv_dx(g, w, d), CB.conv_dw(x, g, k, d)
    torch.cuda.synchronize()
    assert _routes_delta(before) == {"dx_sm90": 1, "dw_sm90": 1}
    assert (dx.dtype, dw.dtype) == (torch.bfloat16, torch.float32)
    assert _err(dx, CB.conv_dx_reference(g, w, d)) <= BOUND
    assert _err(dw, CB.conv_dw_reference(x, g, k, d)) <= DW_BOUND


@pytest.mark.cuda
@pytest.mark.parametrize("k", [5, 7])
def test_conv_dw_sm90_same_bits_on_every_call(k, cuda_device):
    """K3 v2 sums the cluster's partials in rank order: no atomics, so two
    calls on the same inputs give the same bits."""
    x, _, g = _conv_inputs(64, 304, 512, 512, k, cuda_device, seed=3)
    a = CB.conv_dw(x, g, k, 1)
    b = CB.conv_dw(x, g, k, 1)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_conv_function_grads_match_autograd_of_plain(cuda_device):
    k, d = 5, 1
    x, w, g = _conv_inputs(4, 45, 128, 96, k, cuda_device, seed=1)
    xs, ws = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    CB.conv1d_same_fused_bwd(xs, ws, d).backward(g)
    xr, wr = x.float().requires_grad_(True), w.float().requires_grad_(True)
    CB.conv_fwd_reference(xr, wr, d).backward(g.float())
    assert xs.grad.dtype == ws.grad.dtype == torch.bfloat16
    assert _err(xs.grad, xr.grad) <= BOUND
    assert _err(ws.grad, wr.grad) <= BOUND


@pytest.mark.cuda
def test_conv_kernels_reject_what_they_do_not_take(cuda_device):
    x, w, g = _conv_inputs(2, 40, 16, 16, 3, cuda_device)
    with pytest.raises(ValueError, match="do not take"):
        CB.conv_fwd(x.float(), w.float(), 1)
    with pytest.raises(ValueError, match="contiguous"):
        CB.conv_fwd(x.transpose(0, 1).contiguous().transpose(0, 1), w, 1)
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.empty(x.numel() + 1, dtype=torch.bfloat16,
                           device=cuda_device)
        CB.conv_dx(flat[1:].view(2, 40, 16), w, 1)
    with pytest.raises(ValueError, match="shape"):
        CB.conv_dw(x, g[:, :20].contiguous(), 3, 1)


@pytest.mark.cuda
def test_tiny_train_step_launch_counts(cuda_device, tmp_path):
    """tiny's layer 2 (k=7, 32 channels: k·Cin = 224 > 160) is its one
    wide layer: one K2, one K3 and one K4 call per step, K3 and K4 on the
    "sm90" route."""
    tr = TR.Trainer(TR.TrainConfig(model="tiny", num_targets=5,
                                   compute_dtype="bfloat16"), str(tmp_path))
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(4, 40, 23).astype(np.float16)).to(
        cuda_device)
    y = torch.from_numpy(rng.randint(0, 5, 4).astype(np.int32)).to(
        cuda_device)
    for name in CB.launches:
        CB.launches[name] = 0
    routes = dict(CB.route_launches)
    _, m = tr._step_fn(tr.params, tr.optimizer, tr.state, x, y, 33, 4, 1e-3,
                       1.0, 1.0, torch.Generator(cuda_device))
    torch.cuda.synchronize()
    assert CB.launches == {"fwd": 1, "dw": 1, "dx": 1}
    assert _routes_delta(routes) == {"dw_sm90": 1, "dx_sm90": 1}
    assert np.isfinite(float(m["loss"]))
