"""Port's SAME conv forward/backward (xvector_tpu_torch.ops.conv_bwd: the
plain versions of K2, K3 and K4 and the autograd Function) against the JAX
package's ops/conv_bwd on the same numpy inputs, on CPU tensors.

Referees: the XLA shifted-dot lowering and its ``jax.vjp`` (ROADMAP C1),
and the Pallas kernels ``_pallas_fwd``, ``_pallas_dw`` and ``_pallas_dx``
in interpret mode at tests/test_conv_bwd.py's cases.  Tolerances are those
of tests/test_conv_bwd.py: 1e-5 for the forward, 1e-4 for dx and dW (rtol
and atol; f32 sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xvector_tpu.ops import conv_bwd as JCB
from xvector_tpu_torch.models import tdnn as tt
from xvector_tpu_torch.ops import conv_bwd as CB

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
BWD_TOL = dict(rtol=1e-4, atol=1e-4)

PALLAS_CASES = [(5, 1, 128, 128), (7, 1, 128, 256), (3, 3, 128, 128),
                (5, 2, 128, 128)]
# (k, d, cin, cout, B, T): ragged T, B and C, rows shorter than the taps'
# reach, a single frame
RAGGED_CASES = [(5, 1, 24, 40, 3, 29), (7, 1, 16, 8, 2, 11),
                (3, 4, 8, 24, 5, 7), (5, 1, 12, 20, 1, 1),
                (3, 2, 20, 12, 2, 9)]


def _inputs(b, t, cin, cout, k, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, t, cin).astype(np.float32)
    w = (0.05 * rng.randn(k, cin, cout)).astype(np.float32)
    g = rng.randn(b, t, cout).astype(np.float32)
    return x, w, g


def _xla_vjp(x, w, g, d):
    t = x.shape[1]
    y, f = jax.vjp(lambda x, w: JCB._fwd_shifted_dots(x, w, d, t),
                   jnp.asarray(x), jnp.asarray(w))
    dx, dw = f(jnp.asarray(g))
    return np.asarray(y), np.asarray(dx), np.asarray(dw)


def _port_function(x, w, g, d):
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    y = CB.conv1d_same_fused_bwd(xt, wt, d)
    y.backward(torch.from_numpy(g))
    return y.detach().numpy(), xt.grad.numpy(), wt.grad.numpy()


@pytest.mark.parametrize("k,d,cin,cout,b,t",
                         [(*c, 8, 32) for c in PALLAS_CASES] + RAGGED_CASES)
def test_plain_and_function_match_xla_vjp(k, d, cin, cout, b, t):
    x, w, g = _inputs(b, t, cin, cout, k)
    y_ref, dx_ref, dw_ref = _xla_vjp(x, w, g, d)
    xt, wt, gt = map(torch.from_numpy, (x, w, g))
    np.testing.assert_allclose(CB.conv_fwd_reference(xt, wt, d).numpy(),
                               y_ref, **FWD_TOL)
    np.testing.assert_allclose(CB.conv_dx_reference(gt, wt, d).numpy(),
                               dx_ref, **BWD_TOL)
    np.testing.assert_allclose(CB.conv_dw_reference(xt, gt, k, d).numpy(),
                               dw_ref, **BWD_TOL)
    y, dx, dw = _port_function(x, w, g, d)
    np.testing.assert_allclose(y, y_ref, **FWD_TOL)
    np.testing.assert_allclose(dx, dx_ref, **BWD_TOL)
    np.testing.assert_allclose(dw, dw_ref, **BWD_TOL)


@pytest.mark.parametrize("k,d,cin,cout", PALLAS_CASES)
def test_plain_versions_match_pallas_interpret(k, d, cin, cout):
    b, t = 8, 32
    x, w, g = _inputs(b, t, cin, cout, k, seed=1)
    left = (k - 1) // 2 * d
    right = (k - 1) * d - left
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (left, JCB._TPAD - left), (0, 0)))
    gp = jnp.pad(jnp.asarray(g), ((0, 0), (right, JCB._TPAD - right),
                                  (0, 0)))
    w2d = jnp.asarray(w).reshape(k * cin, cout)
    y_ref = JCB._pallas_fwd(xp, w2d, k, d, t, jnp.float32, interpret=True)
    dw_ref = JCB._pallas_dw(xp, jnp.asarray(g), k, d, interpret=True)
    dx_ref = JCB._pallas_dx(gp, w2d, k, d, t, jnp.float32, interpret=True)
    xt, wt, gt = map(torch.from_numpy, (x, w, g))
    np.testing.assert_allclose(CB.conv_fwd_reference(xt, wt, d).numpy(),
                               np.asarray(y_ref), **FWD_TOL)
    np.testing.assert_allclose(
        CB.conv_dw_reference(xt, gt, k, d).reshape(k * cin, cout).numpy(),
        np.asarray(dw_ref), **BWD_TOL)
    np.testing.assert_allclose(CB.conv_dx_reference(gt, wt, d).numpy(),
                               np.asarray(dx_ref), **BWD_TOL)


def test_bf16_rounds_once_like_the_pallas_forward():
    """bf16 operands, f32 sums, one rounding: the plain forward and dx
    agree with the interpreted Pallas kernels on bf16 inputs to one bf16
    ulp (2^-7 relative: f32 sums in another order can land on either side
    of a rounding boundary)."""
    k, d, cin, cout, b, t = 5, 1, 128, 128, 8, 32
    x, w, g = _inputs(b, t, cin, cout, k, seed=2)
    xb, wb, gb = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, g))
    left = (k - 1) // 2 * d
    xp = jnp.pad(xb, ((0, 0), (left, JCB._TPAD - left), (0, 0)))
    gp = jnp.pad(gb, ((0, 0), (left, JCB._TPAD - left), (0, 0)))
    w2d = wb.reshape(k * cin, cout)
    y_ref = np.asarray(JCB._pallas_fwd(xp, w2d, k, d, t, jnp.bfloat16,
                                       interpret=True), np.float32)
    dx_ref = np.asarray(JCB._pallas_dx(gp, w2d, k, d, t, jnp.bfloat16,
                                       interpret=True), np.float32)
    dw_ref = np.asarray(JCB._pallas_dw(xp, gb, k, d, interpret=True))
    xt, wt, gt = (torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16) for a in (xb, wb, gb))
    y = CB.conv_fwd_reference(xt, wt, d)
    dx = CB.conv_dx_reference(gt, wt, d)
    assert y.dtype == dx.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(), y_ref, rtol=2 ** -7,
                               atol=1e-6)
    np.testing.assert_allclose(dx.float().numpy(), dx_ref, rtol=2 ** -7,
                               atol=1e-6)
    np.testing.assert_allclose(
        CB.conv_dw_reference(xt, gt, k, d).reshape(k * cin, cout).numpy(),
        dw_ref, **BWD_TOL)


@pytest.mark.parametrize("k,d", [(3, 2), (5, 1), (4, 1)])
def test_function_gradcheck_f64(k, d):
    rng = np.random.RandomState(k)
    x = torch.from_numpy(rng.randn(2, 6, 3)).requires_grad_(True)
    w = torch.from_numpy(rng.randn(k, 3, 4)).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda x, w: CB.conv1d_same_fused_bwd(x, w, d), (x, w))


def test_backward_skips_dx_when_x_needs_no_grad(monkeypatch):
    calls = []
    monkeypatch.setattr(CB, "conv_dx",
                        lambda *a: calls.append(a) or CB.conv_dx_reference(*a))
    x, w, g = _inputs(2, 9, 8, 8, 3)
    wt = torch.from_numpy(w).requires_grad_(True)
    CB.conv1d_same_fused_bwd(torch.from_numpy(x), wt, 1).backward(
        torch.from_numpy(g))
    assert wt.grad is not None and calls == []


def test_supports_and_cpu_counts():
    bf16 = torch.bfloat16
    assert CB.supports((64, 304, 512), (5, 512, 512), 1, bf16)
    assert CB.supports((6, 301, 384), (7, 384, 640), 3, bf16)
    assert not CB.supports((64, 304, 512), (5, 512, 512), 1, torch.float32)
    assert not CB.supports((64, 304, 256), (5, 512, 512), 1, bf16)
    assert not CB.supports((64, 304, 512), (5, 512, 512), 0, bf16)
    before = dict(CB.launches)
    x, w, g = _inputs(2, 9, 8, 8, 3)
    _port_function(x, w, g, 1)
    assert CB.launches == before        # plain versions launch nothing


@pytest.mark.parametrize("dtype,fused_calls", [(torch.bfloat16, 1),
                                               (torch.float32, 0)])
def test_model_routes_wide_bf16_layers(monkeypatch, dtype, fused_calls):
    """With fused_bwd, a k > 1 layer with k·Cin > 160 in bf16 takes the
    Function; f32, k = 1 and k·Cin ≤ 160 take the matmul lowerings."""
    calls = []
    real = CB.conv1d_same_fused_bwd
    monkeypatch.setattr(CB, "conv1d_same_fused_bwd",
                        lambda x, w, d: calls.append(w.shape) or real(x, w, d))
    w = torch.randn(5, 40, 8, dtype=dtype)
    x = torch.randn(2, 12, 40, dtype=dtype)
    for fused in (True, False):
        tt._conv1d_same(x, w, 1, fused_bwd=fused)
    tt._conv1d_same(x[..., :23], w[:, :23], 1, fused_bwd=True)
    tt._conv1d_same(x, w[:1], 1, fused_bwd=True)
    assert len(calls) == fused_calls


def test_kernel_path_refuses_non_cuda_tensors():
    x = torch.zeros(2, 8, 16, dtype=torch.bfloat16, device="meta")
    w = torch.zeros(3, 16, 8, dtype=torch.bfloat16, device="meta")
    with pytest.raises(RuntimeError, match="cuda"):
        CB.conv_fwd(x, w, 1)
