"""The host side of K2 v2, K1 v5 and K1's layer-0 kernel
(``csrc/fwd_sm90.cu``), on the CPU: the written rules that route K2 calls
(``ops/conv_bwd.route``) and K1 layers (``ops/tdnn_kernel.layer_route``)
between the designs, the ``design=`` overrides, K1's fold (padding and
layer 0's packed weights), and the launch counters.  The kernels run only
on the card (``tests/test_torch_cuda.py``); their plain versions are held
to the JAX package in ``tests/test_torch_conv_bwd.py`` and
``tests/test_torch_fused_stack.py``."""

from dataclasses import replace

import numpy as np
import pytest
import torch

from xvector_tpu_torch.models import tdnn as tt
from xvector_tpu_torch.ops import conv_bwd as CB
from xvector_tpu_torch.ops import tdnn_kernel as TK

STATS_ZOO = sorted(n for n, c in tt.MODEL_ZOO.items() if TK.supports(c))


def _wide_layers(cfg):
    """(k, Cin, Cout, dilation) of each layer the model sends to the conv
    kernels: k > 1 and k·Cin > 160 (``models/tdnn.py:_conv1d_same``)."""
    cins = (cfg.feat_dim,) + cfg.channels[:-1]
    return [(k, cin, cout, d) for k, cin, cout, d in
            zip(cfg.kernel_sizes, cins, cfg.channels, cfg.dilations)
            if k > 1 and k * cin > 160]


def _layers(cfg):
    cins = (cfg.feat_dim,) + cfg.channels[:-1]
    return list(zip(cins, cfg.channels))


@pytest.mark.parametrize("feat", [23, 40])
@pytest.mark.parametrize("name", sorted(tt.MODEL_ZOO))
def test_every_wide_zoo_k2_call_takes_sm90(name, feat):
    """Each K2 call the model makes (the forward of a wide layer) runs K2
    v2, at the recipe's minibatch and at ragged shapes."""
    cfg = replace(tt.MODEL_ZOO[name], feat_dim=feat)
    for k, cin, cout, d in _wide_layers(cfg):
        for b, t in ((64, 304), (6, 301), (1, 1)):
            shape_route = CB.route((b, t, cin), (k, cin, cout), d)
            assert CB._design(None, shape_route) == "sm90"


@pytest.mark.parametrize("cin,cout,k,d", [(12, 20, 3, 2), (100, 36, 5, 1),
                                          (23, 512, 5, 1), (512, 1500, 3, 1)])
def test_k2_off_8_shapes_take_sm80(cin, cout, k, d):
    shape_route = CB.route((6, 301, cin), (k, cin, cout), d)
    assert CB._design(None, shape_route) == "sm80"
    with pytest.raises(ValueError, match="do not take"):
        CB._design("sm90", shape_route)


LAYER_ROUTES = {
    "no_dropout": ["l0_sm90", "sm90", "sm90", "sm90", "sm90"],
    "etdnn": ["l0_sm90"] + ["sm90"] * 9,       # 512 -> 1500 last, padded
    "tiny": ["l0_sm90", "sm90", "sm90", "sm90", "sm90"],
}


@pytest.mark.parametrize("name", STATS_ZOO)
def test_layer_route_over_the_stats_pooling_zoo(name):
    """Layer 0 (the f32 features) on the layer-0 kernel, every other layer
    on K1 v5 (etdnn's 1500 channels too, padded by the fold): no layer of
    the zoo on K1 v4 but under design="sm80"."""
    cfg = tt.MODEL_ZOO[name]
    got = [TK.layer_route(l, cin, cout, k) for l, ((cin, cout), k) in
           enumerate(zip(_layers(cfg), cfg.kernel_sizes))]
    want = LAYER_ROUTES.get(name, ["l0_sm90"] + ["sm90"] * (len(got) - 1))
    assert got == want
    assert TK._layer_designs(cfg) == want
    assert TK._layer_designs(cfg, "sm80") == ["sm80"] * len(got)


@pytest.mark.parametrize("feat", [23, 40])
def test_layer_zero_stays_on_v4_at_every_feat_dim(feat):
    """Layer 0 reads f32 features, which K1 v5's bf16 operand map does not
    take, so it has its own Hopper kernel at any feat_dim (23, and 40, a
    multiple of 8); it stays on K1 v4 only where the layer does not fit
    that kernel's shared memory (l0_takes: F <= 64 at k = 5).  Channel
    counts off 8 after layer 0 run on K1 v5, padded by the fold."""
    assert TK.layer_route(0, feat, 512, 5) == "l0_sm90"
    assert TK.l0_takes(5, 64) and not TK.l0_takes(5, 72)
    assert TK.layer_route(0, 80, 512, 5) == "sm80"
    assert TK.layer_route(0, 40, 512, 5, 100) == "sm80"   # a wide window
    assert TK.layer_route(1, 512, 512) == "sm90"
    assert TK.layer_route(3, 512, 1500) == "sm90"
    assert TK.layer_route(3, 1500, 512) == "sm90"


def _tiny(seed=0):
    cfg = tt.MODEL_ZOO["tiny"]
    params, state = tt.init_params(torch.Generator().manual_seed(seed), cfg,
                                   10, device="cpu")
    x = torch.from_numpy(np.random.RandomState(seed).randn(
        2, 21, cfg.feat_dim).astype(np.float32))
    return cfg, params, state, x


@pytest.mark.parametrize("name", STATS_ZOO)
def test_naming_sm90_for_a_stack_raises(name):
    """design="sm90" gives every layer of a zoo stack a Hopper design (the
    layer-0 kernel, then K1 v5); it raises only for a layer 0 that the
    layer-0 kernel does not hold (80-dim features), before any work, on
    any device."""
    cfg = tt.MODEL_ZOO[name]
    assert TK._layer_designs(cfg, "sm90") == (
        ["l0_sm90"] + ["sm90"] * (cfg.num_frame_layers - 1))
    wide = replace(cfg, feat_dim=80)
    with pytest.raises(ValueError, match="do not take"):
        TK.fused_frame_stack(wide, None, None,
                             torch.zeros(1, 30, wide.feat_dim), design="sm90")


def test_unknown_design_raises():
    cfg, params, state, x = _tiny()
    with pytest.raises(ValueError, match="unknown design"):
        TK.fused_frame_stack(cfg, params, state, x, design="sm70")


@pytest.mark.parametrize("design", [None, "sm80", "sm90"])
def test_cpu_stack_leaves_counts_unchanged(design):
    """A CPU tensor takes the plain version on any design and launches
    nothing."""
    cfg, params, state, x = _tiny(1)
    before = TK.launches, dict(TK.route_launches)
    got = TK.fused_frame_stack(cfg, params, state, x, design=design)
    assert (TK.launches, dict(TK.route_launches)) == before
    assert set(TK.route_launches) == {"l0_sm90", "sm90", "sm80"}
    torch.testing.assert_close(
        got, TK.fused_frame_stack_reference(cfg, params, state, x),
        rtol=0, atol=0)


@pytest.mark.parametrize("design", [None, "sm80", "sm90"])
def test_cpu_conv_fwd_leaves_counts_unchanged(design):
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(2, 9, 16).astype(np.float32))
    w = torch.from_numpy(rng.randn(3, 16, 8).astype(np.float32))
    before = dict(CB.route_launches), dict(CB.launches)
    got = CB.conv_fwd(x, w, 2, design=design)
    assert (dict(CB.route_launches), dict(CB.launches)) == before
    torch.testing.assert_close(got, CB.conv_fwd_reference(x, w, 2),
                               rtol=0, atol=0)


@pytest.mark.parametrize("feat,kpad", [(4, 64), (23, 128), (40, 256)])
def test_fold_pads_channels_and_packs_layer_zero(feat, kpad):
    """Channel counts go up to multiples of 8 with zero columns, the next
    layer's input rows follow, and W0 is layer 0's (k, F, Cout') weights as
    (kpad, Cout') in (tap, channel) row order with zero rows after k·F."""
    cfg = replace(tt.MODEL_ZOO["tiny"], feat_dim=feat,
                  channels=(20, 32, 12, 32, 100), activation="prelu")
    params, state = tt.init_params(torch.Generator().manual_seed(3), cfg, 10,
                                   device="cpu")
    folded = TK.fold_stack(cfg, params, state)
    shapes = [tuple(layer[0].shape) for layer in folded.layers]
    assert shapes == [(5, feat, 24), (5, 24, 32), (7, 32, 16), (1, 16, 32),
                      (1, 32, 104)]
    assert folded.out_dim == 100
    for (w, b, scale, shift, alpha), cout in zip(folded.layers,
                                                 cfg.channels):
        assert w.dtype == torch.bfloat16 and not w[..., cout:].any()
        for v in (b, scale, shift, alpha):
            assert v.dtype == torch.float32 and not v[cout:].any()
    assert not folded.layers[3][0][:, 12:].any()    # rows of 12 -> 16
    w0 = folded.w0
    assert w0.shape == (kpad, 24) and not w0[5 * feat:].any()
    torch.testing.assert_close(w0[:5 * feat], folded.layers[0][0].reshape(
        5 * feat, 24), rtol=0, atol=0)
    assert [tuple(layer[0].shape)[1:] for layer in TK.fold_stack(
        cfg, params, state, pad=False).layers] == [
            (feat, 20), (20, 32), (32, 12), (12, 32), (32, 100)]


@pytest.mark.parametrize("act", ["relu", "lrelu", "prelu"])
def test_packed_layer_zero_equals_its_shifted_sum(act):
    """l0_reference (im2col of the masked bf16 features times the K-padded
    W0) against layer 0 written as k shifted products: the same bf16
    operands, only the f32 summation order differs."""
    cfg = replace(tt.MODEL_ZOO["tiny"], activation=act)
    params, state = tt.init_params(torch.Generator().manual_seed(4), cfg, 10,
                                   device="cpu")
    folded = TK.fold_stack(cfg, params, state)
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(3, 40, 23).astype(np.float32))
    mask = torch.from_numpy((rng.rand(3, 40) > 0.3).astype(np.float32))
    got = TK.l0_reference(cfg, folded, x, mask)
    w, b, scale, shift, alpha = folded.layers[0]
    m = mask[..., None]
    hp = torch.nn.functional.pad((x * m).to(torch.bfloat16).float(),
                                 (0, 0, 2, 2))
    y = sum(hp[:, j: j + 40] @ w[j].float() for j in range(5))
    want = TK._epilogue(cfg, y, b, scale, shift, alpha, m)
    assert got.shape == want.shape == (3, 40, 32)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert not got[mask == 0].any()
    torch.testing.assert_close(
        TK.fused_layer(cfg, folded, 0, x, mask), got, rtol=0, atol=0)
