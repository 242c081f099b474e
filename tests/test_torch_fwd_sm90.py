"""The host side of K2 v2 and K1 v5 (``csrc/fwd_sm90.cu``), on the CPU: the
written rules that route K2 calls (``ops/conv_bwd.route``) and K1 layers
(``ops/tdnn_kernel.layer_route``) between the "sm90" and "sm80" designs,
the ``design=`` overrides, and the launch counters.  The kernels run only
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
    "no_dropout": ["sm80", "sm90", "sm90", "sm90", "sm90"],
    "etdnn": ["sm80"] + ["sm90"] * 8 + ["sm80"],      # 512 -> 1500 last
    "tiny": ["sm80", "sm90", "sm90", "sm90", "sm90"],
}


@pytest.mark.parametrize("name", STATS_ZOO)
def test_layer_route_over_the_stats_pooling_zoo(name):
    """Layer 0 (the f32 features) and channel counts off 8 on K1 v4, every
    other layer on K1 v5."""
    cfg = tt.MODEL_ZOO[name]
    got = [TK.layer_route(l, cin, cout)
           for l, (cin, cout) in enumerate(_layers(cfg))]
    want = LAYER_ROUTES.get(name, ["sm80"] + ["sm90"] * (len(got) - 1))
    assert got == want
    assert TK._layer_designs(cfg) == want
    assert TK._layer_designs(cfg, "sm80") == ["sm80"] * len(got)


@pytest.mark.parametrize("feat", [23, 40])
def test_layer_zero_stays_on_v4_at_every_feat_dim(feat):
    """Even at feat_dim 40 (a multiple of 8) layer 0 reads f32 features,
    which K1 v5's bf16 operand map does not take."""
    assert TK.layer_route(0, feat, 512) == "sm80"
    assert TK.layer_route(1, 512, 512) == "sm90"
    assert TK.layer_route(3, 512, 1500) == "sm80"
    assert TK.layer_route(3, 1500, 512) == "sm80"


def _tiny(seed=0):
    cfg = tt.MODEL_ZOO["tiny"]
    params, state = tt.init_params(torch.Generator().manual_seed(seed), cfg,
                                   10, device="cpu")
    x = torch.from_numpy(np.random.RandomState(seed).randn(
        2, 21, cfg.feat_dim).astype(np.float32))
    return cfg, params, state, x


@pytest.mark.parametrize("name", STATS_ZOO)
def test_naming_sm90_for_a_stack_raises(name):
    """Layer 0 never takes K1 v5, so no stack runs "sm90" on every layer;
    the refusal comes before any work, on any device."""
    cfg = tt.MODEL_ZOO[name]
    with pytest.raises(ValueError, match="do not take"):
        TK.fused_frame_stack(cfg, None, None,
                             torch.zeros(1, 30, cfg.feat_dim), design="sm90")


def test_unknown_design_raises():
    cfg, params, state, x = _tiny()
    with pytest.raises(ValueError, match="unknown design"):
        TK.fused_frame_stack(cfg, params, state, x, design="sm70")


@pytest.mark.parametrize("design", [None, "sm80"])
def test_cpu_stack_leaves_counts_unchanged(design):
    """A CPU tensor takes the plain version on either design and launches
    nothing."""
    cfg, params, state, x = _tiny(1)
    before = TK.launches, dict(TK.route_launches)
    got = TK.fused_frame_stack(cfg, params, state, x, design=design)
    assert (TK.launches, dict(TK.route_launches)) == before
    assert set(TK.route_launches) == {"sm90", "sm80"}
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
