"""The host side of K3 v2 and K4 v2 (``csrc/conv_sm90.cu``), on the CPU:
the shape rule that routes K3 and K4 between the two designs, and K3 v2's
split schedule.  The kernels themselves run only on the card
(``tests/test_torch_cuda.py``); their plain versions are held to the JAX
package in ``tests/test_torch_conv_bwd.py``."""

from dataclasses import replace

import numpy as np
import pytest
import torch

from xvector_tpu_torch.models import tdnn as tt
from xvector_tpu_torch.ops import conv_bwd as CB

# cudaOccupancyMaxActiveClusters for K3 v2 on an NVIDIA H100 80GB HBM3
# (700 W), as xvector_tpu_torch/bench/dw_schedule.py printed it; the same
# for bn 128 and 256.  Clusters stay inside a GPC, so S=3 holds 39 (117
# SMs), not 44.
H100_CLUSTERS = {(bn, s): n for bn in (128, 256) for s, n in zip(
    range(1, 9), (132, 66, 39, 30, 22, 17, 15, 15))}


def _wide_layers(cfg):
    """(k, Cin, Cout, dilation) of each layer the model sends to the conv
    kernels: k > 1 and k·Cin > 160 (``models/tdnn.py:_conv1d_same``)."""
    cins = (cfg.feat_dim,) + cfg.channels[:-1]
    return [(k, cin, cout, d) for k, cin, cout, d in
            zip(cfg.kernel_sizes, cins, cfg.channels, cfg.dilations)
            if k > 1 and k * cin > 160]


ZOO = [(name, feat) for name in sorted(tt.MODEL_ZOO) for feat in (23, 40)]
ZOO_SHAPES = sorted({layer for name, feat in ZOO for layer in _wide_layers(
    replace(tt.MODEL_ZOO[name], feat_dim=feat))})


@pytest.mark.parametrize("name,feat", ZOO)
def test_every_wide_zoo_layer_routes_to_sm90(name, feat):
    cfg = replace(tt.MODEL_ZOO[name], feat_dim=feat)
    layers = _wide_layers(cfg)
    assert layers, "every topology has a wide layer"
    for k, cin, cout, d in layers:
        for b, t in ((64, 304), (6, 301), (1, 1)):
            assert CB.route((b, t, cin), (k, cin, cout), d) == "sm90"


def test_feat40_front_layer_is_wide():
    """At feat_dim 40 the k=5 front layer (k·Cin = 200) is wide too."""
    cfg = replace(tt.MODEL_ZOO["no_dropout"], feat_dim=40)
    assert _wide_layers(cfg)[0] == (5, 40, 512, 1)


@pytest.mark.parametrize("cin,cout", [(12, 20), (20, 12), (23, 512),
                                      (512, 1500), (36, 40)])
def test_channels_off_8_route_to_sm80(cin, cout):
    assert CB.route((6, 301, cin), (3, cin, cout), 2) == "sm80"


def test_route_needs_int32_extents():
    assert CB.route((2, 2 ** 31, 64), (3, 64, 64), 1) == "sm80"
    assert CB.route((2, 100, 64), (3, 64, 64), 2 ** 30) == "sm80"


@pytest.mark.parametrize("t", [1, 301, 304])
@pytest.mark.parametrize("b", [1, 6, 64])
@pytest.mark.parametrize("k,cin,cout,d", ZOO_SHAPES)
def test_dw_schedule_covers_every_stage_once(k, cin, cout, d, b, t):
    bn, splits = CB.dw_schedule(k, cin, cout, b, t, H100_CLUSTERS)
    assert bn in (128, 256)
    assert 1 <= splits <= CB.DW_MAX_SPLITS
    stages = CB.dw_stages(b, t)
    ranges = CB.dw_ranges(len(stages), splits)
    assert all(lo < hi for lo, hi in ranges), ranges      # none empty
    covered = [stages[i] for lo, hi in ranges for i in range(lo, hi)]
    want = [(b0, t0) for b0 in range(0, b, CB.DW_BB)
            for t0 in range(0, t, CB.DW_TT)]
    assert sorted(covered) == sorted(want)
    assert len(covered) == len(set(covered))               # exactly once
    # every (b, t) row of the contraction lies in exactly one stage box
    rows = np.zeros((b, t), np.int64)
    for b0, t0 in covered:
        rows[b0:b0 + CB.DW_BB, t0:t0 + CB.DW_TT] += 1
    assert (rows == 1).all()


@pytest.mark.parametrize("k,want", [(5, (256, 5)), (7, (256, 2))])
def test_dw_schedule_at_the_training_shapes(k, want):
    """64×304, 512 → 512 on the H100: k=5 takes 40 tiles of 128×256 in
    clusters of 5 (two waves of 22 clusters, 61 stages a block), k=7 56
    tiles in clusters of 2 (one wave, 152 stages a block): the fastest of
    the 16 schedules the sweep timed at each k."""
    assert CB.dw_schedule(k, 512, 512, 64, 304, H100_CLUSTERS) == want


def test_dw_schedule_skips_clusters_that_do_not_fit():
    clusters = dict(H100_CLUSTERS)
    clusters[(256, 5)] = 0
    assert CB.dw_schedule(5, 512, 512, 64, 304, clusters) != (256, 5)
    with pytest.raises(ValueError, match="no K3 v2 cluster"):
        CB.dw_schedule(5, 512, 512, 64, 304, {})


def test_dw_ranges_are_balanced():
    assert CB.dw_ranges(304, 3) == [(0, 101), (101, 202), (202, 304)]
    assert CB.dw_ranges(5, 4) == [(0, 1), (1, 2), (2, 3), (3, 5)]


def test_sm80_dw_splits_unchanged():
    """The v1 split count of the "sm80" route keeps its behaviour: at the
    training shapes, 13 splits at k=5 and 7 at k=7 on 264 block slots."""
    steps = -(-64 * 304 // 64)
    assert CB.sm80_dw_splits(80, steps, 264) == 13
    assert CB.sm80_dw_splits(112, steps, 264) == 7


def test_plain_versions_leave_route_counts_at_zero():
    before = dict(CB.route_launches), dict(CB.launches)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 9, 16).astype(np.float32))
    w = torch.from_numpy(rng.randn(3, 16, 8).astype(np.float32))
    g = torch.from_numpy(rng.randn(2, 9, 8).astype(np.float32))
    CB.conv_fwd(x, w, 1)
    CB.conv_dx(g, w, 1)
    CB.conv_dw(x, g, 3, 1)
    assert (dict(CB.route_launches), dict(CB.launches)) == before
    assert set(CB.route_launches) == {"fwd_sm90", "fwd_sm80", "dw_sm90",
                                      "dw_sm80", "dx_sm90", "dx_sm80"}


def test_encoder_errors_are_named():
    with pytest.raises(RuntimeError, match="no cuTensorMapEncodeTiled"):
        CB._raise_on(10000, "conv_dw sm90")
    with pytest.raises(RuntimeError, match="CUresult 1"):
        CB._raise_on(10002, "conv_dw sm90")
    with pytest.raises(RuntimeError, match="cudaError 700"):
        CB._raise_on(700, "conv_dw sm90")
    CB._raise_on(0, "conv_dw sm90")


def test_named_design_must_take_the_shape():
    """A caller may name a design (chip_smoke.py times both at one
    shape): "sm80" takes every shape, "sm90" only the shapes route()
    gives it."""
    assert CB._design(None, "sm90") == "sm90"
    assert CB._design(None, "sm80") == "sm80"
    assert CB._design("sm80", "sm90") == "sm80"
    assert CB._design("sm90", "sm90") == "sm90"
    with pytest.raises(ValueError, match="do not take"):
        CB._design("sm90", "sm80")
    with pytest.raises(ValueError, match="unknown design"):
        CB._design("sm70", "sm90")
