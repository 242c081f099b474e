"""The frozen plain reference against xvector_tpu_torch's CPU path at a tiny
size, in float32, at the port's parity tolerances (model forward 1e-4,
gradients 1e-4)."""

import numpy as np
import pytest
import torch

from xvbench import generate
from xvbench.reference import features as rf, lowp, tdnn as ref
from xvbench.tests.tiny import TINY

from xvector_tpu_torch.extract.extractor import (ExtractorConfig,
                                                 XvectorExtractor)
from xvector_tpu_torch.models import heads, tdnn
from xvector_tpu_torch.models.convert import tree_leaves
from xvector_tpu_torch.ops import features as pf
from xvector_tpu_torch.train.optim import make_optimizer

ETDNN_TINY = dict(TINY, preset="etdnn",
                  kernel_sizes=[5, 1, 3, 1, 3, 1, 3, 1, 1, 1],
                  dilations=[1, 1, 2, 1, 3, 1, 4, 1, 1, 1],
                  channels=[32] * 9 + [90])


def _zoo(cfg):
    return tdnn.TdnnConfig(
        name=cfg["preset"], feat_dim=cfg["feat_dim"],
        kernel_sizes=tuple(cfg["kernel_sizes"]),
        dilations=tuple(cfg["dilations"]), channels=tuple(cfg["channels"]),
        embed_dims=tuple(cfg["embed_dims"]))


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("cfg", [TINY, ETDNN_TINY], ids=["tdnn", "etdnn"])
def test_train_loss_and_gradients_match_the_port(cfg):
    params, stats = generate.weights(cfg, 5, "cpu")
    g = torch.Generator().manual_seed(1)
    x = torch.randn(6, 40, 23, generator=g)
    y = torch.randint(0, cfg["num_targets"], (6,), generator=g)
    port = {k: v for k, v in params.items()}
    leaves = tree_leaves(port)
    for p in leaves:
        p.requires_grad_(True)
    out = tdnn.apply(_zoo(cfg), port, stats, x, train=True,
                     compute_dtype=torch.float32)
    loss_p = heads.softmax_ce(out["logits"], y)
    grads_p = torch.autograd.grad(loss_p, ref.leaves(port))
    for p in leaves:
        p.requires_grad_(False)
    mine, _ = generate.weights(cfg, 5, "cpu")
    flat = ref.leaves(mine)
    for p in flat:
        p.requires_grad_(True)
    loss_r = ref.train_loss(cfg, mine, x, y)
    grads_r = torch.autograd.grad(loss_r, flat)
    lp, lr = float(loss_p.detach()), float(loss_r.detach())
    assert abs(lp - lr) <= 1e-4 * abs(lr)
    for gp, gr in zip(grads_p, grads_r):
        assert _rel(gp, gr) <= 1e-4


def test_adam_matches_torch_adam():
    g = torch.Generator().manual_seed(2)
    a = [torch.randn(7, 3, generator=g) for _ in range(2)]
    b = [t.clone() for t in a]
    opt_p = make_optimizer("adam", b, 1e-3)
    opt_r = ref.Adam(a, 1e-3)
    for _ in range(4):
        grads = [torch.randn(7, 3, generator=g) for _ in range(2)]
        for p, gr in zip(b, grads):
            p.grad = gr.clone()
        opt_p.step()
        opt_r.step(grads)
    for p, r in zip(b, a):
        assert torch.allclose(p, r, rtol=0, atol=1e-7)


def test_sliding_cmvn_and_voiced_selection_match_the_port():
    g = torch.Generator().manual_seed(3)
    for t in (50, 299, 300, 777):
        x = torch.randn(t, 23, generator=g) + 4.0
        assert torch.allclose(rf.sliding_cmvn(x, 300),
                              pf.sliding_cmvn(x, 300), atol=1e-5)
    vad = (torch.rand(777, generator=g) > 0.3).float()
    assert torch.equal(rf.select_voiced(x, vad), torch.from_numpy(
        pf.select_voiced_frames(x.numpy(), vad.numpy())))


@pytest.mark.parametrize("cfg", [TINY, ETDNN_TINY], ids=["tdnn", "etdnn"])
def test_chunked_xvectors_match_the_port(cfg):
    ext = dict(cfg["extract"], max_chunk=120)
    params, stats = generate.weights(cfg, 6, "cpu")
    ex = XvectorExtractor(_zoo(cfg), params, stats,
                          ExtractorConfig(min_chunk=25, max_chunk=120,
                                          batch_size=3), device="cpu")
    rng = np.random.default_rng(0)
    utts = [(f"u{i}", rng.standard_normal((n, 23)).astype(np.float32))
            for i, n in enumerate((30, 119, 260, 361))]
    got = ex.extract(iter(utts))
    for utt, feats in utts:
        x = torch.from_numpy(feats)
        want = None
        for off, ln in rf.chunks(len(x), 25, 120):
            h = ref.frame_stack_eval(cfg, params, stats, x[None, off:off + ln])
            xv = ref.embed_eval(params, ref.stats_pool(h))[0] * ln
            want = xv if want is None else want + xv
        want = want / sum(ln for _, ln in rf.chunks(len(x), 25, 120))
        assert _rel(torch.from_numpy(got[utt]), want) <= 1e-4
    # the whole chain from raw features and VAD
    vad = torch.ones(361)
    vad[100:140] = 0
    one = rf.xvector(cfg, params, stats, torch.from_numpy(utts[3][1]), vad,
                     ext)
    assert one is not None and torch.isfinite(one).all()


def test_fp8_control_rounds_and_differs():
    x = torch.linspace(-3, 3, 1001)
    q = lowp.round_to(x, lowp.E4M3, lowp.E4M3_MAX)
    assert 0 < float((q - x).abs().max()) <= 3 * 2 ** -3
    assert len(torch.unique(q)) < 256
