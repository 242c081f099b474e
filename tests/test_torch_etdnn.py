"""E-TDNN (``MODEL_ZOO["etdnn"]``) on the port's training path, on the CPU.

The dense block step at E-TDNN's kernel sizes and dilations, 64 channels
wide (k·Cin = 192 > 160, so the three dilated k = 3 layers take the fused
route: the plain K2-K4 of ``ops/conv_bwd``), against the benchmark's plain
reference (``xvbench/reference/tdnn.py``) from the same seeded weights and
data; the route counter and the ``xv.model.frame`` span; the benchmark's
configuration file against the preset.
"""

import json
import os
from dataclasses import replace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from xvector_tpu_torch.models import tdnn
from xvector_tpu_torch.models.convert import tree_leaves
from xvector_tpu_torch.ops import conv_bwd
from xvector_tpu_torch.train import trainer as TR
from xvector_tpu_torch.train.optim import make_optimizer
from xvector_tpu_torch.utils import profiling
from xvbench import generate, harness
from xvbench.reference import tdnn as ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDE = 64
NUM_CLASSES = 20
ROWS, FRAMES = 8, 40
LR = 1e-3
CFG = replace(tdnn.MODEL_ZOO["etdnn"], channels=(WIDE,) * 9 + (96,),
              embed_dims=(WIDE, WIDE))
ROUTES = ["unfold", "dense", "fused", "dense", "fused", "dense", "fused",
          "dense", "dense", "dense"]


def _cfg_dict():
    return {"feat_dim": CFG.feat_dim, "kernel_sizes": list(CFG.kernel_sizes),
            "dilations": list(CFG.dilations), "channels": list(CFG.channels),
            "embed_dims": list(CFG.embed_dims), "num_targets": NUM_CLASSES}


def _weights(seed=2**31 + 19):
    return generate.weights(_cfg_dict(), seed, torch.device("cpu"))


def _batches(n, seed=7):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((n, ROWS, FRAMES, CFG.feat_dim), generator=g),
            torch.randint(0, NUM_CLASSES, (n, ROWS), generator=g))


def _port_block(params, state, xs, ys, monkeypatch):
    """The port's dense block step in f32 with the fused route (the card's
    rule takes bf16 only; on the CPU the plain K2-K4 take any dtype, so
    the rule is widened to f32 here).  Returns the block's mean loss, the
    first step's gradients and the parameters after the first update."""
    monkeypatch.setattr(conv_bwd, "supports",
                        lambda *a: a[3] == torch.float32)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    opt = make_optimizer("adam", tree_leaves(params), LR)
    leaves = ref.leaves(params)           # the reference's order
    seen = {}

    def hook(optimizer, args, kwargs):
        if "grads" not in seen:
            seen["grads"] = [p.grad.detach().clone() for p in leaves]
            seen["after"] = [p.detach().clone() for p in leaves]

    opt.register_step_post_hook(hook)
    block = TR.make_block_train_step(
        CFG, TR.TrainConfig(model="etdnn", num_targets=NUM_CLASSES,
                            compute_dtype="float32", fused_conv_bwd=True),
        dense=True)
    before = dict(tdnn.route_calls)
    _, metrics = block(params, opt, state, xs, ys, [FRAMES] * len(xs),
                       [ROWS] * len(xs), LR, 1.0, 1.0, None)
    got = {k: tdnn.route_calls[k] - before[k] for k in before}
    assert got == {"unfold": len(xs), "dense": 6 * len(xs),
                   "fused": 3 * len(xs), "shifted": 0}
    return float(metrics["loss"]), seen["grads"], seen["after"]


def test_dense_block_step_matches_the_plain_reference(monkeypatch):
    params, state = _weights()
    (ref_params, _), (ref_one, _) = _weights(), _weights()
    theta0 = [p.detach().clone() for p in ref.leaves(ref_params)]
    xs, ys = _batches(2)
    loss, grads, after = _port_block(params, state, xs, ys, monkeypatch)
    with ref.float32_exact():
        out = ref.train_steps(_cfg_dict(), ref_params,
                              [(xs[0], ys[0]), (xs[1], ys[1])], LR)
        ref.train_steps(_cfg_dict(), ref_one, [(xs[0], ys[0])], LR)
    # forward: the block's mean loss, at the port's model-forward
    # tolerance (1e-4, test_torch_parity.py): both sum in f32, in other
    # orders, through ten batch-normed layers
    want = sum(out["losses"]) / 2
    assert abs(loss - want) <= 1e-4 * abs(want)
    # first gradients, leaf by leaf, at the port's dx/dw tolerance (1e-4,
    # test_conv_bwd.py), relative to the larger of the leaf's norm and the
    # median leaf's: a leaf whose gradient is a residual of cancelling
    # sums (a bias before batch norm) has no digits of its own to compare
    norms = [float(g.norm()) for g in out["first_grad"]]
    med = sorted(norms)[len(norms) // 2]
    for g, r, n in zip(grads, out["first_grad"], norms):
        assert float((g - r).norm()) <= 1e-4 * max(n, med)
    # one Adam update, leaf by leaf, over the elements whose reference
    # gradient stands above 1% of its leaf's RMS, relative to the update's
    # own size.  Adam's first step is lr·g/(|g| + eps), about lr·sign(g),
    # so the 1e-4 is the update's: what it holds is the direction of every
    # element and lr.  An element whose gradient is a round-off residual (a
    # bias before a ReLU unit that is open on every row, then batch norm,
    # cancels exactly) has no sign of its own: the gradient check above
    # holds those to 1e-4 of the leaf
    for p, r, p0, g in zip(after, ref.leaves(ref_one), theta0,
                           out["first_grad"]):
        big = g.abs() > 1e-2 * g.norm() / g.numel() ** 0.5
        step = (r - p0)[big].norm()
        assert float((p - r)[big].norm()) <= 1e-4 * float(step)


@pytest.mark.parametrize("dtype,want", [
    (torch.bfloat16, {"unfold": 1, "dense": 6, "fused": 3, "shifted": 0}),
    (torch.float32, {"unfold": 1, "dense": 6, "fused": 0, "shifted": 3}),
])
def test_one_forward_counts_each_route(dtype, want):
    params, state = _weights()
    x, _ = _batches(1)
    before = dict(tdnn.route_calls)
    tdnn.apply(CFG, params, state, x[0], train=True, compute_dtype=dtype,
               fused_conv_bwd=True)
    assert {k: tdnn.route_calls[k] - before[k] for k in before} == want


def _frame_spans(prof):
    return [ev for ev in prof.profiler.kineto_results.events()
            if ev.name() == "xv.model.frame"]


def test_each_frame_layer_is_one_span_with_its_args(monkeypatch):
    params, state = _weights()
    x, _ = _batches(1)
    opened = []

    def recording(name, args=None):
        ctx = profiling.span(name, args)
        opened.append((name, args, ctx is profiling.span("xv.other")))
        return ctx

    monkeypatch.setattr(tdnn, "span", recording)

    def forward():
        tdnn.apply(CFG, params, state, x[0], train=True,
                   compute_dtype=torch.bfloat16, fused_conv_bwd=True)

    forward()                          # no profiler: the null context
    assert opened == [("xv.model.frame", None, True)] * 10
    opened.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        forward()
    assert len(_frame_spans(prof)) == 10
    assert [(n, a) for n, a, null in opened if not null] == [
        ("xv.model.frame",
         f"layer={i} k={k} dilation={d} route={r}")
        for i, (k, d, r) in enumerate(zip(CFG.kernel_sizes, CFG.dilations,
                                          ROUTES))]
    opened.clear()
    forward()                          # off again after the profile
    assert all(null for _, _, null in opened)


@pytest.mark.parametrize("key,value", [(None, None), ("dilations", [1] * 10),
                                       ("channels", [512] * 10)])
def test_benchmark_configuration_is_the_preset(key, value):
    with open(os.path.join(ROOT, "xvbench", "configs", "etdnn.json")) as f:
        cfg = json.load(f)
    assert cfg["preset"] == "etdnn" and cfg["reduced"] == []
    if key is None:
        harness.check_preset(cfg, tdnn.MODEL_ZOO["etdnn"])
        return
    cfg[key] = value
    with pytest.raises(RuntimeError, match=key):
        harness.check_preset(cfg, tdnn.MODEL_ZOO["etdnn"])
