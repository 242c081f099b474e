"""The output check sees faults: the rest of a run, at small sizes on the
CPU with the card check skipped, with the timed path broken underneath,
reads ``correct`` false by the cells' own limits; the control (the
reference a precision step down, in the program's place) fails them too."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from xvbench import control, harness
from xvbench.drivers import extract_feats, train_egs
from xvbench.tests import tiny

TRAIN_LIMITS = harness.load_json(harness.HERE, "limits",
                                 "no_dropout.train_egs.json")
EXTRACT_LIMITS = harness.load_json(harness.HERE, "limits",
                                   "no_dropout.extract_feats.json")


@pytest.fixture
def medium(monkeypatch):
    tiny.widen_tiny(monkeypatch)


def _train(limits, **kw):
    ctx = tiny.context(tiny.MEDIUM_TRAIN, limits, cfg=tiny.MEDIUM, **kw)
    try:
        return train_egs.run(ctx)
    finally:
        harness.cleanup(ctx)


def _extract(limits, **kw):
    ctx = tiny.context(tiny.EXTRACT, limits, **kw)
    try:
        return extract_feats.run(ctx)
    finally:
        harness.cleanup(ctx)


def test_sound_training_passes(medium):
    r = _train(TRAIN_LIMITS)
    assert r["correct"], r["checks"]


def test_step_that_leaves_the_state_unchanged_fails(medium, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, *a, **k: None)
    r = _train(TRAIN_LIMITS)
    assert not r["correct"]
    assert r["checks"]["step_gap"]["value"] == pytest.approx(1.0)


def test_half_of_each_batch_left_out_fails(medium, monkeypatch):
    from xvector_tpu_torch.parallel import launch
    real = launch.local_rows

    def half(batches, mesh):
        for x, y, t, *rest in real(batches, mesh):
            n = x.shape[0] // 2
            yield x[:n], y[:n], t
    monkeypatch.setattr(launch, "local_rows", half)
    r = _train(TRAIN_LIMITS)
    assert not r["correct"], r["checks"]


def test_sound_tiny_extraction_passes():
    r = _extract(EXTRACT_LIMITS)
    assert r["correct"] and r["failed"] == 0, r["checks"]


def test_an_altered_answer_fails(monkeypatch):
    from xvector_tpu_torch.extract import extractor as X
    real = X.XvectorExtractor.extract_iter

    def altered(self, stream):
        for i, (utt, xv) in enumerate(real(self, stream)):
            yield utt, (xv * np.float32(0.9) if i % 3 == 0 else xv)
    monkeypatch.setattr(X.XvectorExtractor, "extract_iter", altered)
    r = _extract(EXTRACT_LIMITS)
    assert not r["correct"], r["checks"]


def test_a_lost_answer_fails(monkeypatch):
    from xvector_tpu_torch.extract import extractor as X
    real = X.XvectorExtractor.extract_iter

    def lossy(self, stream):
        for i, item in enumerate(real(self, stream)):
            if i != 5:
                yield item
    monkeypatch.setattr(X.XvectorExtractor, "extract_iter", lossy)
    r = _extract(EXTRACT_LIMITS)
    assert not r["correct"] and r["failed"] >= 1


@pytest.mark.parametrize("traffic,cfg,limits", [
    (tiny.MEDIUM_TRAIN, tiny.MEDIUM, TRAIN_LIMITS),
    (tiny.EXTRACT, tiny.TINY, EXTRACT_LIMITS)], ids=["train", "extract"])
def test_the_fp8_control_fails_the_limits(traffic, cfg, limits):
    ctx = tiny.context(traffic, limits, cfg=cfg)
    try:
        got = control.readings(ctx, ctx.seed, torch.device("cpu"))
    finally:
        harness.cleanup(ctx)
    checks = harness.verdict(got["control_fp8"], limits)
    assert not harness.correct(checks), checks


_RANK = r"""
import os, sys, json
sys.path.insert(0, {root!r})
from xvbench import harness
from xvbench.tests import tiny
from xvbench.drivers import train_egs
from dataclasses import replace
from xvector_tpu_torch.models import tdnn
from xvector_tpu_torch.parallel import launch, mesh as M
if os.environ.get("XVBENCH_FAULT") == "no_exchange":
    M.all_reduce_flat = lambda tensors, group: list(tensors)
if (os.environ.get("XVBENCH_FAULT") == "jax_on_rank_1"
        and os.environ["XVEC_PROCESS_ID"] == "1"):
    import types
    sys.modules["jax"] = types.ModuleType("jax")
tdnn.MODEL_ZOO["tiny"] = replace(
    tdnn.MODEL_ZOO["tiny"], channels=tuple(tiny.MEDIUM["channels"]),
    embed_dims=tuple(tiny.MEDIUM["embed_dims"]))
traffic = dict(tiny.MEDIUM_TRAIN, ranks=2)
ctx = tiny.context(traffic, json.loads(os.environ["LIMITS"]),
                   cfg=tiny.MEDIUM, tmp=os.environ["XVBENCH_WORK"])
dev, mesh = launch.join("cpu")
train_egs._body(ctx, dev, mesh)
"""


@pytest.mark.parametrize("fault", [None, "no_exchange", "jax_on_rank_1"])
def test_two_gloo_ranks_and_the_exchange_left_out(tmp_path, fault):
    limits = harness.load_json(harness.HERE, "limits",
                               "no_dropout.train_egs.4gpu.json")
    env = dict(os.environ, XVBENCH_WORK=str(tmp_path), XVEC_BACKEND="gloo",
               XVEC_NUM_PROCESSES="2", OMP_NUM_THREADS="2",
               XVEC_COORDINATOR="file://" + str(tmp_path / "rdv"),
               LIMITS=json.dumps(limits))
    if fault:
        env["XVBENCH_FAULT"] = fault
    code = _RANK.format(root=harness.ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              env=dict(env, XVEC_PROCESS_ID=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    if fault == "jax_on_rank_1":
        # rank 0 reports no result when any rank loaded JAX
        assert procs[0].returncode == 4, outs[0][1][-3000:]
        assert "rank 1: jax" in outs[0][1]
        assert not (tmp_path / "result.json").exists()
        return
    assert all(p.returncode == 0 for p in procs), outs[0][1][-3000:]
    result = json.loads((tmp_path / "result.json").read_text())
    assert result["device"]["count"] == 2
    assert result["correct"] is (fault is None), result["checks"]
