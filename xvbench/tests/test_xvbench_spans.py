"""The span credit beside the benchmark: ``spans.credit`` sends device time
and idle gaps to the spans that launched them, the accepted readers read
the same numbers from a summary that carries the span keys, and a CPU
traced run of each tiny cell, instrumented by ``spans.instrumented``, gives
the span readings a CPU trace can hold as finite numbers."""

import copy
import math

import pytest

from xvbench import harness, spans
from xvbench.drivers import extract_feats, train_egs
from xvbench.tests import tiny

CFG = harness.load_json(harness.HERE, "configs", "no_dropout.json")
TRACE = {"window_s": 5.0, "busy_s": 1.25, "kernel_s": {"k": 1.0},
         "role_s": {"conv_fwd": 0.2, "conv_dw": 0.15, "conv_dx": 0.1,
                    "frame_stack_fwd": 0.3, "nccl": 0.5},
         "idle_gaps": [["host, between traced ops", 2.0]]}
TRAIN = {"cfg": CFG, "chips": 1,
         "host": {"wall_s": 40.0, "minibatches": 2400, "upload_wait_s": 0.002,
                  "dispatch_s": 30.0},
         "work": {"minibatches": [(64, 300)] * 2400}, "traces": [TRACE],
         "trace_minibatches": [[(64, 300)] * 300]}
EXTRACT = {"cfg": CFG, "chips": 1,
           "host": {"wall_s": 45.0, "preprocess_s": 36.0, "utterances": 9000},
           "work": {"real_frames": 10 ** 8, "chunks": 12000,
                    "trace_real_frames": 10 ** 7},
           "traces": [TRACE]}
# the accepted readers' numbers for TRAIN and EXTRACT (None: nothing read)
READ = {"train_window_audio_s_per_s": (11520.0, None),
        "train_upload_wait_share": (0.005, None),
        "train_dispatch_ms": (12.5, None),
        "conv_roofline": (24.427897917087922, None),
        "train_mfu": (2.9716263479393326, None),
        "device_idle.train": (75.0, 75.0),
        "extract_preprocess_share": (None, 80.0),
        "k1_roofline": (None, 31.4855899016513),
        "extract_mfu": (None, 1.9124488231344792),
        "device_idle.extract": (75.0, 75.0),
        "nccl_share": (None, None)}
SPAN_KEYS = {"span_s": {"xv.train.optimizer": 0.9},
             "span_n": {"xv.train.optimizer": 300},
             "span_device_s": {"xv.train.forward": 1.0, "(none)": 0.25},
             "span_idle_s": {"xv.train.dispatch": 2.0},
             "span_device_incl_s": {"xv.train.forward": 1.0,
                                    "xv.train.dispatch": 1.0,
                                    "(none)": 0.25},
             "span_idle_incl_s": {"xv.train.dispatch": 2.0}}


@pytest.mark.parametrize("with_spans", [False, True],
                         ids=["accepted", "span_keys"])
def test_accepted_readers_read_the_same_numbers(with_spans):
    for name, want in READ.items():
        read = harness.load_reader(name)
        for collected, expect in zip((TRAIN, EXTRACT), want):
            c = copy.deepcopy(collected)
            if with_spans:
                c["traces"] = [dict(t, **SPAN_KEYS) for t in c["traces"]]
            got = read(c)
            assert (got is None if expect is None
                    else got == pytest.approx(expect, rel=1e-12)), name


def test_span_readings_of_a_summary():
    got = spans.readings(dict(TRAIN, traces=[dict(TRACE, **SPAN_KEYS)]))
    assert got == pytest.approx({"device_credited_share": 80.0,
                                 "idle_credited_share": 100.0,
                                 "train_optimizer_ms": 3.0,
                                 "train_idle_dispatch_share": 100.0})
    assert spans.readings(TRAIN) == {}


def _run(driver, traffic, **kw):
    ctx = tiny.context(traffic, {}, trace=True, **kw)
    try:
        with spans.instrumented():
            return driver.run(ctx)
    finally:
        harness.cleanup(ctx)


def test_traced_tiny_extraction_reads_pack_and_padding():
    r = _run(extract_feats, tiny.EXTRACT)
    got = r["spans"]["readings"]
    for name in ("extract_pack_share", "extract_padding_share"):
        assert math.isfinite(got[name]), name
    c = r["spans"]["counters"]
    assert 0 < c["frames_real"] < c["frames_padded"] and c["batches"] >= 1
    assert r["spans"]["span_n"][0]["xv.extract.pack"] == c["batches"]
    assert "span_s" not in r["metrics"] and r["breakdown"]


def test_traced_tiny_training_reads_the_optimizer():
    r = _run(train_egs, tiny.TRAIN)
    got = r["spans"]["readings"]
    assert math.isfinite(got["train_optimizer_ms"]) and got[
        "train_optimizer_ms"] > 0
    assert r["spans"]["span_n"][0]["xv.train.iteration"] == 1


def test_instrumented_leaves_the_benchmark_as_it_was():
    from xvbench import trace
    from xvector_tpu_torch.extract import extractor
    before = (trace.Tracer, harness.result_line,
              extractor.XvectorExtractor.__init__)
    with spans.instrumented():
        assert trace.Tracer is not before[0]
    assert (trace.Tracer, harness.result_line,
            extractor.XvectorExtractor.__init__) == before


GAP = 20.0


@pytest.mark.parametrize("case", ["own_thread", "engine_thread", "unspanned",
                                  "gap"])
def test_credit_sends_work_to_the_span_that_launched_it(case):
    # thread 1 holds outer [0, 1000] around inner [100, 200]; thread 2 (the
    # autograd engine's) holds none; thread 3 holds one that began later
    ranges = [(1, 0.0, 1000.0, "xv.outer"), (1, 100.0, 200.0, "xv.inner"),
              (3, 50.0, 900.0, "xv.worker")]
    if case == "own_thread":
        launches, ops = {7: (1, 150.0)}, [(7, 300.0, 400.0)]
        want_dev = {"xv.inner": 100e-6}
    elif case == "engine_thread":
        launches, ops = {7: (2, 150.0)}, [(7, 300.0, 400.0)]
        want_dev = {"xv.inner": 100e-6}
    elif case == "unspanned":
        launches, ops = {7: (1, 1500.0)}, [(7, 1600.0, 1700.0)]
        want_dev = {spans.NONE: 100e-6}
    else:
        # kernel 8, launched by thread 3 inside its span, ends a 100 us gap
        # whose midpoint (150) lies in thread 1's inner span too: the
        # launching thread's span takes it
        launches = {7: (1, 10.0), 8: (3, 800.0), 9: (1, 960.0)}
        ops = [(7, 0.0, 100.0), (8, 200.0, 260.0), (9, 270.0, 280.0)]
        want_dev = {"xv.outer": 110e-6, "xv.worker": 60e-6}
    got = spans.credit(ranges, launches, ops, GAP)
    assert got["span_device_s"] == pytest.approx(want_dev)
    if case == "gap":
        # the 10 us gap before kernel 9 is under the threshold
        assert got["span_idle_s"] == pytest.approx({"xv.worker": 100e-6})
    else:
        assert got["span_idle_s"] == {}
    if case != "unspanned":
        incl = {"xv.inner": 100e-6, "xv.outer": 100e-6}
        assert got["span_device_incl_s"] == pytest.approx(
            incl if case != "gap" else {"xv.outer": 110e-6,
                                        "xv.worker": 60e-6})
    assert got["span_s"] == pytest.approx(
        {"xv.outer": 1e-3, "xv.inner": 1e-4, "xv.worker": 8.5e-4})
    assert got["span_n"] == {"xv.outer": 1, "xv.inner": 1, "xv.worker": 1}


def test_credit_counts_overlapping_device_work_once():
    ranges = [(1, 0.0, 100.0, "xv.a"), (1, 100.0, 200.0, "xv.b")]
    got = spans.credit(ranges, {1: (1, 50.0), 2: (1, 150.0)},
                       [(1, 1000.0, 1100.0), (2, 1050.0, 1200.0)], GAP)
    assert got["span_device_s"] == pytest.approx({"xv.a": 100e-6,
                                                  "xv.b": 100e-6})
