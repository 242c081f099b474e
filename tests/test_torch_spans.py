"""The port's ``xv.*`` spans and counters.

``utils.profiling.span`` is a shared null context without a profiler, on a
thread the profiler does not record, and a named range under one; a tiny
CPU ``train_one_iteration`` fed by a ``PrefetchLoader`` and a tiny
``extract_iter`` open every span of their layers, nested as the layers
are; ``XvectorExtractor.counters`` match a hand count.
"""

import threading

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from xvector_tpu_torch.data import archives as TA
from xvector_tpu_torch.extract import extractor as X
from xvector_tpu_torch.models import tdnn
from xvector_tpu_torch.train import trainer as TR
from xvector_tpu_torch.utils.profiling import StepTimer, span, tracing

NUM_CLASSES = 5


def _spans(prof):
    """{name: [(thread, start, end)]} of the profile's ``xv.*`` ranges."""
    out = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith("xv."):
            s = ev.start_ns()
            out.setdefault(ev.name(), []).append(
                (ev.start_thread_id(), s, s + ev.duration_ns()))
    return out


def _inside(found, child, parent):
    """Every ``child`` range lies inside a ``parent`` range of its thread."""
    return all(any(pt == ct and ps <= cs and ce <= pe
                   for pt, ps, pe in found[parent])
               for ct, cs, ce in found[child])


def test_span_is_the_null_context_without_a_profiler_and_a_range_under_one():
    assert span("xv.a") is span("xv.b", "args")
    with span("xv.a"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("xv.test.outer", "n=1"):
            with span("xv.test.inner"):
                torch.ones(3).sum()
    found = _spans(prof)
    assert set(found) == {"xv.test.outer", "xv.test.inner"}
    assert _inside(found, "xv.test.inner", "xv.test.outer")
    assert span("xv.a") is span("xv.b")        # off again after the profile


def test_span_is_the_null_context_on_a_thread_the_profiler_does_not_record():
    seen = {}

    def worker():
        seen["tracing"] = tracing()
        seen["null"] = span("xv.test.worker") is span("xv.b")
        with span("xv.test.worker"):
            torch.ones(3).sum()

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing()
        thread = threading.Thread(target=worker)
        thread.start()
        thread.join()
    assert seen == {"tracing": False, "null": True}
    assert "xv.test.worker" not in _spans(prof)


def test_step_timer_spans_its_phases_and_keeps_its_summary_keys():
    t = StepTimer("xv.test")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with t("dispatch"):
            pass
        with t("dispatch"):
            pass
    assert [len(v) for v in _spans(prof).values()] == [2]
    assert "xv.test.dispatch" in _spans(prof)
    assert sorted(t.summary()) == ["dispatch", "dispatch_mean_ms"]


TRAIN_NESTING = [
    ("xv.data.wait", "xv.train.iteration"),
    ("xv.train.upload_wait", "xv.train.iteration"),
    ("xv.train.dispatch", "xv.train.iteration"),
    ("xv.train.device_drain", "xv.train.iteration"),
    ("xv.train.upload", "xv.train.dispatch"),
    ("xv.train.forward", "xv.train.dispatch"),
    ("xv.model.frame", "xv.train.forward"),
    ("xv.train.head", "xv.train.dispatch"),
    ("xv.train.backward", "xv.train.dispatch"),
    ("xv.train.optimizer", "xv.train.dispatch"),
    ("xv.train.bn_fold", "xv.train.dispatch"),
]


def test_train_one_iteration_opens_every_span_nested(tmp_path):
    rng = np.random.RandomState(0)

    def mb(t):
        x = rng.randn(4, t, 23).astype(np.float16)
        return x, rng.randint(0, NUM_CLASSES, 4).astype(np.int32), t

    path = str(tmp_path / "egs.1.xta")
    # one block of two, and one leftover that takes the single step
    TA.write_archive(path, [mb(24), mb(24), mb(17)])
    tr = TR.Trainer(TR.TrainConfig(model="tiny", num_targets=NUM_CLASSES,
                                   compute_dtype="float32", block_size=2),
                    str(tmp_path / "t"), device="cpu")
    with TA.ArchiveReader(path) as reader, \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        stats = tr.train_one_iteration(0, TA.PrefetchLoader(reader), 1e-3,
                                       0.0, 1.0)
    assert (stats["masked_blocks"] + stats["dense_blocks"],
            stats["single_steps"]) == (1, 1)
    assert not any(k.endswith("_pct") for k in stats)
    found = _spans(prof)
    assert set(found) == {c for c, _ in TRAIN_NESTING} | {
        "xv.train.iteration"}
    for child, parent in TRAIN_NESTING:
        assert _inside(found, child, parent), (child, parent)
    # three minibatches: three forward passes (of five frame layers each),
    # heads, backward passes and updates, two dispatches (the block and the
    # single step)
    assert [len(found[n]) for n in ("xv.train.forward", "xv.model.frame",
                                    "xv.train.head",
                                    "xv.train.backward",
                                    "xv.train.optimizer",
                                    "xv.train.dispatch",
                                    "xv.train.bn_fold")] == [3, 15, 3, 3, 3,
                                                             2, 1]
    # every span on the thread that called the iteration; the consumer
    # waits on the loader's queue once a minibatch, and once at its end
    (main, *_), = found["xv.train.iteration"]
    assert {th for v in found.values() for th, *_ in v} == {main}
    assert len(found["xv.data.wait"]) == 4


EXTRACT_NESTING = [
    ("xv.extract.cmvn", "xv.extract.preprocess"),
    ("xv.extract.select_voiced", "xv.extract.preprocess"),
    ("xv.extract.upload", "xv.extract.run"),
    ("xv.extract.frame_stack", "xv.extract.run"),
    ("xv.extract.pooling", "xv.extract.run"),
    ("xv.extract.embedding", "xv.extract.run"),
]


def _extractor(**kw):
    params, state = tdnn.init_params(torch.Generator().manual_seed(0),
                                     tdnn.MODEL_ZOO["tiny"], NUM_CLASSES,
                                     device="cpu")
    return X.XvectorExtractor(
        tdnn.MODEL_ZOO["tiny"], params, state,
        X.ExtractorConfig(min_chunk=25, max_chunk=100, batch_size=2, **kw),
        device="cpu")


def test_extract_iter_opens_every_span_nested():
    ex = _extractor(use_fused=True)
    rng = np.random.RandomState(1)
    utts = [(f"u{i}", rng.randn(n, 23).astype(np.float32),
             (rng.rand(n) > 0.3).astype(np.float32))
            for i, n in enumerate((90, 160, 60))]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = dict(ex.extract_iter(
            (u, X.preprocess(f, 30, v, device="cpu")) for u, f, v in utts))
    assert sorted(out) == ["u0", "u1", "u2"]
    found = _spans(prof)
    assert set(found) == {"xv.extract.preprocess", "xv.extract.cmvn",
                          "xv.extract.download", "xv.extract.select_voiced",
                          "xv.extract.pack", "xv.extract.run",
                          "xv.extract.upload", "xv.extract.frame_stack",
                          "xv.extract.pooling", "xv.extract.embedding"}
    for child, parent in EXTRACT_NESTING:
        assert _inside(found, child, parent), (child, parent)
    # each download is the preprocess's or the batch's
    runs = len(found["xv.extract.run"])
    assert len(found["xv.extract.download"]) == 3 + runs
    assert len(found["xv.extract.pack"]) == runs == ex.counters["batches"]
    # a batch is packed before it runs, outside its run span
    assert not any(rs <= ps and pe <= re
                   for _, ps, pe in found["xv.extract.pack"]
                   for _, rs, re in found["xv.extract.run"])


def test_unfused_extraction_spans_the_whole_stack_as_frame_stack():
    ex = _extractor()
    feats = np.random.RandomState(2).randn(70, 23).astype(np.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        dict(ex.extract_iter([("u", feats)]))
    found = _spans(prof)
    assert "xv.extract.pooling" not in found
    assert _inside(found, "xv.extract.frame_stack", "xv.extract.run")


def test_extractor_counters_match_a_hand_count():
    ex = _extractor()
    lengths = [30, 250, 10, 64, 130]
    rng = np.random.RandomState(3)
    stream = [(f"u{i}", rng.randn(n, 23).astype(np.float32))
              for i, n in enumerate(lengths)]
    assert len(dict(ex.extract_iter(stream))) == 4
    # chunks of at most 100 frames, a tail under 25 dropped (10 makes
    # none): 30 | 100 100 50 | 64 | 100 30; buckets 32, 64, 128, batches
    # of 2: {30, 30} in 32, {50, 64} in 64, {100, 100} and {100} in 128
    assert ex.counters == {"utterances": 4, "chunks": 7, "batches": 4,
                           "frames_real": 30 + 250 + 64 + 130,
                           "frames_padded": 2 * 32 + 2 * 64 + 3 * 128}
    dict(ex.extract_iter(stream[:1]))        # running totals
    assert (ex.counters["utterances"], ex.counters["frames_padded"]) == (
        5, 2 * 32 + 2 * 64 + 3 * 128 + 32)
