"""Extraction as ``cli/extract_embedding --feats-rspecifier`` runs it, from
features held in host memory: per utterance ``preprocess`` (upload, sliding
CMVN on the card, download, voiced-frame selection), then
``XvectorExtractor.extract_iter`` (chunks, length buckets, batches, K1,
stats pooling, the embedding).

Set-up makes the pool and the weights, builds the extractor (bf16 and K1,
as the CLI chooses) and runs one pass of the pool through the same path.
The window feeds the pool again and again, each pass with fresh utterance
ids, until the deadline, then lets ``extract_iter`` flush.  A traced run
ends with a second ``extract_iter`` call under the profiler, for the
traffic's ``trace_seconds``, which starts with empty buckets and flushes:
the device work in its trace is exactly that of the utterances it fed.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from .. import generate, harness, trace as tr, work
from ..reference import features as ref_features, tdnn as ref


def run(ctx: harness.Context):
    from xvector_tpu_torch.extract.extractor import (ExtractorConfig,
                                                     XvectorExtractor,
                                                     preprocess)
    from xvector_tpu_torch.models import tdnn
    from xvector_tpu_torch.ops import tdnn_kernel

    dev = torch.device(ctx.device or torch.device("cuda", 0))
    ctx.device = dev
    cuda = dev.type == "cuda"
    cfg, traffic, ec = ctx.cfg, ctx.traffic, ctx.cfg["extract"]
    model_cfg = tdnn.MODEL_ZOO[cfg["preset"]]
    phases = harness.Phases()
    harness.check_preset(cfg, model_cfg)
    pool = generate.extraction_pool(traffic, cfg, ctx.seed, dev)
    phases.mark("pool")
    frames = [len(f) for f, _ in pool]
    voiced = [int((v > 0.5).sum()) for _, v in pool]
    spans = [ref_features.chunks(n, ec["min_chunk"], ec["max_chunk"])
             for n in voiced]
    real = [sum(ln for _, ln in s) for s in spans]
    params, stats = generate.weights(cfg, ctx.seed, dev)
    ex = XvectorExtractor(
        model_cfg, params, stats,
        ExtractorConfig(min_chunk=ec["min_chunk"], max_chunk=ec["max_chunk"],
                        batch_size=ec["batch_size"],
                        compute_dtype=ec["compute_dtype"],
                        use_fused=(ec["compute_dtype"] == "bfloat16"
                                   and tdnn_kernel.supports(model_cfg))),
        device=dev)
    del params, stats
    phases.mark("extractor")
    rng = np.random.default_rng(generate.derive(ctx.seed, "check"))
    sample = set(rng.choice(len(pool), traffic["check_utterances"],
                            replace=False).tolist())
    sample.add(int(np.argmax(frames)))
    answers: Dict[int, List[np.ndarray]] = {j: [] for j in sample}
    host = {"preprocess_s": 0.0}

    def stream(tag: str, stop, log: List[int]):
        for p in range(1 << 30):
            for j, (feats, vad) in enumerate(pool):
                if stop(p, j):
                    return
                t0 = time.perf_counter()
                x = preprocess(feats, cmvn_window=ec["cmvn_window"], vad=vad,
                               device=dev)
                host["preprocess_s"] += time.perf_counter() - t0
                log.append(j)
                yield f"{tag}{p}-{j}", x

    def extract(tag: str, stop, log: List[int], keep: bool) -> int:
        """Run one extract_iter call; return the answers that came back."""
        n = 0
        for utt, xv in ex.extract_iter(stream(tag, stop, log)):
            n += 1
            if keep:
                j = int(utt.rsplit("-", 1)[1])
                if j in answers:
                    answers[j].append(xv)
        return n

    # warm-up: one pass of the pool, flushed
    extract("w", lambda p, j: p >= 1, [], keep=False)
    phases.mark("warm_up")
    phases.report()
    trace_s = float(traffic["trace_seconds"]) if ctx.trace else 0.0
    setup_s = time.time() - ctx.t_start
    host["preprocess_s"] = 0.0
    w0 = time.perf_counter()
    deadline_a = w0 + ctx.seconds - trace_s
    fed_a: List[int] = []
    back = extract("a", lambda p, j: time.perf_counter() >= deadline_a,
                   fed_a, keep=True)
    wall_a = time.perf_counter() - w0
    pre_a = host["preprocess_s"]
    fed_b: List[int] = []
    summary = None
    if ctx.trace:
        tracer = tr.Tracer(dev)
        tracer.start()
        deadline = tracer.t0 + trace_s
        back += extract("b", lambda p, j: time.perf_counter() >= deadline,
                        fed_b, keep=True)
        tracer.stop()
        summary = tracer.summary(tr.load_roles())
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    fed = len(fed_a) + len(fed_b)
    del ex
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    numbers = {"xv_gap": check(ctx, dev, pool, {
        j: a for j, a in answers.items() if j in set(fed_a) | set(fed_b)})}
    collected = {
        "cfg": cfg, "chips": 1,
        "host": {"wall_s": wall_a, "preprocess_s": pre_a,
                 "utterances": len(fed_a)},
        "work": {"real_frames": sum(real[j] for j in fed_a),
                 "chunks": sum(len(spans[j]) for j in fed_a),
                 "trace_real_frames": sum(real[j] for j in fed_b)},
        "traces": [summary] if summary is not None else [],
    }
    if summary is not None:
        collected["breakdown"] = tr.breakdown(summary)
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": 1, "memory_peak_bytes": peak}
    if summary is not None:
        device["busy_s"] = summary["busy_s"]
        device["window_s"] = summary["window_s"]
    checks = harness.verdict(numbers, ctx.limits)
    audio = sum(frames[j] for j in fed_a) * work.FRAME_SECONDS
    return harness.result_line(
        ctx, collected, checks, attempted=fed, failed=fed - back,
        device=device, e2e={"setup_s": setup_s,
                            "extract_audio_s_per_s": audio / wall_a})


def reference_xvectors(ctx, dev, pool, indices, lowp=None
                       ) -> Dict[int, torch.Tensor]:
    """The reference's x-vector of each pool utterance in ``indices``, from
    the seed's weights and the raw features and VAD."""
    params, stats = generate.weights(ctx.cfg, ctx.seed, dev)
    out = {}
    with ref.float32_exact(), torch.no_grad():
        for j in sorted(indices):
            feats, vad = pool[j]
            out[j] = ref_features.xvector(
                ctx.cfg, params, stats, torch.from_numpy(feats).to(dev),
                torch.from_numpy(vad).to(dev), ctx.cfg["extract"], lowp)
    return out


def check(ctx, dev, pool, answers: Dict[int, List[np.ndarray]]) -> float:
    """Worst relative gap, ||program - reference|| / ||reference||, over
    every answer of the sampled utterances (an utterance sampled but never
    answered counts as infinitely wrong)."""
    refs = reference_xvectors(ctx, dev, pool, answers)
    worst = 0.0
    for j, got in answers.items():
        if not got:
            return float("inf")
        r = refs[j].to(torch.float32).cpu()
        for xv in got:
            worst = max(worst, ref.rel_gap(torch.from_numpy(
                np.asarray(xv, np.float32)), r))
    return ref.finite(worst)
