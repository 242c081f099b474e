#!/usr/bin/env python3
"""Drive the PyTorch port's extraction and training paths on one NVIDIA GPU.

Run from the repository root (one card, no arguments needed):

    python3 chip_smoke.py [--seed N]

Phases; any failure raises and the exit code is non-zero:

1. device check: CUDA must be available; prints the card's name and power
   limit as ``nvidia-smi`` reports them;
2. build: compiles every CUDA source of the port (``ops/_build.py``) and
   prints the seconds and the compiler's register/spill report;
3. K1 against its plain version on the card: the full-width ``no_dropout``
   stack at 32x1024 and at a ragged 32x777 with padded tails, and small
   batches of the ``prelu``, ``l2_lrelu``, ``tdnn_dilated`` and ``etdnn``
   stacks; max error normalised by max|plain| must stay within 1e-2;
4. the serving path at full width (``no_dropout``, 7,185 classes, random
   weights from ``--seed``): Kaldi feature and VAD arks written and read
   back, ``preprocess`` (sliding CMVN + VAD), ``XvectorExtractor`` in bf16
   with the fused kernel (the main path, with the launch counts zeroed just
   before it and read just after) and without it, x-vectors compared
   (cosine ≥ 0.999), an f32 run on the card checked against the same
   extractor on the CPU on a small input, and the vectors written with
   ``ArkWriter`` and read back;
5. timing lines tagged with the card: extraction throughput of both runs,
   the serving metric on one full 32x1024 batch (fused and unfused), a
   profiler breakdown of the fused batch (per kernel, per K1 layer, device
   idle share), and K1 at 32x1024 against its plain version and its bound;
6. K2, K3 and K4 (the SAME conv forward, weight gradient and input
   gradient) against their plain versions on the card, K3 and K4 on the
   design ``route`` picks ("sm90": ``csrc/conv_sm90.cu``): at the training
   shapes (64x304, 512 -> 512, k=5 and k=7; there also K3 v1 and K4 v1,
   the "sm80" design), one tile (1x64, 64 -> 64, k=3), ragged shapes
   (B=6, T=301, 384 <-> 640 channels), dilated (k=3, d=2, 3, 4), two
   "sm80" shapes (channel counts off 8), and the autograd Function's dx
   and dW against autograd through the plain forward; bounds 1e-2 (bf16
   outputs of K2 and K4, the Function's gradients) and 1e-3 (K3's f32
   output), as max |kernel - plain| / max |plain|; K3 v2 must give the
   same bits on two calls at the training shapes;
7. the training path at full width (``no_dropout``, 7,185 classes, bf16,
   blocks of 16, Adam): an XTA archive of 32 full 64x304 minibatches and
   one ragged one written with ``write_archive``, read through
   ``ArchiveReader`` -> ``PrefetchLoader`` into
   ``Trainer.train_one_iteration`` twice (the main path: counts zeroed just
   before, read just after; exactly 6 kernel calls per minibatch step, two
   dense blocks and one single step per pass, a falling loss, every K3
   and K4 call on the "sm90" route, every K2 call through conv_bwd.cu's
   shift_gemm_kernel<false>); then one
   bf16 step fused against unfused (torch matmuls) from the same weights,
   and one f32 block of ``tiny`` on the card against the CPU;
8. timing lines tagged with the card: the block step fused and unfused
   (ms per minibatch, audio-s/s), a profiler breakdown of one fused block,
   and K2, K3 and K4 at k=5 and k=7 against their plain versions, their
   bounds and the one PyTorch call that computes the same function; K3
   and K4 in both designs (v2 "sm90" and v1 "sm80"), with CUDA launches
   per call and a host-inclusive time per call (100 back-to-back calls).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Float32 matmuls run in full f32
(``torch.backends.cuda.matmul.allow_tf32 = False``) so the plain versions
are true f32 referees.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from dataclasses import replace

import numpy as np
import torch
import torch.nn.functional as F

KERNEL_BOUND = 1e-2        # max |kernel - plain| / max |plain|
COSINE_BOUND = 0.999       # fused vs unfused x-vectors, both bf16
F32_BOUND = 1e-3           # card f32 vs CPU f32 x-vectors, normalised
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
FRAMES_PER_SECOND = 100    # 10 ms frame shift
EXTRACT_PAIRS = 5          # timed fused/unfused extraction pairs
DW_BOUND = 1e-3            # K3's f32 output: only the f32 sum order differs
# fused vs unfused bf16 train step from the same weights: the two round to
# bf16 at other places (once per conv against once per tap), and train-mode
# batch norm carries the difference into every gradient
TRAIN_LOSS_BOUND = 1e-2    # relative loss difference
TRAIN_COSINE_BOUND = 0.98  # per-parameter gradient cosine
TRAIN_F32_BOUND = 1e-3     # f32 block on the card vs the CPU, per tensor
TRAIN_B, TRAIN_T = 64, 304            # the recipe's minibatch (bench.py)
TRAIN_FULL, TRAIN_RAGGED_LEN = 32, 250
TRAIN_CLASSES = 7185
# the CUDA kernels of K2-K4 (csrc/conv_bwd.cu, csrc/conv_sm90.cu)
KERNEL_NAMES = ("shift_gemm_kernel", "dw_gemm_kernel", "dw_reduce_kernel",
                "dw_sm90_kernel", "dx_sm90_kernel")


def fail(msg: str):
    raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def perturb_bn(params, state, gen):
    """Move the eval batch-norm statistics and affine away from identity so
    the folded scale/shift is exercised."""
    for layer, s in zip(params["frame"], state["frame"]):
        c = s["mean"].shape[0]
        dev = s["mean"].device
        s["mean"].copy_((0.1 * torch.randn(c, generator=gen)).to(dev))
        s["var"].copy_((0.5 + torch.rand(c, generator=gen)).to(dev))
        layer["bn"]["gamma"].copy_(
            (1.0 + 0.1 * torch.randn(c, generator=gen)).to(dev))
        layer["bn"]["beta"].copy_((0.1 * torch.randn(c, generator=gen))
                                  .to(dev))


def model(tt, name, seed, num_classes, dev):
    cfg = tt.MODEL_ZOO[name]
    gen = torch.Generator().manual_seed(seed)
    params, state = tt.init_params(gen, cfg, num_classes, device=dev)
    perturb_bn(params, state, gen)
    return cfg, params, state


def tail_mask(bsz, t, gen):
    """(B, T) mask whose rows end at random lengths in [T/2, T]."""
    lens = torch.randint(t // 2, t + 1, (bsz,), generator=gen)
    lens[0] = t
    return (torch.arange(t)[None, :] < lens[:, None]).to(torch.float32)


def cuda_ms(fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def stack_work(cfg, bsz, t):
    """(FLOP, bytes) one K1 call must do: 2·k·Cin·Cout per frame and
    layer; f32 features and mask in, bf16 weights and f32 per-channel
    vectors in, f32 (B, T, C_last) out, each moved once."""
    flops, weight_bytes, cin = 0, 0, cfg.feat_dim
    for k, c in zip(cfg.kernel_sizes, cfg.channels):
        flops += 2 * bsz * t * k * cin * c
        weight_bytes += k * cin * c * 2 + 3 * c * 4
        cin = c
    io_bytes = bsz * t * (cfg.feat_dim * 4 + 4 + cfg.channels[-1] * 4)
    return flops, weight_bytes + io_bytes


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_kernel_checks(tt, TK, dev, seed):
    cases = [("no_dropout", 32, 1024), ("no_dropout", 32, 777),
             ("prelu", 3, 333), ("l2_lrelu", 3, 333),
             ("tdnn_dilated", 3, 333), ("etdnn", 3, 333)]
    results = {}
    for i, (name, bsz, t) in enumerate(cases):
        cfg, params, state = model(tt, name, seed + i, 10, dev)
        gen = torch.Generator().manual_seed(seed + 100 + i)
        x = torch.randn(bsz, t, cfg.feat_dim, generator=gen).to(dev)
        mask = tail_mask(bsz, t, gen).to(dev)
        got = TK.fused_frame_stack(cfg, params, state, x, mask)
        torch.cuda.synchronize()
        want = TK.fused_frame_stack_reference(cfg, params, state, x, mask)
        if got.shape != want.shape or got.dtype != torch.float32:
            fail(f"K1 {name} {bsz}x{t}: shape/dtype {tuple(got.shape)} "
                 f"{got.dtype} vs {tuple(want.shape)}")
        if not torch.isfinite(got).all():
            fail(f"K1 {name} {bsz}x{t}: non-finite output")
        abs_err = float((got - want).abs().max())
        norm_err = abs_err / float(want.abs().max())
        print(f"K1 check {name} {bsz}x{t}: max_abs_err={abs_err:.6g} "
              f"normalised={norm_err:.3g} (bound {KERNEL_BOUND})")
        if norm_err > KERNEL_BOUND or bool(got[mask == 0].any()):
            fail(f"K1 {name} {bsz}x{t} disagrees with its plain version")
        results[(name, bsz, t)] = abs_err
    return results


def write_arks(kio, tmp, seed):
    """~64 utterances of 200-3000 frames, one of 12,000 (two chunks) and
    one of 20 (dropped), as a binary feature ark and a VAD ark."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(200, 3001, size=64).tolist() + [12000, 20]
    feats_ark = os.path.join(tmp, "feats.ark")
    vad_ark = os.path.join(tmp, "vad.ark")
    with open(feats_ark, "wb") as ff, open(vad_ark, "wb") as fv:
        for i, n in enumerate(lens):
            key = f"utt{i:03d}"
            feats = (2.0 * rng.randn(n, 23) + 5.0 * rng.randn(23)
                     ).astype(np.float32)
            vad = (rng.rand(n) > 0.15).astype(np.float32)
            if n in (12000, 20):
                vad[:] = 1.0
            kio.write_mat(ff, feats, key=key)
            kio.write_vec_flt(fv, vad, key=key)
    return feats_ark, vad_ark


def run_extractor(TE, cfg, params, state, utts, fused, dev):
    ex = TE.XvectorExtractor(cfg, params, state, TE.ExtractorConfig(
        compute_dtype="bfloat16", use_fused=fused), device=dev)
    t0 = time.perf_counter()
    out = ex.extract(utts)          # results come back as numpy: synced
    return out, time.perf_counter() - t0


def phase_serving(tt, TE, TK, kio, dev, seed, tag):
    cfg, params, state = model(tt, "no_dropout", seed, 7185, dev)
    with tempfile.TemporaryDirectory() as tmp:
        feats_ark, vad_ark = write_arks(kio, tmp, seed)
        vads = dict(kio.read_vec_flt_ark(vad_ark))
        t0 = time.perf_counter()
        utts = [(k, TE.preprocess(m, vad=vads[k], device=dev))
                for k, m in kio.read_mat_ark(feats_ark)]
        pre_s = time.perf_counter() - t0
        kept = {k for k, f in utts if f.shape[0] >= 25}
        frames = sum(f.shape[0] for k, f in utts if k in kept)
        print(f"serving: {len(utts)} utterances read, {len(kept)} kept, "
              f"{frames} voiced frames; preprocess {pre_s:.3f} s")

        for fused in (True, False):   # warm-up: every bucket shape once
            run_extractor(TE, cfg, params, state, utts, fused, dev)

        # the main path: counts zeroed just before, read just after
        TK.launches = 0
        xv_fused, s_fused = run_extractor(TE, cfg, params, state, utts,
                                          True, dev)
        main_launches = TK.launches
        xv_plain, s_plain = run_extractor(TE, cfg, params, state, utts,
                                          False, dev)
        if main_launches == 0:
            fail("the fused run launched K1 no time")
        if TK.launches != main_launches:
            fail("the unfused run launched K1")
        times = {True: [s_fused], False: [s_plain]}
        for i in range(EXTRACT_PAIRS - 1):   # alternate which runs first
            for fused in ((False, True) if i % 2 == 0 else (True, False)):
                times[fused].append(run_extractor(
                    TE, cfg, params, state, utts, fused, dev)[1])

        for name, xv in (("fused", xv_fused), ("unfused", xv_plain)):
            if set(xv) != kept:
                fail(f"{name} run returned {len(xv)} x-vectors, expected "
                     f"{len(kept)}")
            for k, v in xv.items():
                if v.shape != (cfg.xvector_dim,) or not np.isfinite(v).all():
                    fail(f"{name} x-vector {k}: shape {v.shape} or "
                         "non-finite")
        cos = min(float(np.dot(xv_fused[k], xv_plain[k])
                        / (np.linalg.norm(xv_fused[k])
                           * np.linalg.norm(xv_plain[k]))) for k in kept)
        print(f"serving: fused vs unfused bf16 x-vectors min cosine "
              f"{cos:.6f} (bound {COSINE_BOUND})")
        if cos < COSINE_BOUND:
            fail("fused and unfused x-vectors disagree")

        # reference on a small input: f32 on the card vs f32 on the CPU
        small = [(k, f[:400]) for k, f in utts[:3]]
        ref_cfg = TE.ExtractorConfig(compute_dtype="float32", batch_size=4)
        on_card = TE.XvectorExtractor(cfg, params, state, ref_cfg,
                                      device=dev).extract(small)
        on_cpu = TE.XvectorExtractor(cfg, params, state, ref_cfg,
                                     device="cpu").extract(small)
        f32_err = max(float(np.abs(on_card[k] - on_cpu[k]).max()
                            / np.abs(on_cpu[k]).max()) for k in on_cpu)
        print(f"serving: f32 card vs CPU x-vectors normalised error "
              f"{f32_err:.3g} (bound {F32_BOUND})")
        if f32_err > F32_BOUND:
            fail("f32 extraction on the card disagrees with the CPU")

        ark, scp = os.path.join(tmp, "xv.ark"), os.path.join(tmp, "xv.scp")
        with kio.ArkWriter(ark, scp) as w:
            for k, v in xv_fused.items():
                w.write(k, v)
        back = dict(kio.read_vec_flt_scp(scp))
        if set(back) != kept or any(
                not np.array_equal(back[k], xv_fused[k]) for k in kept):
            fail("x-vector ark/scp round trip lost data")
        print(f"serving: wrote and read back {len(back)} x-vectors "
              "(ark+scp)")

    for fused in (True, False):
        q1, med, q3 = statistics.quantiles(times[fused], n=4)
        name = "fused" if fused else "unfused"
        print(f"timing extractor {name} bf16: {len(kept) / med:.1f} "
              f"embeddings/s, {frames / FRAMES_PER_SECOND / med:.1f} "
              f"audio-s/s (median {med:.4f} s, quartiles {q1:.4f}-{q3:.4f} "
              f"s over {len(times[fused])} runs; {len(kept)} utterances, "
              f"{frames} frames) [{tag}]")
    return main_launches


def phase_batch_timing(tt, TE, dev, seed, tag):
    """The serving metric at its working point: one full 32x1024 batch of
    the no_dropout extractor in bf16, fused and unfused, as device time
    (CUDA events around the forward) and as host time around ``_run``
    (upload, forward, download)."""
    bsz, t = 32, 1024
    cfg, params, state = model(tt, "no_dropout", seed, 7185, dev)
    rng = np.random.RandomState(seed + 11)
    x = rng.randn(bsz, t, cfg.feat_dim).astype(np.float32)
    mask = np.ones((bsz, t), np.float32)
    audio_s = bsz * t / FRAMES_PER_SECOND
    for fused in (True, False):
        ex = TE.XvectorExtractor(cfg, params, state, TE.ExtractorConfig(
            compute_dtype="bfloat16", use_fused=fused), device=dev)
        xd, md = torch.from_numpy(x).to(dev), torch.from_numpy(mask).to(dev)
        with torch.inference_mode():
            dev_ms = cuda_ms(lambda: ex._forward(xd, md), 20, 3)
        host = []
        for _ in range(10):
            t0 = time.perf_counter()
            ex._run(x, mask)
            host.append((time.perf_counter() - t0) * 1e3)
        host_ms = statistics.median(host)
        name = "fused" if fused else "unfused"
        print(f"timing extractor batch {bsz}x{t} {name} bf16: device "
              f"{dev_ms:.4f} ms = {bsz / dev_ms * 1e3:.1f} embeddings/s, "
              f"{audio_s / dev_ms * 1e3:.1f} audio-s/s; host-inclusive "
              f"median {host_ms:.4f} ms = {bsz / host_ms * 1e3:.1f} "
              f"embeddings/s [{tag}]")


def phase_profile(tt, TE, dev, seed, tag):
    """Where the time of one fused 32x1024 extractor batch goes: device
    time per kernel launch (torch.profiler), per K1 layer, and the device's
    busy share of the host-inclusive ``_run`` time."""
    from torch.profiler import ProfilerActivity, profile
    bsz, t, runs = 32, 1024, 3
    cfg, params, state = model(tt, "no_dropout", seed, 7185, dev)
    rng = np.random.RandomState(seed + 13)
    x = rng.randn(bsz, t, cfg.feat_dim).astype(np.float32)
    mask = np.ones((bsz, t), np.float32)
    ex = TE.XvectorExtractor(cfg, params, state, TE.ExtractorConfig(
        compute_dtype="bfloat16", use_fused=True), device=dev)
    ex._run(x, mask)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            ex._run(x, mask)
        wall_us = (time.perf_counter() - t0) * 1e6 / runs
    dev_events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
    if not dev_events:
        print(f"profile: the profiler recorded no device events; device "
              f"breakdown not measured [{tag}]")
        return
    by_name = {}
    for e in dev_events:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    busy_us = sum(sum(v) for v in by_name.values()) / runs
    layer_us = [e.time_range.elapsed_us() for e in dev_events
                if "tdnn_layer_kernel" in e.name]
    n = cfg.num_frame_layers
    if len(layer_us) == n * runs:
        per_layer = [statistics.median(layer_us[l::n]) for l in range(n)]
        print("profile K1 per layer (us): " + ", ".join(
            f"L{l} k={cfg.kernel_sizes[l]} {cfg.channels[l]}ch "
            f"{us:.1f}" for l, us in enumerate(per_layer)) + f" [{tag}]")
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:8]
    print(f"profile extractor batch {bsz}x{t} fused bf16: device busy "
          f"{busy_us:.1f} us of {wall_us:.1f} us host-inclusive per batch "
          f"= {1 - busy_us / wall_us:.1%} device idle; top device time per "
          "batch: " + "; ".join(f"{name[:60]} {sum(v) / runs:.1f} us"
                                 for name, v in top) + f" [{tag}]")


def phase_k1_timing(tt, TK, dev, seed, tag):
    bsz, t = 32, 1024
    cfg, params, state = model(tt, "no_dropout", seed, 10, dev)
    gen = torch.Generator().manual_seed(seed + 7)
    x = torch.randn(bsz, t, cfg.feat_dim, generator=gen).to(dev)
    mask = tail_mask(bsz, t, gen).to(dev)
    before = TK.launches
    iters, warmup = 20, 3
    ms = cuda_ms(lambda: TK.fused_frame_stack(cfg, params, state, x, mask),
                 iters, warmup)
    per_call = (TK.launches - before) / (iters + warmup)
    plain_ms = cuda_ms(lambda: TK.fused_frame_stack_reference(
        cfg, params, state, x, mask), iters, warmup)
    # the extractor's unfused bf16 frame stack (torch matmuls), for context
    unfused_ms = cuda_ms(lambda: tt.frame_stack(
        cfg, params, state, x, mask, compute_dtype=torch.bfloat16),
        iters, warmup)
    flops, nbytes = stack_work(cfg, bsz, t)
    ops_ms = flops / PEAK_BF16_FLOPS * 1e3
    mem_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, mem_ms)
    bound_by = "operations" if ops_ms >= mem_ms else "bytes"
    print(f"timing K1 no_dropout {bsz}x{t}: {ms:.4f} ms/call, "
          f"{per_call:g} launches/call, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms by {bound_by} ({flops:.4g} FLOP, "
          f"{nbytes / 1e6:.1f} MB), {flops / ms / 1e9:.1f} TFLOP/s = "
          f"{bound_ms / ms:.1%} of bound; unfused bf16 frame_stack "
          f"{unfused_ms:.4f} ms [{tag}]")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


# ---------------------------------------------------------------------------
# training slice: K2, K3, K4 and the block train step
# ---------------------------------------------------------------------------

def norm_err(got, want):
    """(max |got - want|, the same over max |want|)."""
    abs_err = float((got.float() - want.float()).abs().max())
    return abs_err, abs_err / float(want.float().abs().max())


def conv_inputs(b, t, cin, cout, k, dev, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, t, cin, generator=gen).to(dev, torch.bfloat16)
    w = (torch.randn(k, cin, cout, generator=gen) / math.sqrt(k * cin)).to(
        dev, torch.bfloat16)
    g = torch.randn(b, t, cout, generator=gen).to(dev, torch.bfloat16)
    return x, w, g


def phase_conv_checks(CB, dev, seed):
    """K2, K3 and K4 against their plain versions; returns the largest
    max-abs error of each at the training shapes."""
    cases = [("train", 5, 1, TRAIN_B, TRAIN_T, 512, 512),
             ("train", 7, 1, TRAIN_B, TRAIN_T, 512, 512),
             ("one-tile", 3, 1, 1, 64, 64, 64),
             ("ragged", 5, 1, 6, 301, 384, 640),
             ("ragged", 7, 1, 6, 301, 640, 384),
             ("dilated", 3, 2, 8, 300, 512, 512),
             ("dilated", 3, 3, 8, 300, 512, 512),
             ("dilated", 3, 4, 8, 300, 512, 512),
             ("off-8", 3, 2, 6, 301, 12, 20),
             ("off-8", 5, 1, 4, 301, 100, 36)]
    train_err = {"fwd": 0.0, "dw": 0.0, "dx": 0.0, "dw_sm80": 0.0,
                 "dx_sm80": 0.0}
    for i, (kind, k, d, b, t, cin, cout) in enumerate(cases):
        x, w, g = conv_inputs(b, t, cin, cout, k, dev, seed + 200 + i)
        design = CB.route(x.shape, w.shape, d)
        if design != ("sm80" if kind == "off-8" else "sm90"):
            fail(f"conv {kind} {cin}->{cout}: route() says {design}")
        before = dict(CB.route_launches)
        got = {"fwd": CB.conv_fwd(x, w, d), "dw": CB.conv_dw(x, g, k, d),
               "dx": CB.conv_dx(g, w, d)}
        if kind == "train":   # v1 at the same shapes
            got["dw_sm80"] = CB.conv_dw(x, g, k, d, design="sm80")
            got["dx_sm80"] = CB.conv_dx(g, w, d, design="sm80")
        torch.cuda.synchronize()
        took = {n: CB.route_launches[n] - before[n] for n in before}
        if (took[f"dw_{design}"], took[f"dx_{design}"]) != (1, 1):
            fail(f"conv {kind}: K3/K4 did not run on the {design} route "
                 f"({took})")
        want = {"fwd": CB.conv_fwd_reference(x, w, d),
                "dw": CB.conv_dw_reference(x, g, k, d),
                "dx": CB.conv_dx_reference(g, w, d)}
        want["dw_sm80"], want["dx_sm80"] = want["dw"], want["dx"]
        shapes = {"fwd": ((b, t, cout), torch.bfloat16),
                  "dw": ((k, cin, cout), torch.float32),
                  "dx": ((b, t, cin), torch.bfloat16)}
        shapes["dw_sm80"], shapes["dx_sm80"] = shapes["dw"], shapes["dx"]
        for name in got:
            kernel = {"fwd": "K2", "dw": f"K3 {design}",
                      "dx": f"K4 {design}", "dw_sm80": "K3 sm80",
                      "dx_sm80": "K4 sm80"}[name]
            label = (f"conv {kernel} {kind} k={k} d={d} {b}x{t} "
                     f"{cin}->{cout}")
            if (tuple(got[name].shape), got[name].dtype) != shapes[name]:
                fail(f"{label}: shape/dtype {tuple(got[name].shape)} "
                     f"{got[name].dtype}, expected {shapes[name]}")
            if not torch.isfinite(got[name]).all():
                fail(f"{label}: non-finite output")
            bound = DW_BOUND if name.startswith("dw") else KERNEL_BOUND
            abs_err, err = norm_err(got[name], want[name])
            print(f"{label}: max_abs_err={abs_err:.6g} normalised={err:.3g} "
                  f"(bound {bound})")
            if err > bound:
                fail(f"{label} disagrees with its plain version")
            if kind == "train":
                train_err[name] = max(train_err[name], abs_err)

    # K3 v2 sums the cluster's partials in rank order: the same bits on
    # every call
    for k in (5, 7):
        x, _, g = conv_inputs(TRAIN_B, TRAIN_T, 512, 512, k, dev, seed + 250)
        a, b = CB.conv_dw(x, g, k, 1), CB.conv_dw(x, g, k, 1)
        same = bool(torch.equal(a, b))
        print(f"conv K3 sm90 k={k} {TRAIN_B}x{TRAIN_T} 512->512: "
              f"bit-identical on two calls: {same}")
        if not same:
            fail(f"K3 v2 k={k} gave other bits on a second call")

    # the autograd Function against autograd through the plain forward
    k = 5
    x, w, g = conv_inputs(TRAIN_B, TRAIN_T, 512, 512, k, dev, seed + 300)
    xs, ws = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    CB.conv1d_same_fused_bwd(xs, ws, 1).backward(g)
    xr, wr = x.float().requires_grad_(True), w.float().requires_grad_(True)
    CB.conv_fwd_reference(xr, wr, 1).backward(g.float())
    torch.cuda.synchronize()
    for name, a, b in (("dx", xs.grad, xr.grad), ("dW", ws.grad, wr.grad)):
        abs_err, err = norm_err(a, b)
        print(f"conv Function {name} k={k} {TRAIN_B}x{TRAIN_T} vs autograd "
              f"of the plain forward: max_abs_err={abs_err:.6g} "
              f"normalised={err:.3g} (bound {KERNEL_BOUND})")
        if a.dtype != torch.bfloat16 or err > KERNEL_BOUND:
            fail(f"conv Function {name} disagrees with autograd")
    return train_err


def write_train_archive(TA, path, seed, feat_dim):
    """TRAIN_FULL full minibatches and one ragged one (true length
    TRAIN_RAGGED_LEN, last).  Each speaker has its own mean feature
    vector, so the labels can be learnt."""
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((TRAIN_CLASSES, feat_dim), dtype=np.float32)
    mbs = []
    for i in range(TRAIN_FULL + 1):
        labels = rng.integers(0, TRAIN_CLASSES, TRAIN_B, dtype=np.int32)
        feats = (means[labels][:, None, :] + rng.standard_normal(
            (TRAIN_B, TRAIN_T, feat_dim), dtype=np.float32))
        true_len = TRAIN_T if i < TRAIN_FULL else TRAIN_RAGGED_LEN
        feats[:, true_len:] = 0.0
        mbs.append((feats.astype(np.float16), labels, true_len))
    TA.write_archive(path, mbs)
    return mbs


def leaf_names(tree, prefix=""):
    """Dotted names of a tree's leaves in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items()
                for n in leaf_names(v, f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in leaf_names(v, f"{prefix}{i}.")]
    return [prefix.rstrip(".")]


def train_cfg(TR, seed, **kw):
    return TR.TrainConfig(model="no_dropout", num_targets=TRAIN_CLASSES,
                          compute_dtype="bfloat16", block_size=16,
                          random_seed=seed, **kw)


def phase_training(TR, TA, CB, schedules, dev, seed, tag, tmp):
    """The main training path, then its two comparisons.  Returns the
    main path's launch counts and the first minibatch."""
    path = os.path.join(tmp, "egs.1.xta")
    t0 = time.perf_counter()
    mbs = write_train_archive(TA, path, seed, 23)
    audio_s = sum(TRAIN_B * t for _, _, t in mbs) / FRAMES_PER_SECOND
    print(f"train: wrote {len(mbs)} minibatches ({TRAIN_FULL} full "
          f"{TRAIN_B}x{TRAIN_T}, one of true length {TRAIN_RAGGED_LEN}) in "
          f"{time.perf_counter() - t0:.2f} s")
    cfg = train_cfg(TR, seed)
    tr = TR.Trainer(cfg, os.path.join(tmp, "exp"), device=dev)
    num_iters = 2

    # the main path: counts zeroed just before, read just after
    for counts in (CB.launches, CB.route_launches):
        for name in counts:
            counts[name] = 0
    passes = []
    for it in range(num_iters):
        lr = schedules.learning_rate(it, num_iters,
                                     cfg.initial_effective_lrate,
                                     cfg.final_effective_lrate)
        with TA.ArchiveReader(path) as reader:
            t0 = time.perf_counter()
            stats = tr.train_one_iteration(it, TA.PrefetchLoader(reader), lr,
                                           0.0, 1.0)
            passes.append((lr, stats, time.perf_counter() - t0))
    launches = dict(CB.launches)
    routes = dict(CB.route_launches)

    steps = 0
    for it, (lr, st, secs) in enumerate(passes):
        print(f"train pass {it}: lr {lr:.6g}, loss {st['loss']:.6f}, "
              f"accuracy {st['accuracy']:.4f}, {st['minibatches']:g} "
              f"minibatches ({st['dense_blocks']} dense blocks, "
              f"{st['masked_blocks']} masked blocks, {st['single_steps']} "
              f"single steps), {secs:.3f} s = {audio_s / secs:.1f} audio-s/s "
              f"host-inclusive; dispatch {st.get('dispatch', 0.0):.3f} s, "
              f"upload wait {st.get('upload_wait', 0.0):.3f} s, drain "
              f"{st.get('device_drain', 0.0):.3f} s [{tag}]")
        if not math.isfinite(st["loss"]):
            fail(f"train pass {it}: non-finite loss")
        if (st["minibatches"], st["dense_blocks"], st["masked_blocks"],
                st["single_steps"]) != (TRAIN_FULL + 1, TRAIN_FULL // 16, 0,
                                        1):
            fail(f"train pass {it}: expected two dense blocks and one "
                 "single step")
        steps += int(st["minibatches"])
    if not passes[1][1]["loss"] < passes[0][1]["loss"]:
        fail("train: the second pass's loss is not below the first's")
    # the layers the model sends to the kernels: k > 1 and k·Cin > 160
    # (no_dropout: layers 1 and 2); each makes one call of each kernel
    mc = tr.model_cfg
    cins = (mc.feat_dim,) + mc.channels[:-1]
    wide = sum(1 for k, c in zip(mc.kernel_sizes, cins)
               if k > 1 and k * c > 160)
    want = {name: wide * steps for name in ("fwd", "dw", "dx")}
    print(f"train: kernel calls on the main path {launches} over {steps} "
          f"minibatch steps (expected {want}: K2, K3 and K4 once for each "
          f"of the {wide} wide conv layers of each step)")
    if launches != want:
        fail(f"train: kernel launch counts are not {3 * wide} per "
             "minibatch step")
    # K3 and K4 by design; K2 has one (conv_bwd.cu shift_gemm_kernel<false>,
    # one launch per conv_fwd call)
    want_routes = {"dw_sm90": want["dw"], "dx_sm90": want["dx"],
                   "dw_sm80": 0, "dx_sm80": 0}
    print(f"train: K3/K4 calls by design on the main path {routes} "
          f"(expected {want_routes}); K2 calls through "
          f"shift_gemm_kernel<false>: {launches['fwd']}")
    if routes != want_routes:
        fail("train: a K3 or K4 call of the main path left the sm90 route")

    # one bf16 step, fused against unfused, from the same fresh weights
    from xvector_tpu_torch.models.convert import tree_leaves, tree_map
    fresh = TR.Trainer(cfg, os.path.join(tmp, "fresh"), device=dev)
    x = torch.from_numpy(mbs[0][0].copy()).to(dev)
    y = torch.from_numpy(mbs[0][1].copy()).to(dev)
    out = {}
    for fused in (True, False):
        p = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                     fresh.params)
        loss, _ = TR._loss_fn(fresh.model_cfg,
                              replace(cfg, fused_conv_bwd=fused), p,
                              fresh.state, x, y, TRAIN_T, TRAIN_B, 1.0, None,
                              dense=True)
        out[fused] = (float(loss.detach()),
                      torch.autograd.grad(loss, tree_leaves(p)))
    rel = abs(out[True][0] - out[False][0]) / abs(out[False][0])
    cos = {n: float(F.cosine_similarity(a.double().flatten(),
                                        b.double().flatten(), dim=0))
           for n, a, b in zip(leaf_names(fresh.params), out[True][1],
                              out[False][1])}
    worst = sorted(cos.items(), key=lambda kv: kv[1])[:3]
    print(f"train: bf16 step fused vs unfused: loss {out[True][0]:.6f} vs "
          f"{out[False][0]:.6f} (relative {rel:.3g}, bound "
          f"{TRAIN_LOSS_BOUND}); gradient cosine min "
          f"{worst[0][1]:.6f} (bound {TRAIN_COSINE_BOUND}), lowest "
          + ", ".join(f"{n} {c:.6f}" for n, c in worst))
    if rel > TRAIN_LOSS_BOUND or worst[0][1] < TRAIN_COSINE_BOUND:
        fail("train: fused and unfused bf16 steps disagree")

    # one f32 block of tiny on the card against the same block on the CPU
    # (SGD: Adam would turn ulp-level gradient noise into ±lr moves)
    small = TR.TrainConfig(model="tiny", num_targets=50,
                           compute_dtype="float32", block_size=4,
                           optimizer="sgd", random_seed=seed)
    rng = np.random.RandomState(seed + 21)
    xs = rng.randn(4, 8, 40, 23).astype(np.float16)
    ys = rng.randint(0, 50, (4, 8)).astype(np.int32)
    t_lens, n_rows = [40, 33, 40, 27], [8, 8, 6, 8]
    res = {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        t = TR.Trainer(small, os.path.join(tmp, f"small_{where}"), device=d)
        state, m = t._block_fn(t.params, t.optimizer, t.state,
                               torch.from_numpy(xs).to(d),
                               torch.from_numpy(ys).to(d), t_lens, n_rows,
                               1e-2, 1.0, 1.0, None)
        res[where] = ([v.detach().cpu() for v in tree_leaves(t.params)]
                       + [v.cpu() for v in tree_leaves(state)],
                       float(m["loss"]))
    f32_err = max(norm_err(a, b)[1] for a, b in zip(res["card"][0],
                                                     res["cpu"][0]))
    print(f"train: f32 tiny block (4 minibatches, masked, SGD) card vs CPU: "
          f"loss {res['card'][1]:.6f} vs {res['cpu'][1]:.6f}, parameters "
          f"and BN state normalised error {f32_err:.3g} (bound "
          f"{TRAIN_F32_BOUND})")
    if f32_err > TRAIN_F32_BOUND:
        fail("train: f32 block on the card disagrees with the CPU")
    return launches, routes


def phase_train_timing(TR, dev, seed, tag, tmp):
    """The block step (16 dense minibatches) fused and unfused in turns,
    host clock around each block ending in a synchronise, then a profiler
    breakdown of one fused block."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(seed + 31)
    xs = torch.from_numpy(rng.standard_normal(
        (16, TRAIN_B, TRAIN_T, 23), dtype=np.float32).astype(np.float16)
    ).to(dev)
    ys = torch.from_numpy(rng.integers(0, TRAIN_CLASSES, (16, TRAIN_B),
                                       dtype=np.int32)).to(dev)
    full = ([TRAIN_T] * 16, [TRAIN_B] * 16)
    trainers = {fused: TR.Trainer(train_cfg(TR, seed, fused_conv_bwd=fused),
                                  os.path.join(tmp, f"timing_{fused}"),
                                  device=dev)
                for fused in (True, False)}

    def block(fused):
        t = trainers[fused]
        t.state, _ = t._block_dense_fn(t.params, t.optimizer, t.state, xs,
                                       ys, *full, 1e-3, 1.0, 1.0, None)

    def timed(fused):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        block(fused)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / 16

    for _ in range(2):                    # warm-up
        for fused in (True, False):
            timed(fused)
    times = {True: [], False: []}
    for order in ((True, False), (False, True), (True, False),
                  (False, True)):
        for fused in order:
            times[fused].append(timed(fused))
    audio_per_mb = TRAIN_B * TRAIN_T / FRAMES_PER_SECOND
    for fused in (True, False):
        med = statistics.median(times[fused])
        name = "fused" if fused else "unfused"
        print(f"timing train block step no_dropout {TRAIN_B}x{TRAIN_T} "
              f"{name} bf16 Adam: {med:.4f} ms per minibatch = "
              f"{audio_per_mb / med * 1e3:.1f} audio-s/s (median of "
              f"{len(times[fused])} blocks of 16: "
              + ", ".join(f"{v:.4f}" for v in times[fused]) + f") [{tag}]")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        block(True)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device kernels and copies; a user annotation (Optimizer.step's
    # range) also shows on the device's timeline and is left out
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
    if not dev_events:
        print(f"profile train block: the profiler recorded no device "
              f"events; breakdown not measured [{tag}]")
        return

    def group(name):
        if "shift_gemm_kernel<false>" in name:
            return "K2 conv fwd"
        if "shift_gemm_kernel<true>" in name:
            return "K4 conv dx"
        if "dx_sm90_kernel" in name:
            return "K4 conv dx"
        if ("dw_sm90_kernel" in name or "dw_gemm_kernel" in name
                or "dw_reduce_kernel" in name):
            return "K3 conv dw"
        low = name.lower()
        if "memcpy" in low or "memset" in low:
            return "copies"
        if any(s in low for s in ("gemm", "xmma", "nvjet", "cutlass",
                                  "gemv", "matmul")):
            return "torch matmuls"
        if "multi_tensor" in low or "adam" in low:
            return "optimizer"
        if "reduce_kernel" in low:
            return "reductions (BN moments, pooling, sums)"
        if "elementwise" in low:
            return "elementwise (bias, ReLU, BN affine, casts, grads)"
        return "other (softmax, gather, ...)"

    groups, names = {}, {}
    for e in dev_events:
        us = e.time_range.elapsed_us()
        g = group(e.name)
        groups[g] = groups.get(g, 0.0) + us
        names[e.name] = names.get(e.name, 0.0) + us
    busy = sum(groups.values())
    plain_us = statistics.median(times[True]) * 16e3
    print(f"profile train block (16 dense minibatches, fused, bf16 Adam): "
          f"device busy {busy:.1f} us of {wall_us:.1f} us host-inclusive "
          f"under the profiler = {1 - busy / wall_us:.1%} device idle "
          f"({1 - busy / plain_us:.1%} of the unprofiled median block, "
          f"{plain_us:.1f} us); "
          + "; ".join(f"{g} {us:.1f} us ({us / busy:.1%})"
                      for g, us in sorted(groups.items(),
                                          key=lambda kv: -kv[1]))
          + f" [{tag}]")
    top = sorted(names.items(), key=lambda kv: -kv[1])[:10]
    print("profile train block top kernels: " + "; ".join(
        f"{n[:70]} {us:.1f} us" for n, us in top) + f" [{tag}]")
    # the same device time by the aten operator that launched it
    ops = [(a.key, a.self_device_time_total, a.count)
           for a in prof.key_averages()
           if a.key.startswith("aten::") and a.self_device_time_total > 0]
    print("profile train block top ops by self device time: " + "; ".join(
        f"{k} {us:.1f} us ({n} calls)"
        for k, us, n in sorted(ops, key=lambda o: -o[1])[:14]) + f" [{tag}]")


def conv_work(b, t, cin, cout, k, which):
    """(FLOP, bytes) one call must do: 2·B·T·Cin·Cout·k; each bf16 input
    read once and each output written once (K3's dW in f32)."""
    flops = 2 * b * t * cin * cout * k
    w_bytes = k * cin * cout * 2
    if which == "fwd":
        nbytes = b * t * cin * 2 + w_bytes + b * t * cout * 2
    elif which == "dx":
        nbytes = b * t * cout * 2 + w_bytes + b * t * cin * 2
    else:
        nbytes = b * t * (cin + cout) * 2 + k * cin * cout * 4
    return flops, nbytes


def device_launches(fn, names, calls=3):
    """CUDA kernels one call of ``fn`` launches, counted by the profiler
    over the device events whose name holds one of ``names`` (None where it
    records none).  A throw-away kernel goes first: the profiler may drop
    the first device event it records."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and any(name in e.name for name in names))
    return n / calls if n else None


def host_ms(fn, calls=100) -> float:
    """Host clock around ``calls`` back-to-back calls ending in a
    synchronise, per call: what a host-bound caller pays, wrapper and
    tensor-map encoding included."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def phase_conv_timing(CB, dev, seed, tag):
    """K2, K3 and K4 at the training shapes: ms per call, CUDA launches
    per call, the plain version, the bound, and the one PyTorch (cuDNN)
    call that computes the same function on channels-first copies made
    outside the timed region.  K3 and K4 in both designs, v2 ("sm90", the
    route these shapes take) and v1 ("sm80"), with a host-inclusive time
    per call of each."""
    out = {}
    cin = cout = 512
    for k in (5, 7):
        x, w, g = conv_inputs(TRAIN_B, TRAIN_T, cin, cout, k, dev, seed + k)
        if CB.route(x.shape, w.shape, 1) != "sm90":
            fail("the training shapes do not route to sm90")
        left = (k - 1) // 2
        xc = x.transpose(1, 2).contiguous()            # (B, Cin, T)
        gc = g.transpose(1, 2).contiguous()            # (B, Cout, T)
        wc = w.permute(2, 1, 0).contiguous()           # (Cout, Cin, K)

        def lib_bwd(mask):
            return torch.ops.aten.convolution_backward(
                gc, xc, wc, None, [1], [left], [1], False, [0], 1, mask)

        plain = {"fwd": lambda: CB.conv_fwd_reference(x, w, 1),
                 "dw": lambda: CB.conv_dw_reference(x, g, k, 1),
                 "dx": lambda: CB.conv_dx_reference(g, w, 1)}
        lib = {"fwd": (lambda: F.conv1d(xc, wc, padding=left),
                       lambda r: r.transpose(1, 2)),
               "dw": (lambda: lib_bwd([False, True, False]),
                      lambda r: r[1].permute(2, 1, 0)),
               "dx": (lambda: lib_bwd([True, False, False]),
                      lambda r: r[0].transpose(1, 2))}
        kern = {("fwd", None): lambda: CB.conv_fwd(x, w, 1)}
        for design in ("sm90", "sm80"):
            kern[("dw", design)] = (
                lambda d=design: CB.conv_dw(x, g, k, 1, design=d))
            kern[("dx", design)] = (
                lambda d=design: CB.conv_dx(g, w, 1, design=d))
        for name in ("fwd", "dw", "dx"):
            lib_call, lib_view = lib[name]
            designs = (None,) if name == "fwd" else ("sm80", "sm90")
            # the library call computes the same function
            _, lib_err = norm_err(lib_view(lib_call()),
                                  kern[(name, designs[-1])]())
            if lib_err > KERNEL_BOUND:
                fail(f"conv {name} k={k}: the library call computes "
                     "another function")
            plain_ms = cuda_ms(plain[name], 10, 2)
            lib_ms = cuda_ms(lib_call, 20, 3)
            flops, nbytes = conv_work(TRAIN_B, TRAIN_T, cin, cout, k, name)
            ops_ms = flops / PEAK_BF16_FLOPS * 1e3
            mem_ms = nbytes / PEAK_BYTES_PER_S * 1e3
            bound_ms = max(ops_ms, mem_ms)
            bound_by = "operations" if ops_ms >= mem_ms else "bytes"
            ms = {d: cuda_ms(kern[(name, d)], 20, 3) for d in designs}
            hosts = {d: [] for d in designs}
            for order in (designs, designs[::-1]):   # v1, v2, v2, v1
                for d in order:
                    hosts[d].append(host_ms(kern[(name, d)]))
            for d in designs:
                kernel = {"fwd": "K2", "dw": "K3", "dx": "K4"}[name]
                host = statistics.mean(hosts[d])
                per_call = device_launches(kern[(name, d)], KERNEL_NAMES)
                print(f"timing conv {kernel}{'' if d is None else ' ' + d} "
                      f"k={k} {TRAIN_B}x{TRAIN_T} {cin}->{cout}: "
                      f"{ms[d]:.4f} ms/call, {per_call} CUDA launches/call, "
                      f"host-inclusive {host:.4f} ms/call (100 back-to-back "
                      f"calls, mean of {len(hosts[d])}), plain "
                      f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms "
                      f"(normalised difference {lib_err:.3g}), bound "
                      f"{bound_ms:.4f} ms by {bound_by} ({flops:.4g} FLOP, "
                      f"{nbytes / 1e6:.1f} MB), "
                      f"{flops / ms[d] / 1e9:.1f} TFLOP/s = "
                      f"{bound_ms / ms[d]:.1%} of bound [{tag}]")
                key = name if d in (None, "sm90") else f"{name}_{d}"
                out[(key, k)] = {"ms": ms[d], "plain_ms": plain_ms,
                                 "library_ms": lib_ms, "bound_ms": bound_ms,
                                 "bound_by": bound_by, "host_ms": host}
            if name != "fwd":
                v1, v2 = out[(f"{name}_sm80", k)], out[(name, k)]
                print(f"timing conv {kernel} k={k}: v2 (sm90) "
                      f"{v2['ms']:.4f} ms vs v1 (sm80) {v1['ms']:.4f} ms = "
                      f"{v1['ms'] / v2['ms']:.2f}x; host-inclusive v2 "
                      f"{v2['host_ms']:.4f} vs v1 {v1['host_ms']:.4f} ms "
                      f"({v2['host_ms'] / v1['host_ms'] - 1:+.1%}); cuDNN "
                      f"{lib_ms:.4f} ms [{tag}]")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    # 1. device check, before anything is printed to stdout
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from xvector_tpu_torch.extract import extractor as TE
    from xvector_tpu_torch.io import kaldi_ark as kio
    from xvector_tpu_torch.models import tdnn as tt
    from xvector_tpu_torch.data import archives as TA
    from xvector_tpu_torch.ops import _build
    from xvector_tpu_torch.ops import conv_bwd as CB
    from xvector_tpu_torch.ops import tdnn_kernel as TK
    from xvector_tpu_torch.train import schedules
    from xvector_tpu_torch.train import trainer as TR

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(card)   # exactly as nvidia-smi gives it
    tag = card

    # 2. build every kernel source, all nvcc processes started together
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s for {sorted(logs)}")
    for src, text in logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "warning")):
                print(f"build {src}: {line.strip()}")

    # 3. K1 against its plain version
    errs = phase_kernel_checks(tt, TK, dev, args.seed)

    # 4. the serving path
    main_launches = phase_serving(tt, TE, TK, kio, dev, args.seed, tag)

    # 5. the serving metric at 32x1024, then K1 at the same shape
    phase_batch_timing(tt, TE, dev, args.seed, tag)
    phase_profile(tt, TE, dev, args.seed, tag)
    k1 = phase_k1_timing(tt, TK, dev, args.seed, tag)

    # 6. K2, K3 and K4 against their plain versions
    conv_errs = phase_conv_checks(CB, dev, args.seed)

    # 7. the training path, then 8. its timings
    with tempfile.TemporaryDirectory() as tmp:
        train_launches, routes = phase_training(TR, TA, CB, schedules,
                                                dev, args.seed, tag, tmp)
        phase_train_timing(TR, dev, args.seed, tag, tmp)
    conv = phase_conv_timing(CB, dev, args.seed, tag)

    kernels = [{
        "name": "tdnn_frame_stack",
        "route": "cuda",
        "source": "xvector_tpu_torch/csrc/tdnn_stack.cu",
        "replaces": "xvector_tpu/ops/tdnn_kernel.py:99",
        "launches": main_launches,
        "max_abs_err": errs[("no_dropout", 32, 1024)],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        # no single PyTorch call computes the whole stack
        "library_ms": None,
    }]
    # K2-K4: the main path makes one k=5 and one k=7 call of each per
    # step, so each time below is the mean of the two per-call times.
    # conv_dw and conv_dx are the sm90 designs the main path runs; the
    # sm80 designs stay for channel counts off 8 (0 main-path launches).
    for key, label, source, line, launches in (
            ("fwd", "conv_fwd", "conv_bwd.cu", 114, train_launches["fwd"]),
            ("dw", "conv_dw", "conv_sm90.cu", 174, routes["dw_sm90"]),
            ("dx", "conv_dx", "conv_sm90.cu", 201, routes["dx_sm90"]),
            ("dw_sm80", "conv_dw_sm80", "conv_bwd.cu", 174,
             routes["dw_sm80"]),
            ("dx_sm80", "conv_dx_sm80", "conv_bwd.cu", 201,
             routes["dx_sm80"])):
        per_k = [conv[(key, k)] for k in (5, 7)]
        mean = {m: sum(c[m] for c in per_k) / 2
                for m in ("ms", "plain_ms", "bound_ms", "library_ms")}
        kernels.append({
            "name": label,
            "route": "cuda",
            "source": f"xvector_tpu_torch/csrc/{source}",
            "replaces": f"xvector_tpu/ops/conv_bwd.py:{line}",
            "launches": launches,
            "max_abs_err": conv_errs[key],
            **mean,
            "bound_by": per_k[0]["bound_by"],
            "shapes": "64x304, 512->512, k=5 and k=7 (mean per call)",
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
