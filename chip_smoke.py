#!/usr/bin/env python3
"""Drive the PyTorch port's x-vector extraction path on one NVIDIA GPU.

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
   idle share), and K1 at 32x1024 against its plain version and its bound.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Float32 matmuls run in full f32
(``torch.backends.cuda.matmul.allow_tf32 = False``) so the plain version
is a true f32 referee.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

KERNEL_BOUND = 1e-2        # max |kernel - plain| / max |plain|
COSINE_BOUND = 0.999       # fused vs unfused x-vectors, both bf16
F32_BOUND = 1e-3           # card f32 vs CPU f32 x-vectors, normalised
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
FRAMES_PER_SECOND = 100    # 10 ms frame shift
EXTRACT_PAIRS = 5          # timed fused/unfused extraction pairs


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
    from xvector_tpu_torch.ops import _build
    from xvector_tpu_torch.ops import tdnn_kernel as TK

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
            if "registers" in line or "spill" in line:
                print(f"build {src}: {line.strip()}")

    # 3. K1 against its plain version
    errs = phase_kernel_checks(tt, TK, dev, args.seed)

    # 4. the serving path
    main_launches = phase_serving(tt, TE, TK, kio, dev, args.seed, tag)

    # 5. the serving metric at 32x1024, then K1 at the same shape
    phase_batch_timing(tt, TE, dev, args.seed, tag)
    phase_profile(tt, TE, dev, args.seed, tag)
    k1 = phase_k1_timing(tt, TK, dev, args.seed, tag)

    print(json.dumps({"kernels": [{
        "name": "tdnn_frame_stack",
        "route": "cuda",
        "source": "xvector_tpu_torch/csrc/tdnn_stack.cu",
        "replaces": "xvector_tpu/ops/tdnn_kernel.py:97",
        "launches": main_launches,
        "max_abs_err": errs[("no_dropout", 32, 1024)],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        # no single PyTorch call computes the whole stack
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
