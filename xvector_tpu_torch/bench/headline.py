"""Headline benchmark of the port on one NVIDIA GPU: training throughput in
audio-seconds/s, extraction in embeddings/s, the front end in audio-s/s.

    python -m xvector_tpu_torch.bench.headline [--seed N] [--quick]

The twin of the JAX package's ``bench.py``, at its working point: the
recipe's minibatch of 64 chunks of 304 frames of 23 MFCCs (10 ms frame
shift: 194.56 audio-seconds per minibatch), a 7,185-speaker softmax,
blocks of 16 minibatches, Adam at 1e-3, bf16 with the hand-written conv
kernels (K2-K4) on.  It runs, in this order:

- the dense block train step of ``no_dropout`` (:func:`measure_train_step`,
  the one timing harness; ``bench/dense.py`` and ``bench/adam_mu.py``
  call it too), then ``etdnn``, ``l2_lrelu_attention`` and ``no_dropout``
  with the AM-softmax head;
- the batched front end (``mfcc_batch`` + ``energy_vad_batch``, dither
  off) over 16 utterances of 8 s at 8 kHz;
- the serving forward on one 32x1024 batch in bf16: the fused frame stack
  (K1) that ``XvectorExtractor`` runs, and the unfused stack beside it;
- ``WaveExtractor.extract`` (bf16, K1, batches of 32) over 96 utterances
  of 8 s, host-inclusive, and its device function alone on a batch of 32
  already on the card, with the host's per-call rate beside it.

Training rounds are timed by the host clock around blocks that end in a
synchronise (the eager step is host-bound); the front end and the
device-side extraction by CUDA events around back-to-back calls.  Each
key's value is the median of its rounds; ``spread`` gives the quartiles,
the best round, the count and the window value, and ``<key>_window`` repeats
the last: the whole run's work over its summed round time, which a stalled
round moves.  ``--quick`` cuts only rounds and blocks.

Outputs are checked in the same run, and any failed check exits
non-zero: every training loss is finite and the last block's is below
the first's; each step makes exactly three K2/K3/K4 calls per wide k>1
layer (k·Cin > 160), all on the "sm90" route (6 for ``no_dropout`` and
the attention preset, 9 for ``etdnn``); the fused x-vectors lie within a
cosine of 0.999 of the unfused ones; the wave run returns 96 finite
x-vectors.  The last line is one JSON object of every metric, its window
value, its spread and the card (name, power limit, count).  Without a card
it exits 1."""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..extract.extractor import (ExtractorConfig, WaveExtractor,
                                 WaveExtractorConfig, XvectorExtractor,
                                 pack_wave_batch)
from ..models import tdnn
from ..models.convert import tree_leaves
from ..ops import conv_bwd as CB
from ..ops import features as F
from ..train.optim import make_optimizer
from ..train.trainer import TrainConfig, make_block_train_step
from .common import (CheckFailed, card, card_line, cuda_ms, host_ms,
                     require_card, spread)

NUM_SPEAKERS = 7185          # SRE-scale speaker count
MINIBATCH = 64               # run_xvector.sh:47
FRAMES = 304                 # the recipe's mean chunk (200-400), bucketed
FEAT_DIM = 23
FRAME_SHIFT_S = 0.01
BLOCK = 16                   # minibatches per block step
STEPS = 256                  # minibatch steps per timed round of bench_train
LR = 1e-3
AUDIO_PER_MINIBATCH = MINIBATCH * FRAMES * FRAME_SHIFT_S     # 194.56 s

SAMPLE_RATE = 8000
EXTRACT_CLASSES = 512        # head width of the extraction model
COSINE_BOUND = 0.999         # fused vs unfused x-vectors, both bf16
WAVE_UTTS, WAVE_SECONDS, WAVE_BATCH = 96, 8, 32

# (key, preset, head) of bench_variants
VARIANTS = (("etdnn", "etdnn", "softmax"),
            ("attention", "l2_lrelu_attention", "softmax"),
            ("am_softmax", "no_dropout", "am_softmax"))

# rounds (and blocks, or calls, per round) of each bench: bench.py's run
# lengths, and the cut that --quick takes
RUNS = {
    "default": {"train": (5, STEPS // BLOCK), "variants": (3, 8),
                "features": (4, 64), "extract": (4, 80), "wave": 3,
                "wave_device": (4, 64), "per_call": (4, 16)},
    "quick": {"train": (3, 2), "variants": (2, 1), "features": (3, 16),
              "extract": (3, 10), "wave": 2, "wave_device": (3, 16),
              "per_call": (3, 16)},
}

# every metric of the result object, each with its spread
KEYS = ("train_audio_seconds_per_second_per_chip", "step_ms",
        *(f"train_{key}_audio_s_per_s" for key, _, _ in VARIANTS),
        "features_audio_s_per_s", "extract_embeddings_per_s",
        "extract_unfused_embeddings_per_s",
        "extract_from_wav_embeddings_per_s",
        "extract_from_wav_audio_s_per_s",
        "extract_from_wav_device_embeddings_per_s",
        "extract_from_wav_per_call_embeddings_per_s")

CONV_ROUTES = tuple(f"{k}_{d}" for k in ("fwd", "dw", "dx")
                    for d in ("sm90", "sm80"))


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def train_inputs(block: int = BLOCK, minibatch: int = MINIBATCH,
                 frames: int = FRAMES, num_targets: int = NUM_SPEAKERS):
    """bench.py's draws: one block of float16 features and int32 labels
    from ``RandomState(0)``."""
    rng = np.random.RandomState(0)
    xs = rng.randn(block, minibatch, frames, FEAT_DIM).astype(np.float16)
    ys = rng.randint(0, num_targets, (block, minibatch)).astype(np.int32)
    return xs, ys


def wide_conv_layers(model_cfg: tdnn.TdnnConfig) -> int:
    """Frame layers that take K2-K4 in a bf16 step: k > 1 and k·Cin > 160
    (``models/tdnn._conv1d_same``)."""
    cin, n = model_cfg.feat_dim, 0
    for k, c in zip(model_cfg.kernel_sizes, model_cfg.channels):
        n += int(k > 1 and k * cin > 160)
        cin = c
    return n


def measure_train_step(model: str = "no_dropout", head: str = "softmax",
                       rounds: int = 3, blocks: int = 8, dense: bool = True,
                       adam_moments_dtype: str = "float32", device="cuda",
                       params=None, state=None, return_detail: bool = False,
                       *, compute_dtype: str = "bfloat16", block: int = BLOCK,
                       minibatch: int = MINIBATCH, frames: int = FRAMES,
                       num_targets: int = NUM_SPEAKERS, seed: int = 0):
    """ms per minibatch of the block train step of ``model`` with ``head``:
    the trainer's ``make_block_train_step`` (``dense``: the mask-free
    twin), Adam at 1e-3 (``adam_moments_dtype`` for its first moment),
    ``fused_conv_bwd`` on, over one block of :func:`train_inputs` (``block``
    minibatches of ``minibatch`` x ``frames``; the tests cut them).  One
    block warms up; then ``rounds`` rounds of ``blocks`` blocks are each
    timed by the host clock, ending in a synchronise.

    ``params``/``state`` (trees on ``device``), when given, are the weights
    to carry: ``params`` is updated in place.  Otherwise the weights are
    drawn from ``torch.Generator().manual_seed(seed)``.  Returns the
    median round's ms per minibatch, or with ``return_detail`` a dict:
    ``rounds_ms``, ``step_ms`` (their spread, None without rounds),
    ``first_block_s``, ``losses`` (each block's mean loss, the warm-up's
    first), ``steps``, ``conv_calls`` (K2/K3/K4 calls by route over all
    steps), ``device`` (its type), ``params`` and ``state``."""
    dev = resolve_device(device)
    model_cfg = tdnn.MODEL_ZOO[model]
    cfg = TrainConfig(model=model, num_targets=num_targets,
                      compute_dtype=compute_dtype, block_size=block,
                      head=head, adam_moments_dtype=adam_moments_dtype,
                      fused_conv_bwd=True)
    if params is None:
        params, state = tdnn.init_params(
            torch.Generator().manual_seed(seed), model_cfg, num_targets,
            device=dev)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    opt = make_optimizer("adam", leaves, LR,
                         moments_dtype=adam_moments_dtype)
    step = make_block_train_step(model_cfg, cfg, dense=dense)
    xs_np, ys_np = train_inputs(block, minibatch, frames, num_targets)
    xs, ys = torch.from_numpy(xs_np).to(dev), torch.from_numpy(ys_np).to(dev)
    t_lens, n_rows = [frames] * block, [minibatch] * block
    gen = torch.Generator(device=dev).manual_seed(1)
    losses: List[torch.Tensor] = []
    before = dict(CB.route_launches)

    def run_block():
        nonlocal state
        state, m = step(params, opt, state, xs, ys, t_lens, n_rows, LR, 1.0,
                        1.0, gen)
        losses.append(m["loss"])

    t0 = time.perf_counter()
    run_block()
    _sync(dev)
    first_block_s = time.perf_counter() - t0
    rounds_ms = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(blocks):
            run_block()
        _sync(dev)
        rounds_ms.append((time.perf_counter() - t0) * 1e3 / (blocks * block))
    calls = {r: CB.route_launches[r] - before[r] for r in CONV_ROUTES}
    if not return_detail:
        return spread(rounds_ms)["median"]
    return {"rounds_ms": rounds_ms,
            "step_ms": spread(rounds_ms) if rounds_ms else None,
            "first_block_s": first_block_s,
            "losses": [float(l) for l in losses],
            "steps": len(losses) * block, "conv_calls": calls,
            "device": dev.type,
            "params": params, "state": state}


def check_train(label: str, model: str, detail: Dict) -> int:
    """Raise :class:`CheckFailed` unless every loss is finite, the last
    block's is below the first's, and on a card each step made exactly
    three K2/K3/K4 calls per wide layer, all "sm90" (on the CPU: none);
    returns the calls per step on a card."""
    losses = detail["losses"]
    if not all(math.isfinite(l) for l in losses):
        raise CheckFailed(f"{label}: a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise CheckFailed(f"{label}: the loss did not fall: first block "
                          f"{losses[0]}, last {losses[-1]}")
    wide = wide_conv_layers(tdnn.MODEL_ZOO[model])
    steps = detail["steps"]
    # on the CPU the wrappers run their plain versions and launch nothing
    on_card = detail["device"] == "cuda"
    want = {r: wide * steps if on_card and r.endswith("sm90") else 0
            for r in CONV_ROUTES}
    if detail["conv_calls"] != want:
        raise CheckFailed(
            f"{label}: K2/K3/K4 calls {detail['conv_calls']} over {steps} "
            f"steps; expected {3 * wide} per step ({wide} wide layers), all "
            "on sm90")
    return 3 * wide


def compare_kw(key: str, values: Dict[str, object], rounds: int = 5,
               blocks: int = 8, device="cuda", seed: int = 0, tag: str = "",
               model: str = "no_dropout", **kw) -> Dict:
    """:func:`measure_train_step` once for each ``name: value`` of
    ``values``, with its keyword ``key`` set to ``value``, each run checked
    by :func:`check_train`: per name ``step_ms_<name>`` (the median round)
    with its ``_spread``, ``first_block_s_<name>`` and ``loss_<name>`` (the
    last block's), and ``gain_pct``, how much faster the second run is than
    the first in percent (``model`` and ``kw`` go to
    ``measure_train_step``: the tests cut them)."""
    out, names = {}, list(values)
    for name in names:
        d = measure_train_step(model, rounds=rounds, blocks=blocks,
                               device=device, return_detail=True, seed=seed,
                               **{key: values[name]}, **kw)
        check_train(f"{key}={values[name]}", model, d)
        out[f"step_ms_{name}"] = d["step_ms"]["median"]
        out[f"step_ms_{name}_spread"] = d["step_ms"]
        out[f"first_block_s_{name}"] = d["first_block_s"]
        out[f"loss_{name}"] = d["losses"][-1]
        print(f"{key}={values[name]}: step {d['step_ms']['median']:.4f} ms "
              f"per minibatch, last loss {d['losses'][-1]:.6f} [{tag}]",
              flush=True)
    first, second = (out[f"step_ms_{n}"] for n in names)
    out["gain_pct"] = 100.0 * (first - second) / first
    return out


def _rates(rounds_ms: List[float], per_unit: float) -> List[float]:
    """Per-round rates (units per second) from per-round ms per item."""
    return [per_unit * 1e3 / ms for ms in rounds_ms]


def bench_train(runs: Dict, dev, seed: int, say: Callable) -> Dict:
    """The dense block step of ``no_dropout``: audio-s/s and ms per
    minibatch."""
    rounds, blocks = runs["train"]
    detail = measure_train_step("no_dropout", "softmax", rounds, blocks,
                                device=dev, return_detail=True, seed=seed)
    per_step = check_train("train no_dropout", "no_dropout", detail)
    rates = _rates(detail["rounds_ms"], AUDIO_PER_MINIBATCH)
    say("train no_dropout", detail, per_step)
    return {"train_audio_seconds_per_second_per_chip": spread(rates, max),
            "step_ms": detail["step_ms"]}


def bench_variants(runs: Dict, dev, seed: int, say: Callable) -> Dict:
    """audio-s/s of the E-TDNN, attention-pooling and AM-softmax steps."""
    rounds, blocks = runs["variants"]
    out = {}
    for key, model, head in VARIANTS:
        detail = measure_train_step(model, head, rounds, blocks, device=dev,
                                    return_detail=True, seed=seed)
        per_step = check_train(f"train {key}", model, detail)
        say(f"train {key} ({model}, {head})", detail, per_step)
        out[f"train_{key}_audio_s_per_s"] = spread(
            _rates(detail["rounds_ms"], AUDIO_PER_MINIBATCH), max)
    return out


# ---------------------------------------------------------------------------
# front end and extraction
# ---------------------------------------------------------------------------

FEATURE_CFG = F.MfccConfig(dither=0.0)


def feature_inputs(b: int = 16, seconds: int = 8):
    """bench.py's draws: ``b`` utterances of white noise at 2000 rms."""
    rng = np.random.RandomState(0)
    s = seconds * SAMPLE_RATE
    return ((rng.randn(b, s) * 2000).astype(np.float32),
            np.full(b, s, np.int32))


def features_batch(waves: torch.Tensor, lens: torch.Tensor):
    """The front end the bench times: (feats, frame mask, VAD)."""
    with torch.inference_mode():
        feats, mask = F.mfcc_batch(waves, lens, FEATURE_CFG)
        return feats, mask, F.energy_vad_batch(feats, mask)


def bench_features(runs: Dict, dev) -> Dict:
    rounds, iters = runs["features"]
    waves, lens = feature_inputs()
    w, n = torch.from_numpy(waves).to(dev), torch.from_numpy(lens).to(dev)
    audio = waves.shape[0] * waves.shape[1] / SAMPLE_RATE
    ms = [cuda_ms(lambda: features_batch(w, n), iters) for _ in range(rounds)]
    return {"features_audio_s_per_s": spread(_rates(ms, audio), max)}


def extract_model(dev, seed: int):
    """``no_dropout`` with a 512-class head, weights drawn from ``seed``."""
    cfg = tdnn.MODEL_ZOO["no_dropout"]
    params, state = tdnn.init_params(torch.Generator().manual_seed(seed),
                                     cfg, EXTRACT_CLASSES, device=dev)
    return cfg, params, state


def extract_inputs(b: int, t: int):
    """bench.py's draw: (b, t, 23) f32 features, every frame real."""
    x = np.random.RandomState(0).randn(b, t, FEAT_DIM).astype(np.float32)
    return x, np.ones((b, t), np.float32)


def extractor(cfg, params, state, dev, fused: bool = True,
              compute_dtype: str = "bfloat16") -> XvectorExtractor:
    """The serving extractor: the fused stack (K1) or the unfused one."""
    return XvectorExtractor(cfg, params, state,
                            ExtractorConfig(compute_dtype=compute_dtype,
                                            use_fused=fused), device=dev)


def extract_batch(ex: XvectorExtractor, x: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """(B, E) f32 x-vectors of one batch already on the device: the
    extractor's forward, as ``XvectorExtractor._run`` calls it."""
    with torch.inference_mode():
        return ex._forward(x, mask)


def min_cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a * b).sum(-1).div(a.norm(dim=-1) * b.norm(dim=-1)).min())


def bench_extract(runs: Dict, dev, seed: int, say_line: Callable) -> Dict:
    """Embeddings/s of one 32x1024 batch through the fused and the unfused
    stack (bf16), by CUDA events; the two agree within the cosine bound."""
    rounds, iters = runs["extract"]
    cfg, params, state = extract_model(dev, seed)
    xn, mn = extract_inputs(32, 1024)
    x, mask = torch.from_numpy(xn).to(dev), torch.from_numpy(mn).to(dev)
    out = {}
    vecs = {}
    for fused, key in ((True, "extract_embeddings_per_s"),
                       (False, "extract_unfused_embeddings_per_s")):
        ex = extractor(cfg, params, state, dev, fused)
        vecs[fused] = extract_batch(ex, x, mask)
        ms = [cuda_ms(lambda: extract_batch(ex, x, mask), iters)
              for _ in range(rounds)]
        out[key] = spread(_rates(ms, x.shape[0]), max)
    cos = min_cosine(vecs[True], vecs[False])
    if not (torch.isfinite(vecs[True]).all() and cos >= COSINE_BOUND):
        raise CheckFailed(f"extract: fused vs unfused x-vectors, min cosine "
                          f"{cos:.6f} (bound {COSINE_BOUND})")
    say_line(f"extract 32x1024: fused vs unfused min cosine {cos:.6f}")
    return out


def wave_inputs(n: int = WAVE_UTTS, seconds: int = WAVE_SECONDS):
    rng = np.random.RandomState(0)
    return [(f"u{i}", (rng.randn(seconds * SAMPLE_RATE) * 2000)
             .astype(np.float32)) for i in range(n)]


def wave_extractor(dev, seed: int) -> WaveExtractor:
    cfg, params, state = extract_model(dev, seed)
    return WaveExtractor(cfg, params, state,
                         WaveExtractorConfig(batch_size=WAVE_BATCH,
                                             use_fused=True), device=dev)


def bench_extract_wave(runs: Dict, dev, seed: int) -> Dict:
    """``WaveExtractor.extract`` over 96 utterances of 8 s, host-inclusive
    (the host's packing and upload, the device's front end and K1)."""
    wex = wave_extractor(dev, seed)
    utts = wave_inputs()
    wex.extract(iter(utts))                  # warm-up
    secs = []
    for _ in range(runs["wave"]):
        t0 = time.perf_counter()
        out = wex.extract(iter(utts))
        secs.append(time.perf_counter() - t0)
    if (len(out) != WAVE_UTTS
            or not all(np.isfinite(v).all() for v in out.values())):
        raise CheckFailed(f"extract_wave: {len(out)} x-vectors back for "
                          f"{WAVE_UTTS} utterances, or one is not finite")
    return {"extract_from_wav_embeddings_per_s": spread(
                [WAVE_UTTS / s for s in secs], max),
            "extract_from_wav_audio_s_per_s": spread(
                [WAVE_UTTS * WAVE_SECONDS / s for s in secs], max)}


def bench_extract_wave_device(runs: Dict, dev, seed: int) -> Dict:
    """The wave extractor's device function alone on a 32x8 s batch already
    on the card, by CUDA events; beside it the host's rate per call
    (dispatch included, synchronised after each run of calls)."""
    wex = wave_extractor(dev, seed)
    waves, lens = pack_wave_batch(wave_inputs(WAVE_BATCH),
                                  WAVE_SECONDS * SAMPLE_RATE, WAVE_BATCH)
    w, n = torch.from_numpy(waves).to(dev), torch.from_numpy(lens).to(dev)

    def call():
        return wex._fn(wex.params, wex.state, w, n, None)

    rounds, iters = runs["wave_device"]
    dev_ms = [cuda_ms(call, iters) for _ in range(rounds)]
    rounds, iters = runs["per_call"]
    call_ms = [host_ms(call, iters) for _ in range(rounds)]
    return {"extract_from_wav_device_embeddings_per_s": spread(
                _rates(dev_ms, WAVE_BATCH), max),
            "extract_from_wav_per_call_embeddings_per_s": spread(
                _rates(call_ms, WAVE_BATCH), max)}


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def run(seed: int = 0, quick: bool = False, device="cuda",
        tag: Optional[str] = None) -> Dict:
    """Every bench on ``device`` (a card); prints each metric tagged with
    ``tag`` (the card's name and power limit) and returns the result
    object.  Raises :class:`CheckFailed` when an output is wrong."""
    dev = resolve_device(device)
    runs = RUNS["quick" if quick else "default"]
    tag = card_line() if tag is None else tag

    def say_line(text: str):
        print(f"{text} [{tag}]", flush=True)

    def say_train(label, detail, per_step):
        s = detail["step_ms"]
        say_line(f"{label}: {s['median']:.4f} ms per 64x304 minibatch "
                 f"(q1 {s['q1']:.4f}, q3 {s['q3']:.4f}, best {s['best']:.4f}"
                 f", n {s['n']}), first block {detail['first_block_s']:.2f}"
                 f" s, loss {detail['losses'][0]:.4f} -> "
                 f"{detail['losses'][-1]:.4f}, {per_step} K2/K3/K4 calls "
                 "per step on sm90")

    spreads: Dict[str, Dict] = {}
    spreads.update(bench_train(runs, dev, seed, say_train))
    spreads.update(bench_variants(runs, dev, seed, say_train))
    spreads.update(bench_features(runs, dev))
    spreads.update(bench_extract(runs, dev, seed, say_line))
    spreads.update(bench_extract_wave(runs, dev, seed))
    spreads.update(bench_extract_wave_device(runs, dev, seed))
    if sorted(spreads) != sorted(KEYS):
        raise CheckFailed(f"metrics {sorted(spreads)}, expected "
                          f"{sorted(KEYS)}")
    for key, s in spreads.items():
        say_line(f"{key}: {s['median']} (q1 {s['q1']}, q3 {s['q3']}, best "
                 f"{s['best']}, n {s['n']}, window {s['window']})")
    value = spreads["train_audio_seconds_per_second_per_chip"]["median"]
    return {"metric": "train_audio_seconds_per_second_per_chip",
            "value": value, "unit": "audio_s/s/chip",
            **{key: s["median"] for key, s in spreads.items()},
            **{f"{key}_window": s["window"] for key, s in spreads.items()},
            "spread": spreads, "quick": quick, "seed": seed,
            "device": card()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ap.add_argument("--quick", action="store_true",
                    help="fewer rounds and blocks (chip_smoke.py's cut)")
    args = ap.parse_args(argv)
    require_card("bench.headline")
    try:
        result = run(args.seed, args.quick)
    except CheckFailed as exc:
        print(f"bench.headline: check failed: {exc}", file=sys.stderr)
        return 1
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
