"""Scale-shaped SRE16 run on one NVIDIA GPU: the materialised egs route
against the streamed one (``--stream-egs``) on one synthetic corpus.

    python -m xvector_tpu_torch.bench.scale_sre16 --out DIR
        [--train-spk 400] [--sre-spk 150] [--eval-spk 30]
        [--utts-per-spk 8] [--frames-per-iter 5e6]

The twin of the JAX package's ``tools/scale_sre16.py``.  It writes the
same synthetic corpus from the same numpy draws (:func:`build_corpus`,
byte for byte): pre-built Kaldi data dirs of single-channel PCM SPHERE
utterances (8 per speaker, 6.4-8 s, so that the reference's stage-3
filter of 500 voiced frames keeps them) for training and for the SRE
(PLDA) pool, the SRE16 evaluation tree in the LDC R149_0_1 layout with
its key, and unlabelled majors.  Then it drives
``cli.run_sre16.main`` twice on it with the JAX tool's flags (full
``no_dropout`` width, chunks of 200-400 frames, minibatch 64, 2 epochs,
the derived archive count, final combination of up to 8 models, LDA to
100): once through materialised ``.xta`` archives and once streaming
minibatches from the egs feature ark through the archive plans.

Checks (any failure exits non-zero): each run keeps every checkpoint the
GC policy requires (the last two, every 10th, the combination set of
``train/combine.combine_iterations``); the two loaders yield the same
minibatches, so the two runs' train, valid and train_subset records of
``metrics.jsonl`` are equal as multisets and their EERs are equal.  It
prints each run's summary (wall seconds, stage walls, iterations,
losses, EER and minDCF per variant) with the card's name and power limit
and writes them to ``DIR/scale_results.json``.  Without a card it exits
1."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import Counter
from typing import Dict, List, Tuple

import numpy as np

from ..train.combine import combine_iterations
from .common import CheckFailed, card, card_line, require_card

SR = 8000


def _sphere_pcm(samples: np.ndarray) -> bytes:
    if samples.ndim == 1:
        samples = samples[:, None]
    n, nchan = samples.shape
    head = ("NIST_1A\n   1024\n"
            f"sample_count -i {n}\n"
            f"channel_count -i {nchan}\n"
            f"sample_rate -i {SR}\n"
            "sample_n_bytes -i 2\n"
            "sample_byte_format -s2 10\n"
            "sample_coding -s3 pcm\nend_head\n")
    return head.encode().ljust(1024, b" ") + samples.astype(">i2").tobytes()


def _speaker_wave(rng, spk_seed: int, dur_s: float) -> np.ndarray:
    """Speaker identity = a 3-formant resonance signature + babble."""
    f0 = 250 + (spk_seed * 131) % 2900
    f1 = 350 + (spk_seed * 211) % 2600
    f2 = 500 + (spk_seed * 379) % 2300
    n = int(SR * dur_s)
    t = np.arange(n) / SR
    am = 1.0 + 0.3 * np.sin(2 * np.pi * rng.uniform(1.5, 4.0) * t)
    w = am * (2200 * np.sin(2 * np.pi * f0 * t + rng.uniform(0, 6))
              + 1400 * np.sin(2 * np.pi * f1 * t + rng.uniform(0, 6))
              + 900 * np.sin(2 * np.pi * f2 * t + rng.uniform(0, 6)))
    w += 180 * rng.randn(n)
    return np.clip(w, -32000, 32000)


def _prebuilt_dir(root, prefix, n_spk, utts_per_spk, rng, seed_base,
                  dur_lo=6.4, dur_hi=8.0):
    """A pre-built Kaldi data dir of single-channel SPHERE files."""
    audio = os.path.join(root, "audio")
    os.makedirs(audio, exist_ok=True)
    utt2spk, wavscp = [], []
    for s in range(n_spk):
        for u in range(utts_per_spk):
            utt = f"{prefix}{s:04d}_{u}"
            path = os.path.join(audio, f"{utt}.sph")
            if not os.path.exists(path):
                dur = rng.uniform(dur_lo, dur_hi)
                with open(path, "wb") as f:
                    f.write(_sphere_pcm(_speaker_wave(rng, seed_base + s,
                                                      dur)))
            utt2spk.append(f"{utt} {prefix}spk{s:04d}")
            wavscp.append(f"{utt} {path}")
    with open(os.path.join(root, "utt2spk"), "w") as f:
        f.write("\n".join(utt2spk) + "\n")
    with open(os.path.join(root, "wav.scp"), "w") as f:
        f.write("\n".join(wavscp) + "\n")
    spk2utt = {}
    for line in utt2spk:
        u, s = line.split()
        spk2utt.setdefault(s, []).append(u)
    with open(os.path.join(root, "spk2utt"), "w") as f:
        for s in sorted(spk2utt):
            f.write(f"{s} {' '.join(spk2utt[s])}\n")


def build_corpus(root: str, n_train_spk: int, n_sre_spk: int,
                 n_eval_spk: int, utts_per_spk: int):
    """The synthetic corpus under ``root`` (skipped if its ``.corpus_done``
    marker is there): ``train_dir`` and ``sre_dir`` data dirs, the SRE16
    evaluation tree ``R149_0_1`` with ``download/sre16_evaluation_key``,
    and ``major``, all drawn from ``RandomState(0)``."""
    rng = np.random.RandomState(0)
    os.makedirs(root, exist_ok=True)
    marker = os.path.join(root, ".corpus_done")
    if os.path.exists(marker):
        return
    _prebuilt_dir(os.path.join(root, "train_dir"), "tr", n_train_spk,
                  utts_per_spk, rng, seed_base=10_000)
    _prebuilt_dir(os.path.join(root, "sre_dir"), "sre", n_sre_spk,
                  utts_per_spk, rng, seed_base=20_000)

    # SRE16 eval in the LDC R149_0_1 layout + evaluation key
    ev = os.path.join(root, "R149_0_1")
    for d in ("docs", "data/enrollment", "data/test"):
        os.makedirs(os.path.join(ev, d), exist_ok=True)
    enroll_rows = ["modelid\tsegmentid"]
    segkey_rows = ["segmentid\tsubjectid"]
    key = os.path.join(root, "download", "sre16_evaluation_key")
    os.makedirs(os.path.join(key, "docs"), exist_ok=True)
    os.makedirs(os.path.join(key, "metadata"), exist_ok=True)
    seg_call = ["segmentid callid"]
    calls = []
    trial_rows = ["modelid segmentid side targettype"]
    test_segs = {}
    for s in range(n_eval_spk):
        for u in range(2):
            seg = f"en{s:03d}{u}"
            with open(os.path.join(ev, "data/enrollment",
                                   f"{seg}.sph"), "wb") as f:
                f.write(_sphere_pcm(_speaker_wave(
                    rng, 30_000 + s, rng.uniform(6.4, 8.0))))
            enroll_rows.append(f"model{s:03d}\t{seg}")
        for u in range(2):
            seg = f"te{s:03d}{u}"
            with open(os.path.join(ev, "data/test", f"{seg}.sph"),
                      "wb") as f:
                f.write(_sphere_pcm(_speaker_wave(
                    rng, 30_000 + s, rng.uniform(4.0, 6.0))))
            segkey_rows.append(f"{seg}\tsubj{s:03d}")
            test_segs[seg] = s
    with open(os.path.join(ev, "docs", "sre16_eval_enrollment.tsv"),
              "w") as f:
        f.write("\n".join(enroll_rows) + "\n")
    with open(os.path.join(ev, "docs", "sre16_eval_segment_key.tsv"),
              "w") as f:
        f.write("\n".join(segkey_rows) + "\n")
    for seg, s in test_segs.items():
        seg_call.append(f"{seg} call_{seg}")
        calls.append(f"call_{seg} " + ("tgl" if s % 2 else "yue"))
        for m in range(n_eval_spk):
            tt = "target" if m == s else "nontarget"
            trial_rows.append(f"model{m:03d} {seg} a {tt}")
    with open(os.path.join(key, "docs", "sre16_eval_segment_key.tsv"),
              "w") as f:
        f.write("\n".join(seg_call) + "\n")
    with open(os.path.join(key, "metadata", "calls.tsv"), "w") as f:
        f.write("\n".join(calls) + "\n")
    with open(os.path.join(key, "docs", "sre16_eval_trial_key.tsv"),
              "w") as f:
        f.write("\n".join(trial_rows) + "\n")

    # unlabeled majors: fresh recordings of eval-adjacent speakers
    major = os.path.join(root, "major", "data", "unlabeled", "major")
    os.makedirs(major, exist_ok=True)
    for s in range(n_eval_spk):
        for u in range(2):
            with open(os.path.join(major, f"mj{s:03d}{u}.sph"),
                      "wb") as f:
                f.write(_sphere_pcm(_speaker_wave(
                    rng, 30_000 + s, rng.uniform(5.0, 7.0))))
    open(marker, "w").close()


METRIC_KINDS = ("train", "valid", "train_subset")
PRESERVE_INTERVAL = 10       # run_sre16's --preserve-model-interval default
MAX_COMBINE = 8


def metric_records(work: str) -> List[Tuple]:
    """(kind, iteration, loss, accuracy) of every train, valid and
    train_subset record of the run's ``metrics.jsonl``, in file order."""
    with open(os.path.join(work, "exp", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [(r["kind"], r["iteration"], r["loss"], r["accuracy"])
            for r in recs if r.get("kind") in METRIC_KINDS]


def run_variant(corpus: str, work: str, stream: bool,
                frames_per_iter: float, model: str = "no_dropout",
                device: str = "cuda", compute_dtype: str = "bfloat16",
                num_repeats: int = 35, lda_dim: int = 100) -> Dict:
    """One ``run_sre16`` run on ``corpus`` in ``work`` (``stream``: with
    ``--stream-egs``); raises :class:`CheckFailed` if GC deleted a
    checkpoint the policy keeps, or if the run took the other route (a
    streamed run writes no ``egs.N.xta``, a materialised one does).
    Returns the run's summary with its metric records."""
    from ..cli import run_sre16
    args = [
        "--work-dir", work,
        "--train-data-dir", os.path.join(corpus, "train_dir"),
        "--sre-data-dir", os.path.join(corpus, "sre_dir"),
        "--sre16-eval-root", os.path.join(corpus, "R149_0_1"),
        "--sre16-key-root",
        os.path.join(corpus, "download", "sre16_evaluation_key"),
        "--sre16-major-root", os.path.join(corpus, "major"),
        "--model", model, "--num-epochs", "2",
        "--frames-per-iter", str(frames_per_iter),
        "--min-chunk", "200", "--max-chunk", "400",
        "--minibatch-size", "64", "--num-repeats", str(num_repeats),
        "--do-final-combination", "--max-models-combine", str(MAX_COMBINE),
        "--compute-dtype", compute_dtype, "--lda-dim", str(lda_dim),
        "--device", device,
    ]
    if stream:
        args.append("--stream-egs")
    t0 = time.perf_counter()
    res = run_sre16.main(args)
    wall = time.perf_counter() - t0
    with open(os.path.join(work, "egs_info.json")) as f:
        info = json.load(f)
    records = metric_records(work)
    train_loss = [r[2] for r in records if r[0] == "train"]
    valid = [r[2] for r in records if r[0] == "valid"]
    exp = os.path.join(work, "exp")
    kept = sorted(int(n[6:]) for n in os.listdir(exp)
                  if n.startswith("model_") and n[6:].isdigit())
    # every iteration the GC policy keeps: the last two, the
    # preserve-interval multiples and the combination candidates
    n_iter = len(train_loss)
    expected = {it for it in range(0, n_iter + 1)
                if it >= n_iter - 1 or it % PRESERVE_INTERVAL == 0}
    expected |= set(combine_iterations(n_iter, info["num_archives"],
                                       MAX_COMBINE))
    missing = expected - set(kept)
    if missing:
        raise CheckFailed(f"GC deleted required checkpoints: "
                          f"{sorted(missing)}")
    # the route taken: training archives on disk, or only their plans
    xta = sorted(n for n in os.listdir(work)
                 if n.startswith("egs.") and n.endswith(".xta"))
    if stream == bool(xta):
        raise CheckFailed(f"{'streamed' if stream else 'materialised'} run "
                          f"left training archives {xta}")
    walls_path = os.path.join(work, "stage_walls.json")
    stage_walls = {}
    if os.path.exists(walls_path):
        with open(walls_path) as f:
            stage_walls = json.load(f)
    return {"wall_s": wall, "stage_walls": stage_walls, "stream": stream,
            "gc_extra_kept": sorted(set(kept) - expected),
            "num_archives": info["num_archives"],
            "num_iterations": n_iter,
            "first_loss": train_loss[0], "final_loss": train_loss[-1],
            "final_valid": valid[-1] if valid else None,
            "kept_checkpoints": kept,
            "eer": {k: v["eer"] for k, v in res.items()},
            "min_dcf": {k: v["min_dcf"] for k, v in res.items()},
            "records": records}


def check_same(materialised: Dict, streamed: Dict) -> None:
    """Raise :class:`CheckFailed` unless the two routes trained alike:
    equal metric records as multisets, equal EERs, both scored."""
    a, b = Counter(materialised["records"]), Counter(streamed["records"])
    if not a or a != b:
        raise CheckFailed(
            "materialised and streamed runs differ in their metrics.jsonl "
            f"records: only materialised {sorted((a - b).elements())}, only "
            f"streamed {sorted((b - a).elements())}")
    if not materialised["eer"] or materialised["eer"] != streamed["eer"]:
        raise CheckFailed(f"EERs differ: materialised {materialised['eer']}"
                          f", streamed {streamed['eer']}")


def run_both(out: str, train_spk: int, sre_spk: int, eval_spk: int,
             utts_per_spk: int, frames_per_iter: float, tag: str = "",
             **kw) -> Dict:
    """Build the corpus under ``out``, run both routes (``kw`` goes to
    :func:`run_variant`) and check them; returns both summaries without
    their records."""
    corpus = os.path.join(out, "corpus")
    t0 = time.perf_counter()
    build_corpus(corpus, train_spk, sre_spk, eval_spk, utts_per_spk)
    print(f"scale_sre16: corpus {train_spk}+{sre_spk}+{eval_spk} speakers "
          f"x {utts_per_spk} utterances built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    results = {}
    for stream in (False, True):
        name = "stream" if stream else "materialised"
        results[name] = run_variant(
            corpus, os.path.join(out, f"work_{name}"), stream,
            frames_per_iter, **kw)
        r = results[name]
        print(f"scale_sre16 {name}: {r['wall_s']:.1f} s, "
              f"{r['num_iterations']} iterations over {r['num_archives']} "
              f"archives, loss {r['first_loss']:.4f} -> "
              f"{r['final_loss']:.4f}, EER {r['eer']}, stage walls "
              f"{json.dumps(r['stage_walls'])} [{tag}]", flush=True)
    check_same(results["materialised"], results["stream"])
    return {name: {k: v for k, v in r.items() if k != "records"}
            for name, r in results.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--train-spk", type=int, default=400)
    ap.add_argument("--sre-spk", type=int, default=150)
    ap.add_argument("--eval-spk", type=int, default=30)
    ap.add_argument("--utts-per-spk", type=int, default=8)
    ap.add_argument("--frames-per-iter", type=float, default=5e6)
    args = ap.parse_args(argv)
    require_card("bench.scale_sre16")
    try:
        results = run_both(args.out, args.train_spk, args.sre_spk,
                           args.eval_spk, args.utts_per_spk,
                           args.frames_per_iter, tag=card_line())
    except CheckFailed as exc:
        print(f"bench.scale_sre16: check failed: {exc}", file=sys.stderr)
        return 1
    results["device"] = card()
    with open(os.path.join(args.out, "scale_results.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
