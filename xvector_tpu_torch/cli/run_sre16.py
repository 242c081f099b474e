"""SRE16 recipe entry point — the 1:1 counterpart of the reference's
``run.sh`` stages 0-10 (``run.sh:39-313``), composed from the port's own
pieces instead of Kaldi binaries and SGE jobs:

  stage 0  corpus prep: typed builders for SWBD cellular 1-2, SWBD2
           phases 1-3, SRE04-08/10, SRE16 major (unlabeled) and eval
           enroll/test + trial key (run.sh:39-92, local/make_*_BUT.*)
  stage 1  MFCC + energy VAD, batched on device (run.sh:94-111)
  stage 2  MUSAN/RIR augmentation of the training set (run.sh:113-171)
  stage 3  filtering: min frames / min utts per speaker (run.sh:173-187)
  stage 4-6  egs generation + TDNN training (run.sh:189-223)
  stage 7  x-vector extraction for train / major / enroll / test
           (run.sh:225-248), enroll speaker means + num_utts
  stage 8-10  the dual-scoring back-end: LDA + PLDA out-of-domain AND
           adapted, pooled + per-language EER/minDCF (run.sh:250-313)

Every corpus root is optional — whatever subset is given becomes the
training pool (the reference requires all of them up front).  All stages
are idempotent; ``--stage N`` forces recomputation from stage N.

Counterpart of ``xvector_tpu/cli/run_sre16.py``: the same flags, the same
outputs under the same names (``stage_walls.json``, ``sre16_results.json``,
``scores_<variant>.txt``/``.tsv``, the ``xvector_<split>.scp`` files) and
the same returned dict.  Every stage runs on ``--device`` (``cuda`` unless
the caller asks for ``cpu``): training through K2-K4, extraction through
K1 where the topology and dtype take it.  On a host with several visible
cards the training stage runs on all of them, one rank per card, as the
JAX package's trains on every local chip (``parallel/launch.run``;
``CUDA_VISIBLE_DEVICES`` picks the cards): rank 0 alone runs the corpus
prep, features and egs while the other ranks wait, then every rank trains
(``Recipe.train(num_targets, mesh)``), and rank 0 alone extracts, scores
and writes every output.  The process that started the ranks returns what
rank 0 wrote to ``sre16_results.json`` (each variant's EER, minDCF and
trial count, without the per-trial scores).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np

from .. import resolve_device
from ..data import allocator as alloclib
from ..data import corpora
from ..extract.extractor import ExtractorConfig, speaker_means
from ..io.datadir import DataDir
from ..io.wav import load_wave
from ..parallel import launch
from ..train.trainer import TrainConfig
from .run import Recipe, RecipeConfig, _LazyWaves


def build_train_corpus(args):
    """Stage 0 training pool: the union of whatever corpora were given
    (run.sh:60-66 combine_data).

    Returns ``(train, sre_speakers)`` where ``sre_speakers`` is the
    speaker set of the SRE portion — everything combined into ``data/sre``
    by run.sh:60-66 (SRE04-06, SRE08, SRE10, Mixer6) plus any
    ``--sre-data-dir``.  The LDA/PLDA back-end trains on exactly this
    subset's utterances (clean + augmented), the ``sre_combined`` filter
    of run.sh:181-185."""
    parts = []            # (DataDir, is_sre)
    if args.swbd_cell1_root:
        parts.append((corpora.make_swbd_cellular(args.swbd_cell1_root, 1),
                      False))
    if args.swbd_cell2_root:
        parts.append((corpora.make_swbd_cellular(args.swbd_cell2_root, 2),
                      False))
    for phase, root in ((1, args.swbd2_phase1_root),
                        (2, args.swbd2_phase2_root),
                        (3, args.swbd2_phase3_root)):
        if root:
            parts.append((corpora.make_swbd2_phase(root, phase), False))
    if args.sre_data_root and args.sre_speaker_list:
        # one DataDir per SRE04-06 partition found under the root
        for dd in corpora.make_sre_04_to_06(args.sre_data_root,
                                            args.sre_speaker_list).values():
            parts.append((dd, True))
    if args.sre08_train_root and args.sre08_test_root \
            and args.sre08_key_root:
        parts.append((corpora.make_sre08(args.sre08_key_root,
                                         args.sre08_test_root,
                                         args.sre08_train_root), True))
    if args.sre10_root:
        parts.append((corpora.make_sre10(args.sre10_root), True))
    if args.mx6_root:
        # Mixer6 belongs to the data/sre combine (run.sh:60-66)
        parts.append((corpora.make_mx6(args.mx6_root)["all"], True))
    if args.sre_data_dir:            # pre-built dir counted as data/sre
        from ..io.datadir import load_data_dir
        parts.append((load_data_dir(args.sre_data_dir), True))
    if args.train_data_dir:          # pre-built Kaldi data dir escape hatch
        from ..io.datadir import load_data_dir
        parts.append((load_data_dir(args.train_data_dir), False))
    if not parts:
        raise SystemExit("no training corpora given (pass --swbd-*/"
                         "--sre-*/--train-data-dir roots)")
    sre_speakers = set()
    for dd, is_sre in parts:
        if is_sre:
            sre_speakers.update(dd.speakers)
    dds = [dd for dd, _ in parts]
    train = dds[0].combine(*dds[1:]) if len(dds) > 1 else dds[0]
    return train.validate(), sre_speakers


def wav_provider_for(data: DataDir, target_sr: int = 8000
                     ) -> Callable[[str], np.ndarray]:
    def provider(utt: str) -> np.ndarray:
        samples, rate = load_wave(data.wav[utt])
        if target_sr and rate and rate != target_sr:
            from ..io.wav import resample
            samples = resample(samples, rate, target_sr)
        return samples
    return provider


# run_sre16's documented stage numbers (0-10, the run.sh layout) →
# Recipe.force_from_stage's artifact stages (1 features, 2 egs, 3 train,
# 4 extract; scoring has no artifacts and always recomputes)
_STAGE_TO_RECIPE = {0: 1, 1: 1, 2: 1, 3: 1, 4: 2, 5: 2, 6: 3, 7: 4}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--work-dir", required=True)
    ap.add_argument("--stage", type=int, default=-1,
                    help="force re-runs from this stage (run.sh gating); "
                         "-1 = idempotent auto-skip")
    # corpus roots (run.sh:44-92) — all optional, union becomes training
    ap.add_argument("--swbd-cell1-root", default="")
    ap.add_argument("--swbd-cell2-root", default="")
    ap.add_argument("--swbd2-phase1-root", default="")
    ap.add_argument("--swbd2-phase2-root", default="")
    ap.add_argument("--swbd2-phase3-root", default="")
    ap.add_argument("--sre-data-root", default="",
                    help="root holding SRE04-06 deliveries")
    ap.add_argument("--sre-speaker-list", default="")
    ap.add_argument("--sre08-train-root", default="")
    ap.add_argument("--sre08-test-root", default="")
    ap.add_argument("--sre08-key-root", default="")
    ap.add_argument("--sre10-root", default="")
    ap.add_argument("--mx6-root", default="",
                    help="Mixer-6 root (mic subset + calls, run.sh:56-58)")
    ap.add_argument("--train-data-dir", default="",
                    help="pre-built Kaldi data dir to add to the pool "
                         "(counted as non-SRE, i.e. excluded from the "
                         "PLDA training subset)")
    ap.add_argument("--sre-data-dir", default="",
                    help="pre-built Kaldi data dir counted as part of "
                         "data/sre: its speakers join the training pool "
                         "AND define the LDA/PLDA training subset "
                         "(sre_combined, run.sh:181-185)")
    ap.add_argument("--sre16-major-root", default="",
                    help="SRE16 unlabeled major-language root (the "
                         "adaptation/centering set, run.sh:252)")
    ap.add_argument("--sre16-eval-root", required=True)
    ap.add_argument("--sre16-key-root", default="",
                    help="sre16_evaluation_key root (defaults to the "
                         "reference layout next to the eval root)")
    ap.add_argument("--musan-dir", default="")
    ap.add_argument("--rirs-dir", default="")
    # model / training knobs (run_xvector.sh:50-108)
    ap.add_argument("--model", default="no_dropout")
    ap.add_argument("--num-epochs", type=int, default=2)
    ap.add_argument("--num-archives", type=int, default=0,
                    help="0 (default) derives the count from the "
                         "get_egs.sh:120 formula: num_train_frames * "
                         "num_repeats / frames_per_iter + 1")
    ap.add_argument("--frames-per-iter", type=float, default=1e9,
                    help="frames per training archive (run_xvector.sh:56)")
    ap.add_argument("--min-chunk", type=int, default=200)
    ap.add_argument("--max-chunk", type=int, default=400)
    ap.add_argument("--minibatch-size", type=int, default=64)
    ap.add_argument("--num-repeats", type=int, default=35)
    # stage-3 filters at their reference values (run.sh:197-212)
    ap.add_argument("--min-utt-frames", type=int, default=500,
                    help="drop utts with <= this many voiced frames "
                         "(run.sh:199 min_len, awk '$2 > min_len')")
    ap.add_argument("--min-spk-utts", type=int, default=8,
                    help="drop speakers with fewer utterances than this "
                         "(run.sh:210 min_num_utts)")
    ap.add_argument("--num-valid-utts", type=int, default=200,
                    help="held-out diagnostics utts (get_egs.sh:44)")
    ap.add_argument("--compute-dtype", default="bfloat16")
    ap.add_argument("--lda-dim", type=int, default=100)   # run.sh:28
    ap.add_argument("--extract-from-wav", action="store_true")
    ap.add_argument("--do-final-combination", action="store_true",
                    help="optimize a convex combination of the last "
                         "iterations' checkpoints on the diagnostics "
                         "subset (working version of the reference's "
                         "disabled combination, train_dnn.py:571-581)")
    ap.add_argument("--preserve-model-interval", type=int, default=10,
                    help="checkpoint GC keeps every Nth iteration "
                         "(run_xvector.sh:106)")
    ap.add_argument("--max-models-combine", type=int, default=20,
                    help="combination candidate-set cap "
                         "(ze_utils.py:76)")
    ap.add_argument("--stream-egs", action="store_true",
                    help="skip .xta materialisation; training streams "
                         "minibatches from the egs feature ark through "
                         "each archive's ranges plan")
    ap.add_argument("--device", default="cuda",
                    help="where every stage runs (cuda, or cpu)")
    args = ap.parse_args(argv)
    resolve_device(args.device)      # no card: raise before any work
    return launch.run("xvector_tpu_torch.cli.run_sre16", argv, args.device,
                      args.work_dir,
                      lambda device, mesh: _run(args, device, mesh),
                      read_result=lambda: _read_results(args.work_dir))


def _read_results(work_dir: str) -> dict:
    with open(os.path.join(work_dir, "sre16_results.json")) as f:
        return json.load(f)


def _config(args, num_valid_utts: int, device) -> RecipeConfig:
    return RecipeConfig(
        work_dir=args.work_dir,
        min_utt_frames=args.min_utt_frames,
        min_spk_utts=args.min_spk_utts,
        num_valid_utts=num_valid_utts,
        num_archives=args.num_archives,
        allocator=alloclib.AllocatorConfig(
            min_frames=args.min_chunk, max_frames=args.max_chunk,
            minibatch_size=args.minibatch_size,
            num_repeats=args.num_repeats,
            frames_per_iter=int(args.frames_per_iter)),
        train=TrainConfig(model=args.model, num_targets=1,
                          num_epochs=args.num_epochs,
                          compute_dtype=args.compute_dtype,
                          final_combine=args.do_final_combination,
                          max_models_combine=args.max_models_combine,
                          preserve_model_interval=
                          args.preserve_model_interval),
        extractor=ExtractorConfig(min_chunk=25, max_chunk=10000,
                                  compute_dtype=args.compute_dtype),
        lda_dim=args.lda_dim,
        stream_egs=args.stream_egs,
        device=str(device))


def _run(args, device, mesh):
    """``main``'s stages on ``device``, as one rank of ``mesh`` (or alone
    without one): stages 0-6 before training on rank 0 alone, training on
    every rank, the rest on rank 0."""
    # per-stage wall clocks → <work_dir>/stage_walls.json, so a run's
    # end-to-end wall can be attributed to a stage
    stage_walls: Dict[str, float] = {}
    _lap_t = [time.time()]

    def lap(name: str):
        now = time.time()
        stage_walls[name] = round(
            stage_walls.get(name, 0.0) + now - _lap_t[0], 1)
        _lap_t[0] = now

    def write_walls():
        stage_walls["total"] = round(sum(
            v for k, v in stage_walls.items() if k != "total"), 1)
        os.makedirs(args.work_dir, exist_ok=True)
        with open(os.path.join(args.work_dir, "stage_walls.json"),
                  "w") as f:
            json.dump(stage_walls, f, indent=1)

    # the host stages: rank 0 alone, the other ranks wait outside any
    # collective
    with launch.Rank0Stage(mesh, args.work_dir, "egs") as stage:
        if stage.runs_here:
            print("== stage 0: corpus prep")
            train_data, sre_speakers = build_train_corpus(args)
            eval_full = corpora.make_sre16_eval_full(
                args.sre16_eval_root, key_root=args.sre16_key_root or None)
            enroll_data: DataDir = eval_full["enroll"]
            test_data: DataDir = eval_full["test"]
            trials = eval_full["trials"]
            utt2lang: Dict[str, str] = eval_full["utt2lang"]
            major_data: Optional[DataDir] = (
                corpora.make_sre16_unlabeled(args.sre16_major_root)
                if args.sre16_major_root else None)
            print(f"   train {len(train_data)} utts / "
                  f"{len(train_data.speakers)} spk; "
                  f"enroll {len(enroll_data)}; test {len(test_data)}; "
                  f"trials {len(trials)}; "
                  f"major {len(major_data) if major_data else 0}")

            cfg = _config(args, max(2, min(args.num_valid_utts,
                                           len(train_data) // 10)), device)
            recipe = Recipe(cfg)
            if args.stage >= 0:
                recipe_stage = _STAGE_TO_RECIPE.get(args.stage, 99)
                print(f"== forcing re-run from stage {args.stage} "
                      f"(recipe artifact stage {recipe_stage})")
                recipe.force_from_stage(recipe_stage)

            sr = cfg.mfcc.sample_rate
            provider = wav_provider_for(train_data, target_sr=sr)
            if args.musan_dir or args.rirs_dir:
                print("== stage 2: augmentation")
                sr = cfg.mfcc.sample_rate
                rirs = noises = musics = speeches = None
                if args.rirs_dir:
                    rooms = corpora.make_rirs(args.rirs_dir)
                    rirs = {room: _LazyWaves(paths, target_sr=sr)
                            for room, paths in rooms.items()
                            if paths} or None
                if args.musan_dir:
                    musan = corpora.make_musan(args.musan_dir)

                    def lazy(cat):
                        dd = musan.get(cat)
                        return (_LazyWaves([dd.wav[u] for u in dd.utts],
                                           target_sr=sr) if dd else None)

                    noises, musics, speeches = (
                        lazy("noise"), lazy("music"), lazy("speech"))
                train_data, provider = recipe.augment(
                    train_data, provider, rirs=rirs, noises=noises,
                    musics=musics, speeches=speeches)
            lap("prep_augment")

            print(f"== stage 1: features (train: {len(train_data)} utts)")
            train_feats = recipe.make_features(train_data, provider,
                                               split="train")
            lap("features")
            print("== stage 4-6: egs + train")
            train_dir, _valid_dir, num_targets = recipe.make_egs(
                train_feats)
            print(f"   {num_targets} speakers, {recipe.num_archives} "
                  "archives")
            lap("egs")
            stage.result = {"num_targets": num_targets,
                            "num_archives": recipe.num_archives,
                            "num_valid_utts": cfg.num_valid_utts}
    if not stage.runs_here:
        recipe = Recipe(_config(args, stage.result["num_valid_utts"],
                                device))
        recipe.num_archives = stage.result["num_archives"]
    trainer = recipe.train(stage.result["num_targets"], mesh)
    lap("train")
    if not launch.leave_group(mesh):
        return None

    print("== stage 7: extraction")

    def extract_split(data: DataDir, split: str) -> Dict[str, np.ndarray]:
        prov = wav_provider_for(data, target_sr=sr)
        if args.extract_from_wav:
            return recipe.extract_from_wav(trainer, data, prov, split)
        feats = recipe.make_features(data, prov, split=split)
        return recipe.extract(trainer, feats, split=split)

    # The LDA/PLDA training pool is sre_combined — the SRE-speaker subset
    # of the combined clean+augmented list (run.sh:181-185), extracted at
    # stage 7 like the eval sets (run.sh:236-241) and NOT subject to the
    # stage-3 egs filters.  Augmented copies inherit their speaker, so
    # the speaker-membership filter reproduces filter_scp.pl on spk2utt.
    plda_utts = [u for u in train_feats.utts
                 if train_feats.utt2spk[u] in sre_speakers]
    if plda_utts:
        plda_feats = train_feats.filter(plda_utts)
        pool_kind = "sre_combined (SRE-speaker subset, run.sh:181-185)"
    else:
        # no SRE corpus in the pool (partial runs): fall back to the whole
        # training list — a protocol deviation, so say so loudly
        plda_feats = train_feats
        pool_kind = ("FULL training pool — no SRE corpora given; the "
                     "reference trains PLDA on the SRE subset only")
    print(f"   PLDA pool: {len(plda_feats)} utts / "
          f"{len(plda_feats.speakers)} speakers [{pool_kind}]")
    plda_xv = recipe.extract(trainer, plda_feats, split="sre_combined")
    enroll_utt_xv = extract_split(enroll_data, "sre16_enroll")
    test_xv = extract_split(test_data, "sre16_test")
    major_xv = (extract_split(major_data, "sre16_major")
                if major_data else None)
    # enrollment models are per-SPEAKER means + counts (run.sh:285,
    # extract_xvectors.sh:100-102 ivector-mean)
    spk_enroll, num_utts = speaker_means(enroll_utt_xv,
                                         enroll_data.utt2spk)
    lap("extract")

    print("== stage 8-10: back-end (dual scoring)")
    trials = [(m, s, l) for m, s, l in trials
              if m in spk_enroll and s in test_xv]
    if not trials:
        # audio-only use (no evaluation key) or nothing survived the
        # model/segment filter: extraction artifacts are on disk, so
        # report and stop instead of crashing inside the scorer
        print("   no scorable trials (missing evaluation key or no "
              "model/segment overlap); skipping scoring")
        write_walls()
        return {}
    if major_xv:
        res = recipe.score_sre16(
            plda_xv, plda_feats, major_xv, spk_enroll, test_xv, trials,
            num_utts=num_utts, utt2cond=utt2lang or None,
            lda_dim=args.lda_dim)
    else:
        # no in-domain majors: fall back to single out-of-domain scoring
        pooled = recipe.score(plda_xv, plda_feats, spk_enroll, test_xv,
                              trials, num_utts=num_utts)
        res = {"out_of_domain": pooled}

    out_path = os.path.join(args.work_dir, "sre16_results.json")
    printable = {}
    for variant, r in res.items():
        entry = {"eer": r["eer"], "min_dcf": r["min_dcf"],
                 "num_trials": r["num_trials"]}
        if "per_condition" in r:
            entry["per_condition"] = {
                c: {k: v for k, v in m.items()}
                for c, m in r["per_condition"].items()}
        printable[variant] = entry
        langs = "".join(
            f", {c} {m['eer']*100:.2f}%"
            for c, m in r.get("per_condition", {}).items())
        # run.sh:294/:312 echo format
        print(f"   {variant}: EER {r['eer']*100:.2f}%"
              f" minDCF {r['min_dcf']:.3f}{langs}")
        # per-trial scores in Kaldi score-file format for the NIST
        # converter (utils/scores.kaldi_scores_to_nist_tsv)
        spath = os.path.join(args.work_dir, f"scores_{variant}.txt")
        score_lines = [f"{m} {s} {llr}"
                       for (m, s, _), llr in zip(trials, r["scores"])]
        with open(spath, "w") as f:
            f.write("\n".join(score_lines) + "\n")
        # NIST submission tsv (the reference's convert_kaldi_score_file.py)
        from ..utils.scores import kaldi_scores_to_nist_tsv
        with open(os.path.join(args.work_dir,
                               f"scores_{variant}.tsv"), "w") as f:
            f.write("\n".join(kaldi_scores_to_nist_tsv(score_lines)) + "\n")
    lap("backend")
    write_walls()
    with open(out_path, "w") as f:
        json.dump(printable, f, indent=1)
    print(f"   results -> {out_path}")
    return res


if __name__ == "__main__":
    main()
