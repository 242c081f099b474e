#!/usr/bin/env python3
"""Drive the PyTorch port's extraction, training, wave, scoring, recipe,
SRE16 recipe and multi-rank paths on one GPU, the entry points on every
GPU of the machine, and the measurement tooling.

Run from the repository root (one card, no arguments needed):

    python3 chip_smoke.py [--seed N]

Phases; any failure raises and the exit code is non-zero:

1. device check: CUDA must be available; prints the card's name and power
   limit as ``nvidia-smi`` reports them;
2. build: compiles every CUDA source of the port (``ops/_build.py``) and,
   beside them, the host data plane libxta (``runtime/native.py``,
   ``g++``), and prints the seconds and the compiler's register/spill
   report;
3. K1 against its plain version on the card: the full-width ``no_dropout``
   stack at 32x1024, at a ragged 32x777 with padded tails, with 40-dim
   features (K = 200 -> 256) and with masked tails that end on both sides
   of the layer-0 kernel's 128-frame tiles, ``etdnn`` at 32x1024, and
   small batches of the ``prelu``, ``l2_lrelu``, ``tdnn_dilated`` and
   ``etdnn`` stacks, each layer on the design ``layer_route`` picks
   ("l0_sm90", the layer-0 kernel of ``csrc/fwd_sm90.cu``, for layer 0; K1
   v5 "sm90", ``csrc/fwd_sm90.cu``, for every later layer, etdnn's 1500
   channels padded to 1504; no layer on K1 v4), and K1 v4 on every layer
   (``design="sm80"``, ``csrc/tdnn_stack.cu``) at 32x1024; then layer 0
   alone at 32x1024 (F = 23 and 40) and etdnn's 512 -> 1500 layer alone
   against their plain versions; max error normalised by max|plain| must
   stay within 1e-2 and masked frames must be exact zeros; then sliding
   CMVN's kernel (``csrc/cmvn_sm90.cu``) against its plain version (the
   f64 prefix-sum chain, on the same card tensor) at 8,526x23 and
   30,000x23, window 300, centred, within 1e-5 * max(1, max|feats|),
   without a map and with a VAD's destination map (CMVN and voiced-frame
   selection in one launch, against the plain version's boolean
   selection), each timed: the kernel by the profiler, the wrapper's host
   cost a call, beside the byte bound (2*T*D*4 bytes; with the map
   (T*D + T + rows*D)*4); the plain chain by CUDA events; ``preprocess``
   from a host array a call against the pair it replaced (pageable
   upload, kernel, download, host selection), whose rows it must equal;
4. the serving path at full width (``no_dropout``, 7,185 classes, random
   weights from ``--seed``): Kaldi feature and VAD arks written and read
   back, ``preprocess`` (sliding CMVN + VAD: one CMVN kernel launch a
   call, counted from zero over the calls, its rows left on the card and
   each call's frames held to ``preprocess`` on the CPU within the CMVN
   bound), ``XvectorExtractor`` in bf16, which must upload none of them
   again (``counters["host_inputs"]`` 0),
   with the fused kernel (the main path, with the launch counts zeroed just
   before it and read just after: layer 0 on "l0_sm90", layers 1-4 on
   "sm90", none on "sm80") and without it, x-vectors compared
   (cosine ≥ 0.999), an f32 run on the card checked against the same
   extractor on the CPU on a small input, and the vectors written with
   ``ArkWriter`` and read back;
5. timing lines tagged with the card: extraction throughput of both runs,
   the serving metric on one full 32x1024 batch (fused and unfused), a
   profiler breakdown of the fused batch (per kernel, per K1 layer, device
   idle share), and K1 at 32x1024 for ``no_dropout`` and ``etdnn`` in both
   designs (by the rule, v4 on every layer), on a fold made once: per layer
   the kernel's profiled time beside the layer's own bound and
   ``F.conv1d`` of the layer (a yardstick: conv only, no epilogue), the
   kernels' sum, the plain version of the stack, of layer 0 and of the
   last layer, and the fold's own time; then layer 0 alone with 23- and
   40-dim features, its kernel and v4 (profiler), beside its bound;
6. K2, K3 and K4 (the SAME conv forward, weight gradient and input
   gradient) against their plain versions on the card, on the design
   ``route`` picks ("sm90": K2 v2 ``csrc/fwd_sm90.cu``, K3 v2 and K4 v2
   ``csrc/conv_sm90.cu``): at the training shapes (64x304, 512 -> 512,
   k=5 and k=7; there also K2 v1, K3 v1 and K4 v1, the "sm80" design),
   one tile (1x64, 64 -> 64, k=3), ragged shapes
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
   dense blocks and one single step per pass, a falling loss, every K2, K3
   and K4 call on the "sm90" route); then one
   bf16 step fused against unfused (torch matmuls) from the same weights,
   and one f32 block of ``tiny`` on the card against the CPU;
8. timing lines tagged with the card: the block step fused and unfused
   (ms per minibatch, audio-s/s), a profiler breakdown of one fused block,
   and K2, K3 and K4 at k=5 and k=7 against their plain versions, their
   bounds and the one PyTorch call that computes the same function; each
   in both designs (v2 "sm90" and v1 "sm80"), with CUDA launches per call
   and a host-inclusive time per call (100 back-to-back calls);
9. the user's lifecycle through the CLIs at full ``no_dropout`` width, in
   a temporary directory: three archives of 16 full 64x304 minibatches and
   one ragged, valid and train_subset archives of 2; ``cli.train_dnn``
   for 2 epochs with final combination (the main path: K2, K3 and K4
   counted over the run, 6 calls per minibatch step, all "sm90"; falling
   loss; ``model_final`` -> ``model_combined``; ``model_0`` and the
   candidates kept by GC; weights summing to 1 and a combined loss no worse
   than the final model's), a rerun that must train nothing, checkpoint
   save and restore times, a run stopped by its ``stop_check`` and resumed
   that must match an uninterrupted one bit for bit, ``cli.eval_dnn``, and
   ``cli.extract_embedding`` on the serving ark with ``--spk2utt`` (the
   main extraction path: the layer-0 kernel and v5 on layers 1-4), whose
   ark must equal an in-process fused extractor's rows; then, where
   ``h5py`` is installed, ``export_reference_h5`` of ``model_final`` and
   ``cli.extract_embedding --reference-h5``, whose rows must equal the
   ``--model-dir`` run's (one line says the export is skipped without
   ``h5py``);
10. the ``attention`` and ``am_softmax_tricks`` presets at full width, two
   minibatch steps each: attention through K2-K4 and its unfused
   extraction on the card against the CPU's in bf16 (5e-2 normalised) and
   in f32 (1e-3), with bf16 against f32 printed for both devices; the
   AM-softmax head with a finite, falling loss;
11. the wave front end at full ``no_dropout`` width: a wav.scp of 64
   synthetic 8 kHz utterances from ``--seed`` (speech-like bursts with
   silent gaps, 1-60 s and one of 120 s that takes the long path; RIFF,
   stereo ``#ch1``, SPHERE PCM in both byte orders, µ-law, A-law, embedded
   shorten, a 16 kHz file resampled, a ``cat … |`` pipe; an all-silence
   and a 0.2 s utterance that must be skipped) through ``read_wav_scp`` →
   ``WaveExtractor`` (bf16, K1: the layer-0 kernel, v5 on layers 1-4) →
   ``ArkWriter`` (the main path, launch counts zeroed just before and read
   just after), then: the golden fixtures through ``mfcc`` on the card
   (rtol 2e-4, atol 1e-3); the batched front end on the card against the
   CPU on 16 rows (features and CMVN rtol 1e-4, atol 2e-3; VAD decisions
   equal but within 1e-3 of a row's threshold, at most 0.1% of frames);
   fused against unfused (cosine ≥ 0.999); f32 on the card against the
   CPU (1e-3); the long utterance against its host chain (1e-4), with
   neither extractor uploading ``preprocess``'s rows again
   (``host_inputs`` 0);
   ``cli.extract_embedding --wav-rspecifier`` rows equal to the main
   path's; augmentation card against CPU (1e-4, SNR within 0.05 dB); card
   features through the compressed writer within CM's step; timing lines:
   throughput over the workload, one 16 x 8 s batch by CUDA events and by
   the profiler (stages, K1 per layer, idle share), host decode time by
   format;
12. the scoring back end at NIST SRE16 evaluation size, on synthetic
   512-d x-vectors from ``--seed`` drawn from a planted two-covariance
   model (64 speaker dimensions): a PLDA training set of 4,000 speakers x
   16, 2,272 unlabelled in-domain majors, 802 enrolment models (1 or 3
   segments, ``num_utts``), 9,294 test segments and ~1.99M trials (~1.9%
   target) in two conditions (``tgl``/``yue``); in domain the speaker part
   is scaled by 1.6 and shifted by 1.5.  The main path (launch counts
   zeroed just before and read just after; no kernel runs there) is
   ``Recipe(RecipeConfig(..., device="cuda")).score_sre16`` (LDA to 100,
   the device EM at >= 2,000 speakers, adaptation, both host scorings,
   pooled and per-condition metrics), then ``score_trials_device`` over
   the 802 x 9,294 grid for both models.  Checks: device scores against
   the recipe's host f64 scores on the full trial list (1e-3 x span) and
   EER within 5e-4; ``project_device`` against ``Plda.project`` (2e-4,
   with and without ``simple_length_norm``); the device EM against the
   host f64 EM on the same training set (sorted psi rtol 5e-3, atol 5e-4;
   LLRs 2e-2 x span); with TF32 allowed by the caller, the EM and the
   score matrix equal the TF32-off run bit for bit and the caller's
   setting survives; both variants' EER under 2 x the planted model's
   (oracle) EER + 0.01, adapted scores differing from out-of-domain ones,
   both conditions reported; phase 11's wave ark read back with
   ``read_vec_flt_matrix`` (rows equal to those written) and scored on
   the card against the host (1e-3 x span).  Timing lines: the device EM
   (first and warm call, CUDA events and host-inclusive, device busy)
   beside the host f64 EM, ``score_matrix`` against its bound and its
   profile, trials/s of ``score_trials_device`` and of the host scorer,
   ``eer`` + ``min_dcf``, and ``score_sre16``'s wall time by stage;
13. the recipe (``cli/run.py``) at full ``no_dropout`` width on a
   synthetic corpus from ``--seed``: 48 speakers x 8 utterances of 4-12 s
   of 8 kHz speech-like audio (phase 11's generator through three
   resonances of the speaker's own), with reverb and noise copies made by
   ``Recipe.augment`` on the card from 4 synthetic RIRs and 4 noises.
   ``Recipe(RecipeConfig(..., device="cuda"))`` runs stage by stage, each
   stage a main path with the counts zeroed just before it and read just
   after: ``make_features`` (MFCC and VAD on the card, dither on; its data
   dir saved and read back, as run.sh hands stages over), ``make_egs`` (200-400
   frames, minibatch 64, bucket 32, snapping, 4 archives of ~40
   minibatches, valid and train-subset archives; every archive must come
   from libxta's ``materialize_archive_native``, and
   ``iter_plan_minibatches`` must yield archive 0's minibatches byte for
   byte), ``train`` (bf16, blocks of 16, 2 epochs: 6 K2/K3/K4 calls per
   minibatch step, all "sm90", and a falling loss), ``extract`` (bf16,
   K1: the layer-0 kernel, v5 on layers 1-4) and ``extract_from_wav`` (the
   ``WaveExtractor``, K1 likewise), and ``score`` (enrolment on half of
   each speaker's clean utterances, test on the rest; EER at most 0.25
   for both x-vector sets).  Then ``cli.run --synthetic-speakers ...
   --model no_dropout --extract-from-wav`` and its ``--stage 3`` rerun
   (features and egs reused, the model retrained), and ``cli.get_egs`` on
   stage 1's data dir, whose archives must equal ``make_egs``'s byte for
   byte.  Timing lines: seconds per stage, the feature stage's
   audio-s/s, native against Python materialisation of archive 0
   (minibatches/s, MB/s), the training stage's ms per minibatch, the
   extraction stages' x-vectors/s.

14. the SRE16 recipe (``cli/run_sre16.py``) at full ``no_dropout`` width
   (23 MFCC, minibatch 64, chunks of 200-400 frames, bf16, 512-d
   x-vectors, LDA to 100, the stage-3 filters at 500 frames and 8
   utterances) on a synthetic LDC tree from ``--seed``: SWBD cellular 1
   as two-channel embedded-shorten SPHERE calls (48 speakers, each in 2
   calls) with ``doc/swb_callstats.tbl``; a pre-built SRE data dir of 104
   speakers (two-channel PCM SPHERE, ``#chN`` entries), the PLDA pool;
   the SRE16 eval tree (40 models, half tgl and half yue, µ-law enrolment
   and PCM test segments) with its evaluation key in the reference's
   ``download/sre16_evaluation_key`` layout; unlabeled majors at 16 kHz;
   MUSAN (noise, music, speech) and RIRS trees on disk.  Run 1 is
   ``run_sre16.main`` in-process with --extract-from-wav, MUSAN and RIRS
   augmentation and final combination (the main path: K2-K4 6 "sm90"
   calls per training step, K1's layer-0 kernel and v5 on layers 1-4 in
   both extraction routes; counts zeroed just before, read just after);
   run 2 is ``python -m xvector_tpu_torch.cli.run_sre16 ... --stage 7``
   without it, in a child process (through ``runpy``, which sends its
   launch counts back): the feature-ark route, which must rewrite no egs,
   feature or checkpoint file and train nothing.  Checks for both runs:
   ``sre16_results.json`` with both variants per language over the key's
   filtered trials, out-of-domain EER at most 0.25, the ``sre_combined``
   pool exactly the SRE speakers' utterances clean and augmented, one
   score per trial in ``scores_*.txt`` and a parsing ``scores_*.tsv``,
   and ``egs_info.json``'s archive count from ``get_egs.sh:120``.  Timing
   lines: ``stage_walls.json`` of both runs, x-vectors/s per extracted
   split, the training stage's ms per minibatch, each run's wall time.

15. the multi-rank paths at full width, several processes sharing the
   card through gloo (each makes the card current before its first
   kernel; NCCL refuses two ranks on one device).  Part 1:
   ``parallel/mc_harness`` with 2 ranks, the ``baseline`` preset
   (``no_dropout``, dense softmax over 7,185 classes, bf16, Adam, blocks
   of 16), 2 archives of 16 full 64x304 minibatches (32 rows per rank)
   and one ragged, a valid archive of 2, 2 epochs, final combination: a
   run stopped by the deterministic ``STOP_AFTER`` check and resumed by
   fresh processes must equal a straight run bit for bit (params, the
   combined model, x-vectors), both ranks the same bits, a falling loss,
   K2-K4 twice per minibatch step on every rank, all "sm90"; the
   utterance-sharded extraction (bf16, K1) equal to one process's fused
   extraction of the same shards from the same ``model_final``, and
   rank 0's shard within phase 4's cosine bound of the unfused stack;
   ``model_final`` restores in one process; and a one-process run of the
   same archives for the step time.  Part 2: one SGD step from carried weights, 2 ranks
   against 1 on the same global batch: f32 (plain convs) params and BN
   state within 1e-6, loss within 2e-5; bf16 (K2-K4) loss within 1e-2
   relative and per-parameter update cosine >= 0.98.  Part 3:
   ``sre16_full`` on 3 ranks (data 1 x model 3, 2,395 columns each): an
   f32 SGD step against one process's dense softmax (loss and params
   1e-5), two bf16 blocks of 16 with a falling loss, the trunk the same
   bits on every rank, K2-K4 counted, and its checkpoint restored in one
   process with the head the shards side by side.  Part 4:
   ``seq_sharded_xvector`` on 2 ranks, one 20,000-frame utterance (valid
   19,995) against one process's unchunked ``extract_xvector`` (1e-4
   normalised).  Part 5: part 2's f32 step under NCCL, one card per rank,
   where there are two cards (else one line says why it did not run).
   Timing lines: ms per minibatch step and audio-s/s, 2 ranks against 1;
   the flat gradient all-reduce and its share of the step; checkpoint
   saves with and without the head's gather; process start;
   ``seq_sharded_xvector``; K2-K4 at the 32x304 a rank gives them, each
   first held against its plain version at that shape.

16. the entry points on every card of the call (``parallel/launch``):
   on a call with W >= 2 cards the entry point, given no launch
   variables, starts one NCCL rank per card itself; on a call with one
   card, this script starts 2 gloo ranks that share it through the
   launch variables (``XVEC_*``, ``XVEC_BACKEND=gloo``), and says so.
   Each run goes through ``MR_CHILD`` (``mr_child``), which calls the
   entry point's ``main`` with its flags and records each process's
   kernel launches and start time.  Part A: ``cli.train_dnn`` at full
   ``no_dropout`` width (64x304x23 minibatches, 7,185 classes), 2
   archives of 1 minibatch, 2 iterations, SGD from carried weights
   (``model_0``), in f32 and in bf16, each on the ranks and on one
   process: f32 ``model_final`` within 1e-5 max |diff|; bf16 final loss
   within 1e-2 relative, the update's cosine over all parameters >= 0.98,
   and per leaf the ranks' first update against the exact (f32) one at
   0.98 or, where one process's bf16 update lies farther from it, at one
   process's cosine squared (two bf16 runs that round differently part
   by up to ~7% per leaf, as far as one process's bf16 update lies from
   the f32 one); K2-K4
   twice per step on every rank, all "sm90", and each rank holds them
   against their plain versions at every shape it trained at.  Part B:
   ``cli.run`` (16 speakers x 6 utterances, bf16) on one process and on
   the ranks (on one card: 3 gloo ranks, on W cards: W NCCL ranks and, where
   W > 3, 3 of them), whose 8-row minibatches 3 does not divide: rank 0
   alone extracts (K1: the layer-0 kernel and v5), every rank trains
   through K2-K4 and
   holds them against their plain versions at every shape it trained at
   (rows per rank x padded chunk length), the EER
   within one target trial of one process's, and rank 0's x-vectors
   within phase 4's cosine bound of the unfused bf16 stack on the same
   features.  Part C, on a call with W >= 2 cards: ``cli.train_dnn``
   bf16 with Adam over 3 archives of 16 minibatches on the W cards and
   on one: ms per global minibatch (iteration 1), and per rank, from a
   profile of iteration 2, the device's idle share, the NCCL kernels'
   time and the gradient all-reduce's share of the step, and process
   start; on one card one line says why it did not run.

17. the measurement tooling (``xvector_tpu_torch/bench/``), short runs:
   ``headline.run(quick=True)`` (the dense block steps of ``no_dropout``,
   ``etdnn``, ``l2_lrelu_attention`` and ``no_dropout`` with the
   AM-softmax head at full width, 64x304, 7,185 classes; the front end
   over 16 x 8 s; the fused and unfused 32x1024 extraction;
   ``WaveExtractor`` over 96 x 8 s and its device function alone),
   ``extract_sweep`` over its 11 shapes, ``dense`` and ``adam_mu``, and
   ``scale_sre16`` at full ``no_dropout`` width on a cut corpus (16+8+4
   speakers x 8 utterances, 20 of the tool's 35 repeats, 11 archives)
   through materialised archives and through ``--stream-egs``.  Checks: each
   bench's own (finite, falling losses; three K2/K3/K4 calls per wide
   layer and step, all "sm90": 6, and 9 for ``etdnn``; fused against
   unfused x-vectors at cosine >= 0.999 at every shape; 96 finite wave
   x-vectors; both scale runs' GC keep-sets and routes, their
   ``metrics.jsonl`` records equal as multisets and their EERs equal),
   K1 and K2-K4 launched, and K2, K3 and K4 against their plain versions
   at every (rows, frames, k, Cin, Cout, dilation) that K2 ran at in the
   phase (``KERNEL_BOUND``, ``DW_BOUND`` for K3), the E-TDNN's dilated
   layers and the scale runs' chunk shapes among them.  Timing lines:
   every headline metric with its spread and window value, the sweep's
   rows, dense against masked, f32 against bf16 Adam moments, the scale
   runs' stage walls.

The line before the last is ``{"kernels": [...]}`` (K1 and K2-K4 in the
main path's designs, rows for the "sm80" designs with their main-path
launch counts, and sliding CMVN's rows, without a map and with one, the
second with its launches over phase 4's ``preprocess`` calls; each with
its launches over the CLI phase as ``cli_launches``, over the recipe's
stages (training for K2-K4, both extraction stages for K1) as
``recipe_launches``, over run_sre16's
runs (training for K2-K4, both runs' extraction for K1) as
``sre16_launches`` and over phase 15's multi-rank run (its straight run's
training for K2-K4, its sharded extraction for K1, summed over the ranks)
as ``mc_launches``, over phase 16's multi-rank runs (training for K2-K4,
rank 0's extraction for K1, summed over the ranks) as
``multicard_launches``, over phase 17's bench runs (training and the
scale runs for K2-K4, the headline's and the sweep's extraction for K1)
as ``bench_launches``, and K1's over the wave phase as
``wave_launches``);
the last line is
``{"ok": true, "device": {...}}``.  Float32 matmuls run in full f32
(``torch.backends.cuda.matmul.allow_tf32 = False``) so the plain versions
are true f32 referees.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import io
import json
import math
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time
from dataclasses import replace

import numpy as np
import torch
import torch.nn.functional as F

KERNEL_BOUND = 1e-2        # max |kernel - plain| / max |plain|
# sliding CMVN, kernel vs plain: the same f32 steps, only the f64 window
# sums taken in another order, so at most a neighbouring f32 (of max|x|)
CMVN_BOUND = 1e-5          # max |kernel - plain| / max(1, max |feats|)
CMVN_SHAPES = ((8526, 23), (30000, 23))   # extraction's mean, 300 s
COSINE_BOUND = 0.999       # fused vs unfused x-vectors, both bf16
F32_BOUND = 1e-3           # card f32 vs CPU f32 x-vectors, normalised
ATT_BOUND = 5e-2           # attention model: card vs CPU x-vectors in bf16
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
# the CUDA kernels of K2-K4 (csrc/conv_bwd.cu, csrc/conv_sm90.cu,
# csrc/fwd_sm90.cu) and of K1's layers (csrc/fwd_sm90.cu: layer 0 and v5;
# csrc/tdnn_stack.cu: v4)
KERNEL_NAMES = ("shift_gemm_kernel", "dw_gemm_kernel", "dw_reduce_kernel",
                "dw_sm90_kernel", "dx_sm90_kernel", "fwd_sm90_kernel")
K1_KERNEL_NAMES = ("tdnn_layer_kernel", "fwd_sm90_kernel",
                   "tdnn_l0_sm90_kernel")
REPO = os.path.dirname(os.path.abspath(__file__))


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


def model(tt, name, seed, num_classes, dev, **overrides):
    cfg = replace(tt.MODEL_ZOO[name], **overrides)
    gen = torch.Generator().manual_seed(seed)
    params, state = tt.init_params(gen, cfg, num_classes, device=dev)
    perturb_bn(params, state, gen)
    return cfg, params, state


def tail_mask(bsz, t, gen):
    """(B, T) mask whose rows end at random lengths in [T/2, T]."""
    lens = torch.randint(t // 2, t + 1, (bsz,), generator=gen)
    lens[0] = t
    return (torch.arange(t)[None, :] < lens[:, None]).to(torch.float32)


def k1_by_rule(k1, layers=5) -> bool:
    """K1 launches by design as the rule gives them: the layer-0 kernel
    once per stack call, v5 on every later layer, K1 v4 never."""
    return (k1.get("l0_sm90", 0) > 0 and k1.get("sm80", 0) == 0
            and k1.get("sm90", 0) == (layers - 1) * k1["l0_sm90"])


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

def tile_edge_mask(bsz, t):
    """(B, T) mask whose rows end at lengths on both sides of the layer-0
    kernel's 128-frame tiles (127, 128, 129, 255, 257, ...)."""
    lens = torch.tensor([t, 127, 128, 129, 255, 257, 640, t - 1][:bsz])
    return (torch.arange(t)[None, :] < lens[:, None]).to(torch.float32)


def phase_kernel_checks(tt, TK, dev, seed):
    """K1 against its plain version, each layer on the design the rule
    picks (design None: the layer-0 kernel, then v5; never v4) or on v4
    ("sm80"); then layer 0 alone at 32x1024 (F = 23, and 40: K = 200 ->
    256) and etdnn's 512 -> 1500 layer alone (v5, padded to 1504) against
    their plain versions.  Returns the max-abs errors by case."""
    cases = [("no_dropout", 32, 1024, None, {}, "tails"),
             ("no_dropout", 32, 1024, "sm80", {}, "tails"),
             ("no_dropout", 32, 777, None, {}, "tails"),
             ("no_dropout", 32, 1024, None, {"feat_dim": 40}, "tails"),
             ("no_dropout", 8, 1000, None, {}, "tile edges"),
             ("etdnn", 32, 1024, None, {}, "tails"),
             ("prelu", 3, 333, None, {}, "tails"),
             ("l2_lrelu", 3, 333, None, {}, "tails"),
             ("tdnn_dilated", 3, 333, None, {}, "tails"),
             ("etdnn", 3, 333, None, {}, "tails")]
    results = {}
    for i, (name, bsz, t, design, kw, masks) in enumerate(cases):
        cfg, params, state = model(tt, name, seed + i, 10, dev, **kw)
        gen = torch.Generator().manual_seed(seed + 100 + i)
        x = torch.randn(bsz, t, cfg.feat_dim, generator=gen).to(dev)
        mask = (tail_mask(bsz, t, gen) if masks == "tails"
                else tile_edge_mask(bsz, t)).to(dev)
        before = dict(TK.route_launches)
        got = TK.fused_frame_stack(cfg, params, state, x, mask,
                                   design=design)
        torch.cuda.synchronize()
        designs = TK._layer_designs(cfg, design)
        took = {n: TK.route_launches[n] - before[n] for n in before}
        if took != {n: designs.count(n) for n in before} or (
                design is None and took["sm80"]):
            fail(f"K1 {name}: layers ran on {took}, expected {designs}")
        want = TK.fused_frame_stack_reference(cfg, params, state, x, mask)
        label = (f"K1 {name}" + "".join(f" {k}={v}" for k, v in kw.items())
                 + f" {bsz}x{t} ({masks}) "
                 + ("/".join(designs) if design is None
                    else f"all {design}"))
        if got.shape != want.shape or got.dtype != torch.float32:
            fail(f"{label}: shape/dtype {tuple(got.shape)} "
                 f"{got.dtype} vs {tuple(want.shape)}")
        if not torch.isfinite(got).all():
            fail(f"{label}: non-finite output")
        abs_err = float((got - want).abs().max())
        norm_err = abs_err / float(want.abs().max())
        print(f"K1 check {label.removeprefix('K1 ')}: max_abs_err="
              f"{abs_err:.6g} normalised={norm_err:.3g} (bound "
              f"{KERNEL_BOUND})")
        if norm_err > KERNEL_BOUND or bool(got[mask == 0].any()):
            fail(f"{label} disagrees with its plain version")
        results[(name, bsz, t, design) if not kw else (name, kw["feat_dim"])
                ] = abs_err
    # single layers at 32x1024: layer 0's kernel and etdnn's last layer
    for i, (name, kw, l) in enumerate((("no_dropout", {}, 0),
                                       ("no_dropout", {"feat_dim": 40}, 0),
                                       ("etdnn", {}, 9))):
        cfg, params, state = model(tt, name, seed + 50 + i, 10, dev, **kw)
        folded = TK.fold_stack(cfg, params, state)
        gen = torch.Generator().manual_seed(seed + 150 + i)
        mask = tail_mask(32, 1024, gen).to(dev)
        cin = folded.layers[l][0].shape[1]
        h = torch.randn(32, 1024, cin, generator=gen).to(
            dev, torch.float32 if l == 0 else torch.bfloat16)
        design = TK._layer_designs(cfg)[l]
        before = TK.route_launches[design]
        got = TK.fused_layer(cfg, folded, l, h, mask)
        torch.cuda.synchronize()
        if TK.route_launches[design] != before + 1:
            fail(f"K1 {name} layer {l} alone did not launch {design}")
        want = TK.layer_reference(cfg, folded, l, h, mask)
        want = want[..., :got.shape[-1]]
        abs_err = float((got.float() - want).abs().max())
        nerr = abs_err / float(want.abs().max())
        dtype = str(got.dtype).removeprefix("torch.")
        label = (f"{name}" + "".join(f" {k}={v}" for k, v in kw.items())
                 + f" layer {l} alone 32x1024 {design} "
                 f"({tuple(got.shape)} {dtype})")
        print(f"K1 check {label}: max_abs_err={abs_err:.6g} normalised="
              f"{nerr:.3g} (bound {KERNEL_BOUND})")
        if (nerr > KERNEL_BOUND or bool(got[mask == 0].any())
                or not torch.isfinite(got).all()):
            fail(f"K1 {label} disagrees with its plain version")
        results[(name, cfg.feat_dim, "layer", l)] = abs_err
    return results


def cmvn_bound(x) -> float:
    return CMVN_BOUND * max(1.0, float(np.abs(np.asarray(x)).max()))


def cmvn_profiled_ms(fn, calls, label):
    """Median profiled device time (ms) of the sliding CMVN kernel over
    ``calls`` launches of ``fn`` after one left out."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls + 1):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in sorted(
        (e for e in prof.events()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and "sliding_cmvn_kernel" in e.name),
        key=lambda e: e.time_range.start)][-calls:]
    if len(us) < calls:
        fail(f"{label}: the profiler saw {len(us)} of {calls + 1} kernel "
             "launches")
    return statistics.median(us) / 1e3


def phase_cmvn(FE, TE, dev, seed, tag, calls=20):
    """Sliding CMVN's kernel against its plain version on the same card
    tensor, window 300, centred, at each of ``CMVN_SHAPES``, without a map
    and with a VAD's destination map (CMVN and voiced-frame selection in
    one launch, held to the plain version's boolean selection), then
    timed: each launch's profiled device time (median over ``calls``
    launches after one left out), the wrapper's host cost a call, the
    plain chain (CUDA events), the byte bound, and ``preprocess`` from a
    host array a call against the pair it replaced (a pageable upload,
    the kernel, a pageable download, selection on the host).  Returns the
    rows by (T, D) and by ("select", T, D)."""
    rows = {}
    for t, d in CMVN_SHAPES:
        g = torch.Generator().manual_seed(seed + 17 * t + d)
        x = (torch.randn(t, d, generator=g)
             + 3.0 * torch.randn(d, generator=g)).to(dev)
        vad = (torch.rand(t, generator=g) > 0.26).numpy().astype(np.float32)
        dest, n = FE.voiced_map(vad)
        dest_d = torch.from_numpy(dest).to(dev)
        plain = FE.sliding_cmvn_reference(x, 300)
        lim = cmvn_bound(x.cpu())
        runs = {"cmvn": lambda: FE.sliding_cmvn(x, 300),
                "select": lambda: FE.sliding_cmvn(x, 300, dest=dest_d,
                                                  rows=n)}
        wants = {"cmvn": plain,
                 "select": plain[torch.from_numpy(vad > 0.5).to(dev)]}
        for name, fn in runs.items():
            label = f"CMVN {t}x{d}" + (" with the map" if name == "select"
                                       else "")
            before = FE.cmvn_launches
            got = fn()
            if FE.cmvn_launches != before + 1:
                fail(f"{label}: the card call did not launch the kernel")
            if got.shape != wants[name].shape:
                fail(f"{label}: {tuple(got.shape)} rows out, expected "
                     f"{tuple(wants[name].shape)}")
            err = float((got - wants[name]).abs().max())
            print(f"{label} kernel vs plain window 300: max abs error "
                  f"{err:.3g} (bound {lim:.3g}; {n} of {t} frames voiced)")
            if not err <= lim:
                fail(f"{label}: the kernel disagrees with its plain version")
            ms = cmvn_profiled_ms(fn, calls, label)
            call_ms = host_ms(fn, calls=200)
            nbytes = (2 * t * d * 4 if name == "cmvn"
                      else (t * d + t + n * d) * 4)
            bound_ms, by = bound(0, nbytes)
            rows[(t, d) if name == "cmvn" else ("select", t, d)] = {
                "ms": ms, "call_host_ms": call_ms, "bound_ms": bound_ms,
                "bound_by": by, "max_abs_err": err}
            print(f"timing {label} window 300: {ms * 1e3:.2f} us "
                  f"(profiled), {call_ms * 1e3:.2f} us a call on the host; "
                  f"bound {bound_ms * 1e3:.3f} us by {by} "
                  f"({bound_ms / ms:.1%}) [{tag}]")
        plain_ms = cuda_ms(lambda: FE.sliding_cmvn_reference(x, 300))
        rows[(t, d)]["plain_ms"] = plain_ms
        print(f"timing CMVN {t}x{d} plain chain: {plain_ms * 1e3:.1f} us "
              f"[{tag}]")
        feats = x.cpu().numpy()
        feats.setflags(write=False)            # as an ark's view

        def pair():
            y = FE.sliding_cmvn(torch.from_numpy(np.array(feats)).to(dev),
                                300)
            return FE.select_voiced_frames(y.cpu().numpy(), vad)

        pre_ms = host_ms(lambda: TE.preprocess(feats, vad=vad, device=dev),
                         calls=200)
        pair_ms = host_ms(pair, calls=200)
        same = torch.equal(TE.preprocess(feats, vad=vad, device=dev).cpu(),
                           torch.from_numpy(pair()))
        rows[("select", t, d)].update(preprocess_host_ms=pre_ms,
                                      pair_host_ms=pair_ms)
        print(f"timing preprocess {t}x{d} from a host array: "
              f"{pre_ms * 1e3:.1f} us a call (pinned upload, one launch, "
              f"rows left on the card) against {pair_ms * 1e3:.1f} us for "
              f"the pair it "
              f"replaced (pageable upload, kernel, download, host "
              f"selection); the same rows {same} [{tag}]")
        if not same:
            fail(f"CMVN {t}x{d}: preprocess and the pair it replaced part")
    return rows


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
    """(x-vectors, host seconds, the extractor's ``host_inputs``)."""
    ex = TE.XvectorExtractor(cfg, params, state, TE.ExtractorConfig(
        compute_dtype="bfloat16", use_fused=fused), device=dev)
    t0 = time.perf_counter()
    out = ex.extract(utts)          # results come back as numpy: synced
    return out, time.perf_counter() - t0, ex.counters["host_inputs"]


def phase_serving(tt, TE, TK, FE, kio, dev, seed, tag):
    cfg, params, state = model(tt, "no_dropout", seed, 7185, dev)
    with tempfile.TemporaryDirectory() as tmp:
        feats_ark, vad_ark = write_arks(kio, tmp, seed)
        vads = dict(kio.read_vec_flt_ark(vad_ark))
        # preprocess, the main path's CMVN: its count zeroed just before,
        # read just after
        FE.cmvn_launches = 0
        t0 = time.perf_counter()
        utts = [(k, TE.preprocess(m, vad=vads[k], device=dev))
                for k, m in kio.read_mat_ark(feats_ark)]
        pre_s = time.perf_counter() - t0
        cmvn_launches = FE.cmvn_launches
        print(f"serving: CMVN kernel launches over {len(utts)} preprocess "
              f"calls on the card: {cmvn_launches}")
        if cmvn_launches != len(utts):
            fail("serving: preprocess on the card left the CMVN kernel")
        mats = dict(kio.read_mat_ark(feats_ark))
        pre_err = 0.0
        for k, f in utts:
            if f.device.type != "cuda":
                fail(f"serving: preprocess left {k}'s rows on {f.device}")
            want = TE.preprocess(mats[k], vad=vads[k], device="cpu")
            if f.shape != want.shape:
                fail(f"serving: preprocess kept {f.shape[0]} frames of {k} "
                     f"on the card, {want.shape[0]} on the CPU")
            pre_err = max(pre_err, float((f.cpu() - want).abs().max())
                          / cmvn_bound(mats[k]))
        print(f"serving: preprocess card vs CPU max abs error "
              f"{pre_err:.3g} of the CMVN bound")
        if not pre_err <= 1.0:
            fail("serving: preprocess on the card disagrees with the CPU")
        kept = {k for k, f in utts if f.shape[0] >= 25}
        frames = sum(f.shape[0] for k, f in utts if k in kept)
        print(f"serving: {len(utts)} utterances read, {len(kept)} kept, "
              f"{frames} voiced frames; preprocess {pre_s:.3f} s")

        for fused in (True, False):   # warm-up: every bucket shape once
            run_extractor(TE, cfg, params, state, utts, fused, dev)

        # the main path: counts zeroed just before, read just after
        TK.launches = 0
        for n in TK.route_launches:
            TK.route_launches[n] = 0
        xv_fused, s_fused, host_inputs = run_extractor(
            TE, cfg, params, state, utts, True, dev)
        main_launches = TK.launches
        main_routes = dict(TK.route_launches)
        print(f"serving: utterances the main path had to upload "
              f"(host_inputs) {host_inputs} of {len(kept)}")
        if host_inputs:
            fail("serving: extract_iter uploaded preprocess's rows again")
        xv_plain, s_plain, _ = run_extractor(TE, cfg, params, state, utts,
                                             False, dev)
        if main_launches == 0:
            fail("the fused run launched K1 no time")
        if TK.launches != main_launches:
            fail("the unfused run launched K1")
        # layer 0 (f32 features) on its Hopper kernel, layers 1-4 on v5,
        # none on v4
        designs = TK._layer_designs(cfg)
        calls = main_launches // cfg.num_frame_layers
        want_routes = {n: calls * designs.count(n) for n in main_routes}
        print(f"serving: K1 layer launches on the main path {main_launches} "
              f"({calls} stack calls), by design {main_routes} (expected "
              f"{want_routes}: layers {designs})")
        if main_routes != want_routes or main_routes["sm80"]:
            fail("serving: a K1 layer launch left its design")
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
    return main_launches, main_routes, cmvn_launches


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
            ex._run(xd, md)
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
    x, mask = torch.from_numpy(x).to(dev), torch.from_numpy(mask).to(dev)
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
                if any(k in e.name for k in K1_KERNEL_NAMES)]
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


def layer_work(cfg, bsz, t):
    """(FLOP, bytes) of each K1 layer: 2·B·T·k·Cin·Cout; the layer's input
    (f32 features and the mask for layer 0, bf16 after), its bf16 weights
    and f32 vectors, the mask, and its output (f32 for the last layer,
    bf16 before), each moved once."""
    out, cin, n = [], cfg.feat_dim, cfg.num_frame_layers
    for l, (k, c) in enumerate(zip(cfg.kernel_sizes, cfg.channels)):
        flops = 2 * bsz * t * k * cin * c
        nbytes = (bsz * t * cin * (4 if l == 0 else 2) + bsz * t * 4
                  + k * cin * c * 2 + 4 * c * 4
                  + bsz * t * c * (4 if l == n - 1 else 2))
        out.append((flops, nbytes))
        cin = c
    return out


def bound(flops, nbytes):
    """(ms, "operations" or "bytes"): the larger of FLOP at the bf16 peak
    and bytes at the memory rate."""
    ops_ms = flops / PEAK_BF16_FLOPS * 1e3
    mem_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(ops_ms, mem_ms), ("operations" if ops_ms >= mem_ms
                                 else "bytes")


def k1_profile(TK, cfg, params, state, x, mask, design, calls=5):
    """Device time of one stack call as the profiler sees it: each layer's
    kernel (us, median over ``calls``) and the rest (the wrapper's
    parameter folding when ``params`` is not a fold).  One more call goes
    first and is left out (the profiler may drop the first device event
    it records)."""
    from torch.profiler import ProfilerActivity, profile
    n = cfg.num_frame_layers
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls + 1):
            TK.fused_frame_stack(cfg, params, state, x, mask, design=design)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    is_layer = [any(k in e.name for k in K1_KERNEL_NAMES) for e in events]
    idx = [i for i, f in enumerate(is_layer) if f]
    if len(idx) <= n * calls:
        return None
    kept = range(idx[-n * calls - 1] + 1, len(events))   # the last calls
    layer = [events[i].time_range.elapsed_us() for i in kept if is_layer[i]]
    rest = sum(events[i].time_range.elapsed_us() for i in kept
               if not is_layer[i])
    return [statistics.median(layer[l::n]) for l in range(n)], rest / calls


def layer_profile_us(TK, cfg, folded, l, h, mask, design, calls=5):
    """Device time of layer ``l`` alone (``fused_layer``) by the profiler:
    the median over ``calls`` of its kernel, after one call left out."""
    from torch.profiler import ProfilerActivity, profile
    TK.fused_layer(cfg, folded, l, h, mask, design=design)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            TK.fused_layer(cfg, folded, l, h, mask, design=design)
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and any(k in e.name for k in K1_KERNEL_NAMES)]
    return statistics.median(us) if us else None


def phase_k1_layer0_timing(tt, TK, dev, seed, tag):
    """Layer 0 alone at 32x1024 with 23- and 40-dim features (K = 115 ->
    128, 200 -> 256): the layer-0 kernel and v4 by the profiler, beside
    the layer's bound and its plain version (CUDA events)."""
    out = {}
    for feat in (23, 40):
        cfg, params, state = model(tt, "no_dropout", seed, 10, dev,
                                   feat_dim=feat)
        folded = TK.fold_stack(cfg, params, state)
        gen = torch.Generator().manual_seed(seed + 9)
        x = torch.randn(32, 1024, feat, generator=gen).to(dev)
        mask = tail_mask(32, 1024, gen).to(dev)
        us = {d: layer_profile_us(TK, cfg, folded, 0, x, mask, d)
              for d in ("sm90", "sm80")}
        plain_ms = cuda_ms(lambda: TK.l0_reference(cfg, folded, x, mask))
        bound_ms, by = bound(*layer_work(cfg, 32, 1024)[0])
        print(f"timing K1 layer 0 alone 32x1024 F={feat} (profiled kernel "
              f"us): layer-0 kernel {us['sm90']:.1f}, v4 {us['sm80']:.1f}; "
              f"bound {bound_ms * 1e3:.1f} by {by} "
              f"({bound_ms * 1e3 / us['sm90']:.1%}); plain "
              f"{plain_ms:.4f} ms [{tag}]")
        out[feat] = {"ms": us["sm90"] / 1e3, "v4_ms": us["sm80"] / 1e3,
                     "plain_ms": plain_ms, "bound_ms": bound_ms}
    return out


def phase_k1_timing(tt, TK, dev, seed, tag, name="no_dropout"):
    """K1 at 32x1024 in both designs, the parameters folded once as the
    extractors fold them: the wrapper's time (CUDA events), each layer's
    kernel time (profiler) beside its bound and F.conv1d of the layer, the
    kernels' sum, the plain version; and the plain version of layer 0 and
    of the last layer alone (the kernel rows' plain_ms), the fold's time,
    and the v4 launches the comparison made."""
    bsz, t = 32, 1024
    cfg, params, state = model(tt, name, seed, 10, dev)
    gen = torch.Generator().manual_seed(seed + 7)
    x = torch.randn(bsz, t, cfg.feat_dim, generator=gen).to(dev)
    mask = tail_mask(bsz, t, gen).to(dev)
    iters, warmup = 20, 3
    fold_ms = cuda_ms(lambda: TK.fold_stack(cfg, params, state), iters,
                      warmup)
    folded = TK.fold_stack(cfg, params, state)
    plain_ms = cuda_ms(lambda: TK.fused_frame_stack_reference(
        cfg, folded, None, x, mask), iters, warmup)
    last = cfg.num_frame_layers - 1
    h_last = torch.randn(bsz, t, folded.layers[last][0].shape[1],
                         generator=gen).to(dev, torch.bfloat16)
    layer_plain_ms = {
        0: cuda_ms(lambda: TK.l0_reference(cfg, folded, x, mask), iters,
                   warmup),
        last: cuda_ms(lambda: TK.layer_reference(cfg, folded, last, h_last,
                                                 mask), iters, warmup)}
    # the extractor's unfused bf16 frame stack (torch matmuls), for context
    unfused_ms = cuda_ms(lambda: tt.frame_stack(
        cfg, params, state, x, mask, compute_dtype=torch.bfloat16),
        iters, warmup)
    flops, nbytes = stack_work(cfg, bsz, t)
    bound_ms, bound_by = bound(flops, nbytes)
    layers = layer_work(cfg, bsz, t)
    # F.conv1d of each layer on bf16 channels-first copies: a yardstick
    # for the layer's conv alone (no epilogue, no mask)
    conv_ms, cin = [], cfg.feat_dim
    for l, (k, d, c) in enumerate(zip(cfg.kernel_sizes, cfg.dilations,
                                      cfg.channels)):
        xc = torch.randn(bsz, cin, t, generator=gen).to(dev, torch.bfloat16)
        wc = params["frame"][l]["w"].to(torch.bfloat16).permute(2, 1, 0) \
            .contiguous()
        conv_ms.append(cuda_ms(lambda: F.conv1d(
            xc, wc, padding=(k - 1) // 2 * d, dilation=d), iters, warmup))
        cin = c
    out = {}
    forced = TK.route_launches["sm80"]
    for design in ("sm80", None, None, "sm80"):   # v4, rule, rule, v4
        key = "sm80" if design else "rule"
        before = TK.launches
        ms = cuda_ms(lambda: TK.fused_frame_stack(
            cfg, folded, None, x, mask, design=design), iters, warmup)
        per_call = (TK.launches - before) / (iters + warmup)
        prof = k1_profile(TK, cfg, folded, None, x, mask, design)
        out.setdefault(key, []).append((ms, per_call, prof))
    forced = TK.route_launches["sm80"] - forced
    designs = {"rule": TK._layer_designs(cfg),
               "sm80": TK._layer_designs(cfg, "sm80")}
    res = {"fold_ms": fold_ms, "layer_plain_ms": layer_plain_ms,
           "conv_ms": conv_ms, "layer_bounds": [bound(*w) for w in layers],
           "forced_v4_launches": forced}
    for key, runs in out.items():
        ms = statistics.mean(r[0] for r in runs)
        per_call = runs[0][1]
        profs = [r[2] for r in runs if r[2] is not None]
        label = ("by the rule (" + "/".join(designs[key]) + ")"
                 if key == "rule" else "v4 on every layer (all sm80)")
        if profs:
            layer_us = [statistics.mean(p[0][l] for p in profs)
                        for l in range(cfg.num_frame_layers)]
            rest_us = statistics.mean(p[1] for p in profs)
            kernel_ms = sum(layer_us) / 1e3
            print(f"timing K1 {name} {bsz}x{t} {label} per layer "
                  "(profiled kernel us; bound us; share; F.conv1d us): "
                  + "; ".join(
                      f"L{l} {d} k={cfg.kernel_sizes[l]} {cfg.channels[l]}ch "
                      f"{us:.1f}; {bound(*layers[l])[0] * 1e3:.1f} by "
                      f"{bound(*layers[l])[1]}; "
                      f"{bound(*layers[l])[0] * 1e3 / us:.1%}; "
                      f"{conv_ms[l] * 1e3:.1f}"
                      for l, (us, d) in enumerate(zip(layer_us,
                                                      designs[key])))
                  + f" [{tag}]")
        else:
            layer_us, rest_us, kernel_ms = None, None, None
            print(f"timing K1 {name} {label}: the profiler recorded no layer "
                  f"kernels; kernel-only time not measured [{tag}]")
        print(f"timing K1 {name} {bsz}x{t} {label}: kernels "
              + (f"{kernel_ms:.4f} ms/call = {flops / kernel_ms / 1e9:.1f} "
                 f"TFLOP/s = {bound_ms / kernel_ms:.1%} of bound; wrapper "
                 f"{ms:.4f} ms/call on a fold made once (CUDA events; other "
                 f"device work {rest_us:.1f} us per call), "
                 if kernel_ms else f"not measured; wrapper {ms:.4f} ms, ")
              + f"{per_call:g} launches/call, plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms by {bound_by} ({flops:.4g} FLOP, "
              f"{nbytes / 1e6:.1f} MB); unfused bf16 frame_stack "
              f"{unfused_ms:.4f} ms [{tag}]")
        res[key] = {"ms": kernel_ms if kernel_ms else ms,
                    "wrapper_ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "layers_us": layer_us, "rest_us": rest_us}
    v4, rule = res["sm80"], res["rule"]
    print(f"timing K1 {name} {bsz}x{t}: by the rule kernels "
          f"{rule['ms']:.4f} ms vs v4 {v4['ms']:.4f} ms = "
          f"{v4['ms'] / rule['ms']:.2f}x; wrappers {rule['wrapper_ms']:.4f} "
          f"vs {v4['wrapper_ms']:.4f} ms; plain layer 0 "
          f"{layer_plain_ms[0]:.4f} ms, layer {last} "
          f"{layer_plain_ms[last]:.4f} ms; fold_stack {fold_ms:.4f} ms "
          f"(once per extractor); K1 v4 launches in this comparison "
          f"{forced} [{tag}]")
    return res


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
    train_err = {"fwd": 0.0, "dw": 0.0, "dx": 0.0, "fwd_sm80": 0.0,
                 "dw_sm80": 0.0, "dx_sm80": 0.0}
    for i, (kind, k, d, b, t, cin, cout) in enumerate(cases):
        x, w, g = conv_inputs(b, t, cin, cout, k, dev, seed + 200 + i)
        design = CB.route(x.shape, w.shape, d)
        if design != ("sm80" if kind == "off-8" else "sm90"):
            fail(f"conv {kind} {cin}->{cout}: route() says {design}")
        before = dict(CB.route_launches)
        got = {"fwd": CB.conv_fwd(x, w, d), "dw": CB.conv_dw(x, g, k, d),
               "dx": CB.conv_dx(g, w, d)}
        if kind == "train":   # v1 at the same shapes
            got["fwd_sm80"] = CB.conv_fwd(x, w, d, design="sm80")
            got["dw_sm80"] = CB.conv_dw(x, g, k, d, design="sm80")
            got["dx_sm80"] = CB.conv_dx(g, w, d, design="sm80")
        torch.cuda.synchronize()
        took = {n: CB.route_launches[n] - before[n] for n in before}
        if any(took[f"{n}_{design}"] != 1 for n in ("fwd", "dw", "dx")):
            fail(f"conv {kind}: K2/K3/K4 did not run on the {design} route "
                 f"({took})")
        want = {"fwd": CB.conv_fwd_reference(x, w, d),
                "dw": CB.conv_dw_reference(x, g, k, d),
                "dx": CB.conv_dx_reference(g, w, d)}
        shapes = {"fwd": ((b, t, cout), torch.bfloat16),
                  "dw": ((k, cin, cout), torch.float32),
                  "dx": ((b, t, cin), torch.bfloat16)}
        for n in ("fwd", "dw", "dx"):
            want[f"{n}_sm80"], shapes[f"{n}_sm80"] = want[n], shapes[n]
        for name in got:
            kernel = {"fwd": f"K2 {design}", "dw": f"K3 {design}",
                      "dx": f"K4 {design}", "fwd_sm80": "K2 sm80",
                      "dw_sm80": "K3 sm80", "dx_sm80": "K4 sm80"}[name]
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


def write_train_archive(TA, path, seed, feat_dim, full=TRAIN_FULL,
                        ragged=True, means=None):
    """``full`` full minibatches and, with ``ragged``, one of true length
    TRAIN_RAGGED_LEN last.  Each speaker has its own mean feature vector
    (``means``, else drawn from ``seed``), so the labels can be learnt."""
    rng = np.random.default_rng(seed)
    if means is None:
        means = rng.standard_normal((TRAIN_CLASSES, feat_dim),
                                    dtype=np.float32)
    mbs = []
    for i in range(full + int(ragged)):
        labels = rng.integers(0, TRAIN_CLASSES, TRAIN_B, dtype=np.int32)
        feats = (means[labels][:, None, :] + rng.standard_normal(
            (TRAIN_B, TRAIN_T, feat_dim), dtype=np.float32))
        true_len = TRAIN_T if i < full else TRAIN_RAGGED_LEN
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
    # every K2, K3 and K4 call on the sm90 route
    want_routes = {f"{n}_{d}": want[n] if d == "sm90" else 0
                   for n in ("fwd", "dw", "dx") for d in ("sm90", "sm80")}
    print(f"train: K2/K3/K4 calls by design on the main path {routes} "
          f"(expected {want_routes})")
    if routes != want_routes:
        fail("train: a K2, K3 or K4 call of the main path left the sm90 "
             "route")

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
        if "shift_gemm_kernel<false>" in name or "fwd_sm90_kernel" in name:
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


# ---------------------------------------------------------------------------
# the train -> checkpoint -> extract slice through the CLIs
# ---------------------------------------------------------------------------

CLI_FULL, CLI_ARCHIVES, CLI_DIAG = 16, 3, 2
CLI_SPEAKERS = 8            # spk2utt groups of the extraction ark


def zero_counts(CB, TK):
    for counts in (CB.launches, CB.route_launches, TK.route_launches):
        for name in counts:
            counts[name] = 0
    TK.launches = 0


def run_cli(module, argv):
    """``module.main(argv)`` with its standard output captured; returns
    (the lines it printed, seconds)."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        module.main(argv)
    return buf.getvalue().splitlines(), time.perf_counter() - t0


def read_metrics(work):
    with open(os.path.join(work, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def tree_diff(leaves, a, b, names):
    """(largest |a - b| over the leaves, the leaf's name)."""
    worst = (0.0, None)
    for n, x, y in zip(names, leaves(a), leaves(b)):
        d = float((x.detach().float() - y.detach().float()).abs().max())
        worst = max(worst, (d, n), key=lambda w: w[0])
    return worst


def phase_cli(TR, TA, CB, TK, kio, dev, seed, tag, tmp):
    """The user's lifecycle at full ``no_dropout`` width: train_dnn (6
    iterations over 3 archives, diagnostics, final combination) → a rerun
    that must do nothing → a preempted and resumed run that must match an
    uninterrupted one bit for bit → eval_dnn → extract_embedding (K1) held
    to an in-process extractor.  Returns the launches of its own main
    paths: K2-K4 by design over the train_dnn run, K1 layers by design
    over the extract_embedding run, and (the model dir, the feature ark,
    the extract_embedding ark)."""
    from xvector_tpu_torch.cli import eval_dnn, extract_embedding, train_dnn
    from xvector_tpu_torch.extract import extractor as TE
    from xvector_tpu_torch.models.convert import tree_leaves
    from xvector_tpu_torch.train import checkpoints, combine
    from xvector_tpu_torch.train.preemption import GracefulPreemption

    egs = os.path.join(tmp, "cli_egs")
    work = os.path.join(tmp, "cli_exp")
    os.makedirs(egs)
    t0 = time.perf_counter()
    means = np.random.default_rng(seed + 40).standard_normal(
        (TRAIN_CLASSES, 23), dtype=np.float32)
    for n in range(1, CLI_ARCHIVES + 1):
        write_train_archive(TA, os.path.join(egs, f"egs.{n}.xta"),
                            seed + 40 + n, 23, full=CLI_FULL, means=means)
    for i, name in enumerate(("valid_egs.xta", "train_subset_egs.xta")):
        write_train_archive(TA, os.path.join(egs, name), seed + 50 + i, 23,
                            full=CLI_DIAG, ragged=False, means=means)
    print(f"cli: wrote {CLI_ARCHIVES} archives of {CLI_FULL} full "
          f"{TRAIN_B}x{TRAIN_T} minibatches and one of true length "
          f"{TRAIN_RAGGED_LEN}, and valid/train_subset archives of "
          f"{CLI_DIAG}, in {time.perf_counter() - t0:.2f} s")
    argv = ["--model=no_dropout", f"--num-targets={TRAIN_CLASSES}",
            "--num-epochs=2", "--do-final-combination=true",
            f"--egs-dir={egs}", f"--dir={work}", f"--random-seed={seed}",
            f"--device={dev}"]

    # 1. the main training path: counts zeroed just before, read just after
    zero_counts(CB, TK)
    out, train_s = run_cli(train_dnn, argv)
    launches, routes = dict(CB.launches), dict(CB.route_launches)
    print(f"cli: train_dnn {' '.join(argv)}: {train_s:.3f} s; "
          + " / ".join(out) + f" [{tag}]")
    recs = read_metrics(work)
    train = [r for r in recs if r.get("kind") == "train"]
    num_iters = 2 * CLI_ARCHIVES
    if [r["iteration"] for r in train] != list(range(num_iters)):
        fail(f"cli: train records for iterations "
             f"{[r['iteration'] for r in train]}")
    for r in train:
        diag = {d["kind"]: d for d in recs
                if d.get("iteration") == r["iteration"]
                and d.get("kind") in ("valid", "train_subset")}
        print(f"cli iteration {r['iteration'] + 1}: lr {r['lr']:.6g}, loss "
              f"{r['loss']:.6f}, accuracy {r['accuracy']:.4f}, "
              f"{r['minibatches']:g} minibatches ({r['dense_blocks']} dense "
              f"blocks, {r['single_steps']} single steps), "
              f"{r['seconds']:.3f} s; dispatch {r.get('dispatch', 0):.3f} s, "
              f"upload wait {r.get('upload_wait', 0):.3f} s, drain "
              f"{r.get('device_drain', 0):.3f} s; valid loss "
              f"{diag['valid']['loss']:.6f}, train_subset loss "
              f"{diag['train_subset']['loss']:.6f} [{tag}]")
        if not math.isfinite(r["loss"]):
            fail(f"cli: iteration {r['iteration']} has a non-finite loss")
    if not train[-1]["loss"] < train[0]["loss"]:
        fail("cli: the loss of iteration 6 is not below that of iteration 1")
    [comb] = [r for r in recs if r.get("kind") == "combine"] or [None]
    if comb is None:
        fail("cli: no combine record: "
             + str([r for r in recs if r.get("kind") == "combine_skipped"]))
    want_cands = combine.combine_iterations(num_iters, CLI_ARCHIVES)
    print(f"cli: combination over iterations {comb['iterations']} (expected "
          f"{want_cands}): weights {[round(w, 6) for w in comb['weights']]}, "
          f"final_model_loss {comb['final_model_loss']:.6f}, combined_loss "
          f"{comb['combined_loss']:.6f}, fell_back {comb['fell_back']}, "
          f"{comb['steps']} steps in {comb['seconds']:.3f} s (candidates "
          f"loaded, fitted, installed and saved) [{tag}]")
    if comb["iterations"] != want_cands:
        fail("cli: combination candidates are not combine_iterations'")
    if abs(sum(comb["weights"]) - 1.0) > 1e-5:
        fail("cli: the combination weights do not sum to 1")
    if not comb["combined_loss"] <= comb["final_model_loss"]:
        fail("cli: the combined model is worse than the final one")
    final = os.path.join(work, "model_final")
    if os.readlink(final) != "model_combined":
        fail(f"cli: model_final points at {os.readlink(final)}")
    kept = sorted(it for it, p in checkpoints.iteration_dirs(work)
                  if checkpoints.is_complete(p))
    ckpt_mb = os.path.getsize(os.path.join(final, "ckpt.pt")) / 1e6
    print(f"cli: complete checkpoints after GC {kept} + model_combined "
          f"({ckpt_mb:.1f} MB each)")
    if not {0, *want_cands} <= set(kept):
        fail("cli: model_0 or a combination candidate did not survive GC")
    steps = sum(int(r["minibatches"]) for r in train)
    wide = 2            # no_dropout's layers 1 and 2: k > 1, k·Cin > 160
    want = {n: wide * steps for n in ("fwd", "dw", "dx")}
    want_routes = {f"{n}_{d}": want[n] if d == "sm90" else 0
                   for n in ("fwd", "dw", "dx") for d in ("sm90", "sm80")}
    print(f"cli: K2/K3/K4 calls over the train_dnn run {launches}, by design "
          f"{routes} (expected {want_routes}: {wide} wide layers x {steps} "
          "minibatch steps; diagnostics and combination run eval forwards)")
    if launches != want or routes != want_routes:
        fail("cli: K2/K3/K4 launch counts of the train_dnn run are off")

    # 2. a rerun on the finished dir does nothing
    stamp = os.stat(os.path.join(final, "ckpt.pt")).st_mtime_ns
    zero_counts(CB, TK)
    _, rerun_s = run_cli(train_dnn, argv)
    again = read_metrics(work)
    print(f"cli: rerun on the finished dir: {rerun_s:.3f} s, "
          f"{len(again) - len(recs)} new metrics records, "
          f"{sum(CB.launches.values())} kernel calls")
    if (len(again) != len(recs) or sum(CB.launches.values())
            or os.readlink(final) != "model_combined"
            or os.stat(os.path.join(final, "ckpt.pt")).st_mtime_ns != stamp):
        fail("cli: the rerun trained or touched model_final")

    # 3. checkpoint save and restore at full width
    probe = TR.Trainer(TR.TrainConfig(model="no_dropout",
                                      num_targets=TRAIN_CLASSES),
                       os.path.join(tmp, "cli_probe"), device=dev)
    t0 = time.perf_counter()
    checkpoints.restore_into(probe, os.path.realpath(final))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    checkpoints.save_named(probe, "model_probe")
    save_s = time.perf_counter() - t0
    print(f"cli: checkpoint ({ckpt_mb:.1f} MB: params, BN state, Adam "
          f"state) restore {restore_s:.3f} s, save {save_s:.3f} s (write, "
          f"fsync, rename) [{tag}]")

    # 4. preemption: stopped by stop_check after the first of two
    # iterations, resumed, held to an uninterrupted run bit for bit
    def short_run(name, stop_after=None):
        pre = GracefulPreemption()
        cfg = TR.TrainConfig(model="no_dropout", num_targets=TRAIN_CLASSES,
                             num_epochs=1, random_seed=seed)

        def archive(i):
            loader = TA.PrefetchLoader(TA.ArchiveReader(
                os.path.join(egs, f"egs.{i + 1}.xta")))

            def gen():
                yield from loader
                if stop_after is not None and i + 1 == stop_after:
                    pre.trigger()
            return gen()

        tr = TR.Trainer(cfg, os.path.join(tmp, name), device=dev)
        done = tr.train(archive, 2, preemption=pre)
        return tr, done

    ref, _ = short_run("cli_ref")
    stopped, done = short_run("cli_pre", stop_after=1)
    if done != 1:
        fail(f"cli: the preempted run completed {done} iterations, not 1")
    resumed, done = short_run("cli_pre")
    torch.cuda.synchronize()
    names = leaf_names(ref.params)
    p_diff = tree_diff(tree_leaves, resumed.params, ref.params, names)
    s_diff = tree_diff(tree_leaves, resumed.state, ref.state,
                       leaf_names(ref.state))
    print(f"cli: preempted after iteration 1 and resumed vs uninterrupted "
          f"(2 iterations, Adam): largest parameter difference {p_diff[0]:g}"
          f" ({p_diff[1]}), largest BN-state difference {s_diff[0]:g} "
          f"({s_diff[1]})")
    if done != 2 or p_diff[0] or s_diff[0]:
        fail(f"cli: the resumed run is not bit-identical to the "
             f"uninterrupted one (largest difference in {p_diff[1]} / "
             f"{s_diff[1]})")

    # 5. eval_dnn on model_final
    out, eval_s = run_cli(eval_dnn, [
        f"--model-dir={work}", "--model=no_dropout",
        f"--num-targets={TRAIN_CLASSES}",
        f"--egs={os.path.join(egs, 'valid_egs.xta')}",
        "--compute-dtype=bfloat16", f"--device={dev}"])
    res = json.loads(out[-1])
    print(f"cli: eval_dnn on model_final: {out[-1]} ({eval_s:.3f} s)")
    if not (math.isfinite(res["loss"]) and 0.0 <= res["accuracy"] <= 1.0):
        fail("cli: eval_dnn gave a non-finite loss")

    # 6. extract_embedding on the 65-utterance ark with --spk2utt: the
    # main extraction path, counts zeroed just before, read just after
    feats_ark, _ = write_arks(kio, tmp, seed)
    utts = dict(kio.read_mat_ark(feats_ark))
    keys = sorted(utts)
    spk2utt = os.path.join(tmp, "spk2utt")
    with open(spk2utt, "w") as f:
        for s in range(CLI_SPEAKERS):
            f.write(f"spk{s} " + " ".join(keys[s::CLI_SPEAKERS]) + "\n")
    out_ark = os.path.join(tmp, "cli_xvector.ark")
    zero_counts(CB, TK)
    out, extract_s = run_cli(extract_embedding, [
        f"--model-dir={work}", "--model=no_dropout",
        f"--num-targets={TRAIN_CLASSES}", f"--feats-rspecifier=ark:{feats_ark}",
        f"--output-ark={out_ark}", f"--spk2utt={spk2utt}", f"--device={dev}"])
    k1_launches, k1_routes = TK.launches, dict(TK.route_launches)
    xv = dict(kio.read_vec_flt_scp(out_ark.replace(".ark", ".scp")))
    calls = k1_routes["l0_sm90"]
    print(f"cli: extract_embedding: {out[-1]}; {len(xv)} x-vectors in "
          f"{extract_s:.3f} s = {len(xv) / extract_s:.1f} x-vectors/s "
          f"host-inclusive (checkpoint restore, ark read, extraction, ark "
          f"and speaker-mean writes) [{tag}]")
    print(f"cli: K1 layer launches over the extract_embedding run "
          f"{k1_launches}, by design {k1_routes} (expected the layer-0 "
          f"kernel on layer 0 and v5 on layers 1-4: {calls} and "
          f"{4 * calls}; v4 none)")
    if not k1_by_rule(k1_routes) or k1_launches != 5 * calls:
        fail("cli: extract_embedding did not run K1's layer-0 kernel on "
             "layer 0 and v5 on layers 1-4")
    spk = dict(kio.read_vec_flt_scp(out_ark.replace(".ark", "_spk.scp")))
    if len(spk) != CLI_SPEAKERS:
        fail(f"cli: {len(spk)} speaker means, expected {CLI_SPEAKERS}")
    ex = TE.XvectorExtractor(probe.model_cfg, probe.params, probe.state,
                             TE.ExtractorConfig(compute_dtype="bfloat16",
                                                use_fused=True), device=dev)
    want = ex.extract(utts.items())
    same = set(want) == set(xv) and all(np.array_equal(xv[k], want[k])
                                        for k in want)
    print(f"cli: ark rows identical to an in-process fused extractor from "
          f"the restored model_final: {same} ({len(want)} rows)")
    if not same:
        fail("cli: the extract_embedding ark differs from in-process "
             "extraction")
    return routes, k1_routes, (work, feats_ark, out_ark)


def phase_presets(TR, CB, TK, TE, dev, seed, tag, tmp):
    """The attention and AM-softmax presets of ``presets.py`` at full
    width, two minibatch steps each: attention through K2-K4 and then
    unfused extraction on the card against the same weights on the CPU;
    AM-softmax (base + SGD 0.9 + shrink) must give a finite, falling
    loss."""
    from xvector_tpu_torch.presets import BENCHMARK_CONFIGS
    from xvector_tpu_torch.train import schedules
    rng = np.random.default_rng(seed + 60)
    means = rng.standard_normal((TRAIN_CLASSES, 23), dtype=np.float32)

    def minibatch():
        labels = rng.integers(0, TRAIN_CLASSES, TRAIN_B, dtype=np.int32)
        feats = means[labels][:, None, :] + rng.standard_normal(
            (TRAIN_B, TRAIN_T, 23), dtype=np.float32)
        return feats.astype(np.float16), labels, TRAIN_T

    # attention: one dense block of two minibatches
    cfg = replace(BENCHMARK_CONFIGS["attention"], num_targets=TRAIN_CLASSES,
                  block_size=2, random_seed=seed)
    tr = TR.Trainer(cfg, os.path.join(tmp, "preset_attention"), device=dev)
    zero_counts(CB, TK)
    t0 = time.perf_counter()
    st = tr.train_one_iteration(0, [minibatch(), minibatch()],
                                cfg.initial_effective_lrate, 0.0, 1.0)
    secs = time.perf_counter() - t0
    routes = dict(CB.route_launches)
    print(f"presets attention ({cfg.model}, {TRAIN_CLASSES} classes, bf16 "
          f"Adam): 2 steps, loss {st['loss']:.6f}, {secs:.3f} s; K2/K3/K4 "
          f"calls by design {routes} [{tag}]")
    if not math.isfinite(st["loss"]) or routes != {
            "fwd_sm90": 4, "dw_sm90": 4, "dx_sm90": 4, "fwd_sm80": 0,
            "dw_sm80": 0, "dx_sm80": 0}:
        fail("presets attention: non-finite loss or K2/K3/K4 calls off "
             "(expected 2 wide layers x 2 steps on sm90)")
    small = [(f"u{i}", rng.standard_normal((n, 23), dtype=np.float32))
             for i, n in enumerate((300, 517, 128))]
    xv = {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        for dtype in ("bfloat16", "float32"):
            ex = TE.XvectorExtractor(tr.model_cfg, tr.params, tr.state,
                                     TE.ExtractorConfig(compute_dtype=dtype),
                                     device=d)
            xv[(where, dtype)] = ex.extract(small)

    def gap(a, b):
        return max(float(np.abs(xv[a][k] - xv[b][k]).max()
                         / np.abs(xv[b][k]).max()) for k in xv[b])

    card_f32 = gap(("card", "bfloat16"), ("cpu", "float32"))
    cpu_f32 = gap(("cpu", "bfloat16"), ("cpu", "float32"))
    same_bf16 = gap(("card", "bfloat16"), ("cpu", "bfloat16"))
    same_f32 = gap(("card", "float32"), ("cpu", "float32"))
    # The uncentred variance E[x²] - mean² of attention pooling (the JAX
    # package's formula) amplifies the bf16 frame stack's rounding where a
    # channel's mean² outweighs its variance (up to ~11x here, BN state
    # after two steps), so bf16 against f32 is measured on both devices
    # and the card is held to the CPU in the same dtype.
    print(f"presets attention: unfused extraction, same weights, normalised "
          f"error: card bf16 vs CPU f32 {card_f32:.3g} (the CPU's own bf16 "
          f"vs f32 {cpu_f32:.3g}); card vs CPU in bf16 {same_bf16:.3g} "
          f"(bound {ATT_BOUND}), in f32 {same_f32:.3g} (bound {F32_BOUND})")
    if same_bf16 > ATT_BOUND or same_f32 > F32_BOUND:
        fail("presets attention: card extraction disagrees with the CPU")

    # AM-softmax tricks: the same minibatch twice, one step each
    cfg = replace(BENCHMARK_CONFIGS["am_softmax_tricks"],
                  num_targets=TRAIN_CLASSES, random_seed=seed)
    tr = TR.Trainer(cfg, os.path.join(tmp, "preset_am_softmax"), device=dev)
    mb = minibatch()
    lr = cfg.initial_effective_lrate
    shrink = schedules.shrink_value(cfg.proportional_shrink, lr)
    losses = [tr.train_one_iteration(it, [mb], lr, 0.0, shrink)["loss"]
              for it in range(2)]
    print(f"presets am_softmax_tricks ({cfg.model}, head {cfg.head}, "
          f"{cfg.optimizer} momentum {cfg.momentum}, shrink {shrink:g}): "
          f"loss {losses[0]:.6f} -> {losses[1]:.6f} [{tag}]")
    if not all(map(math.isfinite, losses)) or not losses[1] < losses[0]:
        fail("presets am_softmax_tricks: the loss is not finite and "
             "falling")


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
    outside the timed region.  Each in both designs, v2 ("sm90", the route
    these shapes take) and v1 ("sm80"), with a host-inclusive time per
    call of each."""
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
        kern = {}
        for design in ("sm90", "sm80"):
            kern[("fwd", design)] = (
                lambda d=design: CB.conv_fwd(x, w, 1, design=d))
            kern[("dw", design)] = (
                lambda d=design: CB.conv_dw(x, g, k, 1, design=d))
            kern[("dx", design)] = (
                lambda d=design: CB.conv_dx(g, w, 1, design=d))
        for name in ("fwd", "dw", "dx"):
            lib_call, lib_view = lib[name]
            designs = ("sm80", "sm90")
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
                print(f"timing conv {kernel} {d} "
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
                key = name if d == "sm90" else f"{name}_{d}"
                out[(key, k)] = {"ms": ms[d], "plain_ms": plain_ms,
                                 "library_ms": lib_ms, "bound_ms": bound_ms,
                                 "bound_by": bound_by, "host_ms": host}
            v1, v2 = out[(f"{name}_sm80", k)], out[(name, k)]
            print(f"timing conv {kernel} k={k}: v2 (sm90) "
                  f"{v2['ms']:.4f} ms vs v1 (sm80) {v1['ms']:.4f} ms = "
                  f"{v1['ms'] / v2['ms']:.2f}x; host-inclusive v2 "
                  f"{v2['host_ms']:.4f} vs v1 {v1['host_ms']:.4f} ms "
                  f"({v2['host_ms'] / v1['host_ms'] - 1:+.1%}); cuDNN "
                  f"{lib_ms:.4f} ms = {lib_ms / v2['ms']:.2f}x v2 [{tag}]")
    return out


# ---------------------------------------------------------------------------
# the wave front end: wav.scp -> WaveExtractor (K1) -> ark
# ---------------------------------------------------------------------------

WAVE_SR = 8000
WAVE_UTTS = 64              # wav.scp entries, the two skipped ones included
WAVE_MAX_S = 60.0           # regular lengths spread over 1-60 s
WAVE_LONG_S = 120.0         # 12,000 frames: the long path
WAVE_BATCH = 16             # WaveExtractorConfig's default batch
WAVE_RUNS = 4               # timed runs of each extractor
WAVE_SPEAKERS = 8           # spk2utt groups of the CLI run
FRONT_RTOL, FRONT_ATOL = 1e-4, 2e-3    # features and CMVN, card vs CPU
GOLDEN_RTOL, GOLDEN_ATOL = 2e-4, 1e-3  # tests/test_features.py:208
VAD_NEAR = 1e-3             # |log energy - threshold| where a flip may fall
VAD_FLIP_SHARE = 1e-3       # at most 0.1% of frames may flip
LONG_BOUND = 1e-4           # long path vs its explicit host chain
AUG_BOUND = 1e-4            # augmentation, card vs CPU, normalised
SNR_BOUND_DB = 0.05


def speechlike(rng, n):
    """int16 bursts of low-passed noise (0.3-1.2 s, peak level 1500-8000)
    between gaps of faint noise (0.15-0.7 s, sigma 2): VAD keeps the
    bursts and the frames next to them."""
    from scipy.signal import lfilter
    env = np.empty(n, np.float64)
    pos, loud = 0, bool(rng.rand() < 0.5)
    while pos < n:
        seg = int(WAVE_SR * (rng.uniform(0.3, 1.2) if loud
                             else rng.uniform(0.15, 0.7)))
        env[pos: pos + seg] = rng.uniform(1500, 8000) if loud else 2.0
        pos, loud = pos + seg, not loud
    x = lfilter([1.0], [1.0, -rng.uniform(0.3, 0.9)], rng.randn(n))
    return np.clip(np.rint(x / x.std() * env), -32768, 32767).astype(
        np.int16)


def riff(samples, rate=WAVE_SR):
    """RIFF/WAVE 16-bit PCM bytes of (n,) or (n, channels) int16."""
    s = np.asarray(samples, "<i2")
    n_ch = 1 if s.ndim == 1 else s.shape[1]
    data = s.tobytes()
    return (b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE" + b"fmt "
            + struct.pack("<IHHIIHH", 16, 1, n_ch, rate, rate * 2 * n_ch,
                          2 * n_ch, 16)
            + b"data" + struct.pack("<I", len(data)) + data)


def sphere(raw: bytes, coding: str, n_bytes: int, byte_fmt="01", n=None,
           channels=1, rate=WAVE_SR):
    head = ("NIST_1A\n   1024\n"
            + (f"sample_count -i {n}\n" if n is not None else "")
            + f"channel_count -i {channels}\nsample_rate -i {rate}\n"
            f"sample_n_bytes -i {n_bytes}\n"
            f"sample_byte_format -s{len(byte_fmt)} {byte_fmt}\n"
            f"sample_coding -s{len(coding)} {coding}\nend_head\n")
    return head.encode().ljust(1024, b" ") + raw


def law_encode(x, decode):
    """int16 samples → the G.711 codes whose decoded values lie nearest."""
    table = decode(np.arange(256, dtype=np.uint8))
    order = np.argsort(table, kind="stable")
    st = table[order]
    i = np.clip(np.searchsorted(st, x), 1, 255)
    nearer = np.abs(st[i - 1] - x) <= np.abs(st[i] - x)
    return order[np.where(nearer, i - 1, i)].astype(np.uint8)


def write_wave_workload(TW, tmp, seed):
    """A wav.scp of WAVE_UTTS utterances at 8 kHz from ``seed``: one of
    WAVE_LONG_S, all-silence and 0.2 s ones (skipped), a stereo WAV's
    channel 1, SPHERE PCM in both byte orders, µ-law and A-law, a 2 s
    embedded-shorten SPHERE (tests/shorten_ref.py encodes), a 16 kHz WAV
    (resampled on reading), a ``cat … |`` pipe, and RIFF 16-bit for the
    rest, lengths spread over 1-WAVE_MAX_S s.  Returns the wav.scp path,
    {utt: format}, {utt: file}, {utt: samples at 8 kHz} and the
    utterances that must be skipped."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "shorten_ref", os.path.join(REPO, "tests", "shorten_ref.py"))
    enc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(enc)
    rng = np.random.RandomState(seed + 70)
    kinds = ["long", "silence", "short", "stereo", "sph_pcm01", "sph_pcm10",
             "sph_ulaw", "sph_alaw", "shorten", "wav16k", "pipe"]
    kinds += ["wav"] * (WAVE_UTTS - len(kinds))
    wdir = os.path.join(tmp, "wav")
    os.makedirs(wdir)
    lines, fmt, files, lens = [], {}, {}, {}
    for i, kind in enumerate(kinds):
        utt = f"w{i:02d}_{kind}"
        secs = {"long": WAVE_LONG_S, "silence": 4.0, "short": 0.2,
                "shorten": 2.0}.get(kind, rng.uniform(1.0, WAVE_MAX_S))
        n = int(secs * WAVE_SR)
        path = os.path.join(wdir, utt + (".sph" if kind.startswith("sph")
                                         or kind == "shorten" else ".wav"))
        spec_ = path
        if kind == "silence":
            data = riff(np.zeros(n, np.int16))
        elif kind == "stereo":
            data = riff(np.stack([speechlike(rng, n), speechlike(rng, n)], 1))
            spec_ = path + "#ch1"
        elif kind.startswith("sph_pcm"):
            bo = kind[-2:]
            raw = speechlike(rng, n).astype("<i2" if bo == "01" else ">i2")
            data = sphere(raw.tobytes(), "pcm", 2, bo)
        elif kind in ("sph_ulaw", "sph_alaw"):
            law = kind[-4:]
            dec = TW._mulaw_decode if law == "ulaw" else TW._alaw_decode
            data = sphere(law_encode(speechlike(rng, n), dec).tobytes(), law,
                          1)
        elif kind == "shorten":
            data = enc.sphere_with_shorten(speechlike(rng, n).astype(
                np.int64), sample_rate=WAVE_SR)
        elif kind == "wav16k":
            data = riff(speechlike(rng, 2 * n), rate=2 * WAVE_SR)
        else:
            data = riff(speechlike(rng, n))
            if kind == "pipe":
                spec_ = f"cat {path} |"
        with open(path, "wb") as f:
            f.write(data)
        lines.append(f"{utt} {spec_}\n")
        fmt[utt], files[utt], lens[utt] = kind, path, n
    scp = os.path.join(tmp, "wav.scp")
    with open(scp, "w") as f:
        f.writelines(lines)
    skipped = {u for u, k in fmt.items() if k in ("silence", "short")}
    return scp, fmt, files, lens, skipped


def cosine(a, b):
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))


def cm_bound(m):
    """Per-column error bound of Kaldi's CompressedMatrix: CM2 (≤ 8 rows)
    half a uint16 step of the global range (plus the float32 rounding of
    the stored minimum and range); CM one code of the widest
    percentile segment (a column's range over 63 codes at worst) plus the
    uint16 rounding of the percentiles."""
    grange = max(float(m.max() - m.min()), 1e-5)
    if m.shape[0] <= 8:
        return np.full(m.shape[1], grange / 65535 / 2
                       + 4e-7 * float(np.abs(m).max()))
    return (m.max(0) - m.min(0)) / 63 + 2 * grange / 65535 + 1e-6


def phase_wave(tt, TE, CB, TK, kio, dev, seed, tag, tmp):
    """The wave front end at full ``no_dropout`` width: read_wav_scp →
    WaveExtractor (bf16, K1) → ArkWriter as the main path, then its eight
    checks.  Returns (the main path's K1 layer launches by design, the
    decoded workload, the model, the files, and the main path's ark with
    the x-vectors written to it)."""
    import scipy.signal  # noqa: F401  (resample takes the band-limited branch)
    from xvector_tpu_torch.cli import extract_embedding
    from xvector_tpu_torch.io import wav as TW
    from xvector_tpu_torch.models.convert import tree_map
    from xvector_tpu_torch.ops import augment as TA
    from xvector_tpu_torch.ops import features as TF
    from xvector_tpu_torch.train import checkpoints
    from xvector_tpu_torch.train import trainer as TR

    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    scp, fmt, files, lens, skipped = write_wave_workload(TW, tmp, seed)
    print(f"wave: wrote {len(fmt)} utterances ({sorted(set(fmt.values()))}) "
          f"in {time.perf_counter() - t0:.2f} s")
    cfg, params, state = model(tt, "no_dropout", seed, 7185, dev)
    wcfg = TE.WaveExtractorConfig(batch_size=WAVE_BATCH, use_fused=True)

    # 1. the golden fixtures through mfcc on the card
    g = np.load(os.path.join(REPO, "tests", "golden", "feature_golden.npz"))
    clean = TF.MfccConfig(dither=0.0)
    for case in range(int(g["n_cases"])):
        got = TF.mfcc(torch.from_numpy(g[f"wave_{case}"].astype(
            np.float32)).to(dev), clean).cpu().numpy()
        want = g[f"mfcc_{case}"]
        excess = np.abs(got - want) - (GOLDEN_ATOL
                                       + GOLDEN_RTOL * np.abs(want))
        print(f"wave check golden case {case}: {got.shape} max_abs_err "
              f"{np.abs(got - want).max():.3g} (bound rtol {GOLDEN_RTOL}, "
              f"atol {GOLDEN_ATOL})")
        if got.shape != want.shape or excess.max() > 0:
            fail(f"wave: mfcc on the card misses golden case {case}")

    # the main path: counts zeroed just before, read just after
    out_ark = os.path.join(tmp, "wave_xv.ark")
    zero_counts(CB, TK)
    t0 = time.perf_counter()
    ex = TE.WaveExtractor(cfg, params, state, wcfg, device=dev)
    written = {}
    with kio.ArkWriter(out_ark, out_ark.replace(".ark", ".scp")) as w:
        for utt, xv in ex.extract_iter(TE.read_wav_scp(scp)):
            w.write(utt, xv)
            written[utt] = xv
    main_s = time.perf_counter() - t0
    routes = dict(TK.route_launches)
    launches = TK.launches
    xv_main = dict(kio.read_vec_flt_scp(out_ark.replace(".ark", ".scp")))
    calls = routes["l0_sm90"]
    print(f"wave: main path read_wav_scp -> WaveExtractor (bf16, fused) -> "
          f"ArkWriter: {len(xv_main)} x-vectors in {main_s:.3f} s host-"
          f"inclusive (decode, resample and the first call of each bucket "
          f"included); K1 layer launches {launches}, by design {routes} "
          f"(expected the layer-0 kernel on layer 0 and v5 on layers 1-4: "
          f"{calls} and {4 * calls}; v4 none) [{tag}]")
    if not k1_by_rule(routes) or launches != 5 * calls:
        fail("wave: the main path did not run K1's layer-0 kernel on layer "
             "0 and v5 on layers 1-4")
    kept = set(fmt) - skipped
    if set(xv_main) != kept:
        fail(f"wave: the ark holds {sorted(set(xv_main) ^ kept)} against "
             "the workload")
    for k, v in xv_main.items():
        if v.shape != (cfg.xvector_dim,) or not np.isfinite(v).all():
            fail(f"wave: x-vector {k} has shape {v.shape} or is not finite")

    waves = list(TE.read_wav_scp(scp))
    by_utt = dict(waves)
    if {u: len(w) for u, w in waves} != lens:
        fail("wave: decoded lengths differ from the written ones (the 16 "
             "kHz entry must come back resampled to 8 kHz)")

    # 2. the batched front end on the card against the CPU, 16 rows
    rows = [(u, w) for u, w in waves if fmt[u] not in ("long", "silence",
                                                       "short")
            and len(w) <= 30 * WAVE_SR][:16]
    wb, lb = TE.pack_wave_batch(rows, max(len(w) for _, w in rows),
                                len(rows))
    out = {}
    for where, d in (("card", dev), ("cpu", cpu)):
        with torch.inference_mode():
            feats, mask = TF.mfcc_batch(torch.from_numpy(wb).to(d),
                                        torch.from_numpy(lb).to(d), clean)
            vad = TF.energy_vad_batch(feats, mask)
            cmvn = TF.sliding_cmvn_batch(feats, mask)
        out[where] = [t.cpu() for t in (feats, mask, vad, cmvn)]
    (fc, mc, vc, cc), (fh, mh, vh, ch) = out["card"], out["cpu"]
    m = mh.bool()
    feat_err = float((fc[m] - fh[m]).abs().max())
    cmvn_err = float((cc - ch).abs().max())
    feats_ok = torch.allclose(fc[m], fh[m], rtol=FRONT_RTOL, atol=FRONT_ATOL)
    cmvn_ok = torch.allclose(cc, ch, rtol=FRONT_RTOL, atol=FRONT_ATOL)
    log_e = fh[..., 0].double()
    thresh = 5.5 + 0.5 * (log_e * mh).sum(1, keepdim=True) / mh.sum(
        1, keepdim=True)
    near = (log_e - thresh).abs() < VAD_NEAR
    flips = (vc != vh) & m
    n_frames = int(m.sum())
    print(f"wave check front end card vs CPU ({len(rows)} rows, {n_frames} "
          f"frames): mfcc_batch max_abs_err {feat_err:.3g}, "
          f"sliding_cmvn_batch {cmvn_err:.3g} (bound rtol {FRONT_RTOL}, atol "
          f"{FRONT_ATOL}); VAD decisions differing {int(flips.sum())} "
          f"({int((flips & near).sum())} of them within {VAD_NEAR} of the "
          f"threshold; {int((near & m).sum())} frames lie there; bound "
          f"{VAD_FLIP_SHARE:.1%} of frames); voiced share "
          f"{float(vh.sum()) / n_frames:.1%}")
    if not (feats_ok and cmvn_ok and torch.equal(mc, mh)):
        fail("wave: the front end on the card disagrees with the CPU")
    if bool((flips & ~near).any()) or int(flips.sum()) > VAD_FLIP_SHARE \
            * n_frames:
        fail("wave: VAD on the card flips frames away from the threshold")

    # 3. fused against unfused, bf16, the same weights
    unfused = TE.WaveExtractor(cfg, params, state, replace(
        wcfg, use_fused=False), device=dev)
    zero_counts(CB, TK)
    xv_plain = unfused.extract(waves)
    if TK.launches:
        fail("wave: the unfused extractor launched K1")
    cos = min(cosine(xv_main[k], xv_plain[k]) for k in kept)
    print(f"wave check fused vs unfused bf16: min cosine {cos:.6f} over "
          f"{len(kept)} x-vectors (bound {COSINE_BOUND})")
    if set(xv_plain) != kept or cos < COSINE_BOUND:
        fail("wave: fused and unfused x-vectors disagree")

    # 4. f32 on the card against the CPU, 4 short utterances
    short = [(u, w[: 3 * WAVE_SR]) for u, w in rows[:4]]
    f32 = TE.WaveExtractorConfig(batch_size=4, compute_dtype="float32")
    on_card = TE.WaveExtractor(cfg, params, state, f32, device=dev
                               ).extract(short)
    on_cpu = TE.WaveExtractor(cfg, params, state, f32, device=cpu
                              ).extract(short)
    f32_err = max(float(np.abs(on_card[k] - on_cpu[k]).max()
                        / np.abs(on_cpu[k]).max()) for k in on_cpu)
    print(f"wave check f32 card vs CPU (4 x 3 s): normalised error "
          f"{f32_err:.3g} (bound {F32_BOUND})")
    if set(on_card) != set(on_cpu) or len(on_cpu) != 4 \
            or f32_err > F32_BOUND:
        fail("wave: f32 extraction on the card disagrees with the CPU")

    # 5. the long utterance against its explicit host chain on the card
    long_utt = next(u for u, k in fmt.items() if k == "long")
    w = torch.from_numpy(by_utt[long_utt]).to(dev)
    feats = TF.mfcc(w, ex.mfcc_cfg)
    vad = TF.energy_vad(feats, ex.vad_cfg)
    before = TF.cmvn_launches
    pre = TE.preprocess(feats.cpu().numpy(), vad=vad.cpu().numpy(),
                        device=dev)
    if TF.cmvn_launches != before + 1:
        fail("wave: preprocess on the card left the CMVN kernel")
    if pre.device.type != "cuda":
        fail(f"wave: preprocess left the rows on {pre.device}")
    chain_ex = TE.XvectorExtractor(cfg, params, state, TE.ExtractorConfig(
        max_chunk=wcfg.max_chunk, batch_size=max(1, WAVE_BATCH // 4),
        compute_dtype="bfloat16", use_fused=True), device=dev)
    chain = chain_ex.extract([(long_utt, pre)])[long_utt]
    uploads = (chain_ex.counters["host_inputs"],
               ex._long.counters["host_inputs"])
    print(f"wave check long utterance: utterances uploaded again "
          f"(host_inputs) by the chain's extractor and the main path's "
          f"long path: {uploads[0]}, {uploads[1]}")
    if any(uploads):
        fail("wave: preprocess's rows went back to the host and up again")
    long_err = float(np.abs(xv_main[long_utt] - chain).max()
                     / np.abs(chain).max())
    print(f"wave check long utterance ({len(by_utt[long_utt]) / WAVE_SR:g} "
          f"s, {feats.shape[0]} frames, {pre.shape[0]} voiced, "
          f"{-(-pre.shape[0] // wcfg.max_chunk)} chunks) vs mfcc -> "
          f"energy_vad -> preprocess -> XvectorExtractor on the card: "
          f"normalised error {long_err:.3g}, identical "
          f"{bool(np.array_equal(xv_main[long_utt], chain))} (bound "
          f"{LONG_BOUND})")
    if long_err > LONG_BOUND:
        fail("wave: the long path disagrees with its host chain")

    # 6. the CLI on the card against the main path's rows
    work = os.path.join(tmp, "wave_exp")
    tr = TR.Trainer(TR.TrainConfig(model="no_dropout", num_targets=7185),
                    work, device=dev)
    tr.set_params(tree_map(lambda t: t.detach().clone(), params),
                  tree_map(lambda t: t.detach().clone(), state))
    checkpoints.save_iteration(tr, 0)
    keys = sorted(kept | skipped)
    spk2utt = os.path.join(tmp, "wave_spk2utt")
    with open(spk2utt, "w") as f:
        for s in range(WAVE_SPEAKERS):
            f.write(f"spk{s} " + " ".join(keys[s::WAVE_SPEAKERS]) + "\n")
    cli_ark = os.path.join(tmp, "wave_cli.ark")
    zero_counts(CB, TK)
    lines, cli_s = run_cli(extract_embedding, [
        f"--model-dir={work}", "--model=no_dropout", "--num-targets=7185",
        f"--wav-rspecifier=scp:{scp}", f"--output-ark={cli_ark}",
        f"--spk2utt={spk2utt}", f"--batch-size={WAVE_BATCH}",
        f"--device={dev}"])
    cli_routes = dict(TK.route_launches)
    xv_cli = dict(kio.read_vec_flt_scp(cli_ark.replace(".ark", ".scp")))
    spk = dict(kio.read_vec_flt_scp(cli_ark.replace(".ark", "_spk.scp")))
    same = set(xv_cli) == kept and all(np.array_equal(xv_cli[k], xv_main[k])
                                       for k in kept)
    print(f"wave check cli extract_embedding --wav-rspecifier: {lines[-1]}; "
          f"{cli_s:.3f} s host-inclusive (restore, decode, extraction, "
          f"writes); K1 layer launches by design {cli_routes}; rows "
          f"identical to the main path's: {same}; skipped "
          f"{sorted(skipped - set(xv_cli))}; {len(spk)} speaker means "
          f"[{tag}]")
    if not same or skipped & set(xv_cli) or len(spk) != WAVE_SPEAKERS:
        fail("wave: the CLI's ark differs from in-process extraction")

    # 7. augmentation on the card against the CPU
    arng = np.random.RandomState(seed + 80)
    x = by_utt[rows[0][0]][: 8 * WAVE_SR]
    assets = dict(
        rirs={"small": [(np.exp(-np.arange(4000) / 800.0)
                         * arng.randn(4000)).astype(np.float32)],
              "medium": [(np.exp(-np.arange(8000) / 1600.0)
                          * arng.randn(8000)).astype(np.float32)]},
        noises=[arng.randn(3 * WAVE_SR).astype(np.float32) * 300],
        musics=[arng.randn(20 * WAVE_SR).astype(np.float32) * 300],
        speeches=[by_utt[u] for u, _ in rows[1:9]])
    aug_errs = {}
    for kind in ("reverb", "noise", "music", "babble"):
        a = TA.augment_utterance(kind, x, np.random.RandomState(seed),
                                 TA.AugmentConfig(), device=dev, **assets)
        b = TA.augment_utterance(kind, x, np.random.RandomState(seed),
                                 TA.AugmentConfig(), device=cpu, **assets)
        aug_errs[kind] = float(np.abs(a - b).max() / np.abs(b).max())
    xs = torch.from_numpy(x).to(dev)
    snr_miss = 0.0
    for snr in sorted(set(TA.NOISE_SNRS + TA.MUSIC_SNRS + TA.BABBLE_SNRS)):
        y = TA.mix_noise(xs, torch.from_numpy(assets["noises"][0]).to(dev),
                         snr, offset=1234).double()
        added = y - xs.double()
        hit = 10 * math.log10(float(xs.double().square().mean()
                                    / added.square().mean()))
        snr_miss = max(snr_miss, abs(hit - snr))
    print(f"wave check augmentation card vs CPU (8 s, RIRs of 4000/8000 "
          f"taps): normalised error {aug_errs} (bound {AUG_BOUND}); mix_noise "
          f"SNR off by at most {snr_miss:.3g} dB (bound {SNR_BOUND_DB})")
    if max(aug_errs.values()) > AUG_BOUND or snr_miss > SNR_BOUND_DB:
        fail("wave: augmentation on the card disagrees with the CPU")

    # 8. card features through the compressed writer
    cm_ark = os.path.join(tmp, "feats_cm.ark")
    mats = {rows[i][0]: cc[i, : int(mc[i].sum())].numpy() for i in range(3)}
    mats["short_cm2"] = cc[0, :6].numpy()
    with kio.ArkWriter(cm_ark, cm_ark.replace(".ark", ".scp"),
                       compress=True) as wr:
        for k, v in mats.items():
            wr.write(k, v)
    back = dict(kio.read_mat_scp(cm_ark.replace(".ark", ".scp")))
    worst = max(float((np.abs(back[k] - v).max(0) / cm_bound(v)).max())
                for k, v in mats.items())
    raw_mb = sum(v.nbytes for v in mats.values()) / 1e6
    print(f"wave check compressed writer: {len(mats)} card feature matrices "
          f"({raw_mb:.2f} MB as f32, {os.path.getsize(cm_ark) / 1e6:.2f} MB "
          f"as CM/CM2), largest error {worst:.3f} of the quantisation bound")
    if set(back) != set(mats) or worst > 1.0:
        fail("wave: compressed features came back beyond CM's step")
    return routes, waves, (cfg, params, state), files, (out_ark, written)


def phase_wave_timing(tt, TE, TK, dev, tag, waves, mdl, files):
    """Wave-path throughput over the workload (fused and unfused in turns),
    the device time of one 16 x 8 s batch (front end alone, then the whole
    chain), a profiler breakdown of that batch, and host decode time per
    audio-second by format."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from xvector_tpu_torch.io import wav as TW
    from xvector_tpu_torch.ops import features as TF
    cfg, params, state = mdl
    audio_s = sum(len(w) for _, w in waves) / WAVE_SR
    times = {True: [], False: []}
    exs = {fused: TE.WaveExtractor(cfg, params, state, TE.WaveExtractorConfig(
        batch_size=WAVE_BATCH, use_fused=fused), device=dev)
        for fused in (True, False)}
    n_out = 0
    for i in range(WAVE_RUNS):
        for fused in ((True, False) if i % 2 else (False, True)):
            t0 = time.perf_counter()
            n_out = len(exs[fused].extract(waves))   # numpy out: synced
            times[fused].append(time.perf_counter() - t0)
    for fused in (True, False):
        q1, med, q3 = statistics.quantiles(times[fused], n=4)
        print(f"timing wave extraction {'fused' if fused else 'unfused'} "
              f"bf16 over the workload: {n_out / med:.1f} embeddings/s, "
              f"{audio_s / med:.1f} audio-s/s host-inclusive (median "
              f"{med:.4f} s, quartiles {q1:.4f}-{q3:.4f} s over "
              f"{len(times[fused])} runs; {len(waves)} utterances, "
              f"{audio_s:.1f} audio-s, {n_out} kept) [{tag}]")

    # one 16 x 8 s batch
    n8 = 8 * WAVE_SR
    rows = [(u, w[:n8]) for u, w in waves if len(w) >= n8][:WAVE_BATCH]
    wb, lb = TE.pack_wave_batch(rows, n8, len(rows))
    ex = exs[True]
    wd = torch.from_numpy(wb).to(dev)
    ld = torch.from_numpy(lb).to(dev)

    def front():
        feats, mask = TF.mfcc_batch(wd, ld, ex.mfcc_cfg)
        vad = TF.energy_vad_batch(feats, mask, ex.vad_cfg)
        feats = TF.sliding_cmvn_batch(feats, mask)
        return TF.compact_voiced(feats, vad)

    with torch.inference_mode():
        front_ms = cuda_ms(front, 20, 3)
        full_ms = cuda_ms(lambda: ex._fn(ex.params, ex.state, wd, ld), 20, 3)
    b_audio = len(rows) * 8
    print(f"timing wave batch {len(rows)}x8 s fused bf16 (CUDA events): "
          f"front end alone (mfcc_batch, energy_vad_batch, "
          f"sliding_cmvn_batch, compact_voiced) {front_ms:.4f} ms = "
          f"{b_audio / front_ms * 1e3:.1f} audio-s/s; front end + K1 + "
          f"pooling + embedding {full_ms:.4f} ms = "
          f"{len(rows) / full_ms * 1e3:.1f} embeddings/s, "
          f"{b_audio / full_ms * 1e3:.1f} audio-s/s [{tag}]")

    # where that batch's device time goes, host upload included
    stages = ("upload", "mfcc_batch", "energy_vad_batch",
              "sliding_cmvn_batch", "compact_voiced", "K1", "pooling+embed")

    folded = TK.fold_stack(cfg, ex.params, ex.state)   # once, as ex does

    def staged():
        with record_function("upload"):       # pinned, as the extractor
            w, n = ex._upload(wb), ex._upload(lb)
        with record_function("mfcc_batch"):
            feats, mask = TF.mfcc_batch(w, n, ex.mfcc_cfg)
        with record_function("energy_vad_batch"):
            vad = TF.energy_vad_batch(feats, mask, ex.vad_cfg)
        with record_function("sliding_cmvn_batch"):
            feats = TF.sliding_cmvn_batch(feats, mask)
        with record_function("compact_voiced"):
            feats, vmask = TF.compact_voiced(feats, vad)
        with record_function("K1"):
            h = TK.fused_frame_stack(cfg, folded, None, feats, vmask)
        with record_function("pooling+embed"):
            pooled = tt.stats_pooling(h, vmask[..., None])
            e0 = ex.params["embed"][0]
            xv = (pooled.to(torch.bfloat16).float()
                  @ e0["w"].to(torch.bfloat16).float()) + e0["b"]
        return xv.cpu()

    runs = 3
    with torch.inference_mode():
        staged()
        walls = []
        for _ in range(10):
            t0 = time.perf_counter()
            staged()                          # ends in a copy to the host
            walls.append((time.perf_counter() - t0) * 1e6)
        plain_us = statistics.median(walls)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(runs):
                staged()
            wall_us = (time.perf_counter() - t0) * 1e6 / runs
    def is_k1(name):
        return any(k in name for k in K1_KERNEL_NAMES)

    # each kernel under its stage and the outermost aten op that launched
    # it; K1's layers launch through ctypes, with no aten op, so they are
    # taken by name below
    groups = {}
    for e in prof.events():
        kern = [k for k in e.kernels if not is_k1(k.name)]
        if not kern:
            continue
        chain, p = [], e
        while p is not None and p.name not in stages:
            chain.append(p.name)
            p = p.cpu_parent
        if p is None:
            continue
        op = next((c for c in reversed(chain) if c.startswith("aten::")),
                  chain[-1] if chain else "?")
        key = f"{p.name}/{op.removeprefix('aten::')}"
        groups[key] = groups.get(key, 0.0) + sum(k.duration for k in kern)
    # kernels and copies; the record_function ranges also show on the
    # device's timeline as user annotations and are left out
    dev_events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA
                         and not getattr(e, "is_user_annotation", False)),
                        key=lambda e: e.time_range.start)
    busy_us = sum(e.time_range.elapsed_us() for e in dev_events) / runs
    layer_us = [e.time_range.elapsed_us() for e in dev_events
                if is_k1(e.name)]
    groups["K1/layer kernels"] = sum(layer_us)
    nl = cfg.num_frame_layers
    if not dev_events:
        print(f"profile wave batch: the profiler recorded no device events; "
              f"breakdown not measured [{tag}]")
        return
    names = {}
    for e in dev_events:
        names[e.name] = names.get(e.name, 0.0) + e.time_range.elapsed_us()
    print("profile wave batch top device kernels (us per batch): "
          + "; ".join(f"{n[:60]} {us / runs:.1f}" for n, us in sorted(
              names.items(), key=lambda kv: -kv[1])[:12]) + f" [{tag}]")
    per_stage = {s: sum(v for k, v in groups.items()
                        if k.startswith(s + "/")) / runs for s in stages}
    per_stage["not attributed"] = busy_us - sum(per_stage.values())
    print(f"profile wave batch {len(rows)}x8 s fused bf16 (3 runs, upload "
          f"from numpy to the x-vectors back on the host): device busy "
          f"{busy_us:.1f} us of {wall_us:.1f} us host-inclusive under the "
          f"profiler = {1 - busy_us / wall_us:.1%} device idle "
          f"({1 - busy_us / plain_us:.1%} of the unprofiled median, "
          f"{plain_us:.1f} us over 10 runs); by stage: "
          + "; ".join(f"{s} {us:.1f} us" for s, us in per_stage.items())
          + f" [{tag}]")
    print("profile wave batch by stage/op (us per batch): " + "; ".join(
        f"{k} {v / runs:.1f}" for k, v in sorted(
            groups.items(), key=lambda kv: -kv[1])[:20]) + f" [{tag}]")
    if len(layer_us) == nl * runs:
        print("profile wave batch K1 per layer (us): " + ", ".join(
            f"L{l} {statistics.median(layer_us[l::nl]):.1f}"
            for l in range(nl)) + f" [{tag}]")

    # host decode time per audio-second by format
    dec = {}
    for kind, label in (("wav", "WAV PCM16"), ("sph_pcm10", "SPHERE PCM"),
                        ("sph_ulaw", "SPHERE mu-law"),
                        ("shorten", "SPHERE shorten")):
        path = next(p for u, p in files.items() if u.endswith("_" + kind))
        reps = 1 if kind == "shorten" else 5
        t0 = time.perf_counter()
        for _ in range(reps):
            s, _ = TW.load_wave(path)
        dec[label] = (time.perf_counter() - t0) / reps / (len(s) / WAVE_SR)
    print("timing wave decode on the host, ms per audio-second: " + "; ".join(
        f"{k} {v * 1e3:.4f}" for k, v in dec.items()) + f" [{tag}]")


# ---------------------------------------------------------------------------
# phase 12: the scoring back end at SRE16 evaluation size
# ---------------------------------------------------------------------------

# The NIST SRE16 evaluation's sizes: 802 enrolment models (1 or 3
# segments), 9,294 test segments, ~1.99M trials, ~2% of them target; a
# labelled PLDA training set of 4,000 speakers (>= 2,000, so the device EM
# runs) and 2,272 unlabelled in-domain "major" segments.
BE_DIM = 512                # the no_dropout x-vector width
BE_TRAIN_SPK, BE_TRAIN_UTTS = 4000, 16
BE_MAJORS = 2272
BE_MODELS, BE_EVAL_SPK = 802, 201
BE_TESTS = 9294
BE_NONTARGETS = 210         # same-language nontarget models per test segment
BE_LDA_DIM = 100            # score_sre16's default
BE_EM_ITERS = 10
# the planted two-covariance model: 64 speaker dimensions with
# between/within ratios psi log-uniform in [0.15, 0.6] out of domain; in
# domain the speaker part is scaled by 1.6 and everything shifted by 1.5
# (tests/test_sre16_stage.py's mismatch)
BE_SPK_DIMS, BE_PSI = 64, (0.15, 0.6)
BE_SHIFT, BE_SCALE = 1.5, 1.6
# bounds: tests/test_backend.py's (the EM 223-232, the scorer 172-180)
EM_PSI_RTOL, EM_PSI_ATOL, EM_LLR_SPAN = 5e-3, 5e-4, 2e-2
SCORE_SPAN = 1e-3
PROJ_TOL = 2e-4
EER_GAP = 5e-4
# the back end's EER may exceed the planted model's Bayes (oracle) EER on
# the same trials by this factor plus this margin: it estimates that model
# from out-of-domain data through LDA and length-norm
EER_ORACLE_FACTOR, EER_ORACLE_MARGIN = 2.0, 0.01
PEAK_FP32_FLOPS = 67e12     # H100 SXM float32 outside the tensor cores
BE_WAVE_SPEAKERS = 8        # synthetic labels of the phase-11 x-vectors


def planted_backend_data(BP, seed):
    """Synthetic x-vectors from a planted two-covariance model at SRE16
    evaluation size; returns the recipe's inputs and the in-domain oracle
    (the planted model as a ``Plda`` on raw, unnormalised vectors)."""
    rng = np.random.default_rng(seed + 120)
    d, r = BE_DIM, BE_SPK_DIMS
    q, _ = np.linalg.qr(rng.standard_normal((d, d)))
    within = rng.uniform(0.5, 1.5, d)
    psi = np.zeros(d)
    psi[:r] = np.exp(rng.uniform(*np.log(BE_PSI), r))
    between = psi * within
    mu0 = 0.5 * rng.standard_normal(d)

    def speakers(n, scale):
        return rng.standard_normal((n, d)) * np.sqrt(between) * scale

    def segments(y, offset):
        z = y + rng.standard_normal(y.shape) * np.sqrt(within)
        return (mu0 + offset + z @ q.T).astype(np.float32)

    # labelled out-of-domain training set
    y = speakers(BE_TRAIN_SPK, 1.0)
    x = segments(np.repeat(y, BE_TRAIN_UTTS, axis=0), 0.0)
    train_xv, train_u2s = {}, {}
    for i, row in enumerate(x):
        s = i // BE_TRAIN_UTTS
        utt = f"train{s:04d}-{i % BE_TRAIN_UTTS:02d}"
        train_xv[utt], train_u2s[utt] = row, f"train{s:04d}"
    # unlabelled in-domain majors, two segments per speaker
    y = speakers(BE_MAJORS // 2, BE_SCALE)
    majors = {f"major{i:04d}": row for i, row in enumerate(
        segments(np.repeat(y, 2, axis=0), BE_SHIFT))}
    # evaluation speakers: 4 models each (2 for the last), half of them
    # averaged from 3 segments; test segments round-robin over speakers
    y = speakers(BE_EVAL_SPK, BE_SCALE)
    model_spk = np.minimum(np.arange(BE_MODELS) // 4, BE_EVAL_SPK - 1)
    n_segs = np.where(np.arange(BE_MODELS) % 2, 3, 1)
    segs = segments(np.repeat(y[model_spk], n_segs, axis=0), BE_SHIFT)
    starts = np.concatenate([[0], np.cumsum(n_segs)[:-1]])
    model_keys = [f"model{i:03d}" for i in range(BE_MODELS)]
    enroll = {k: segs[a:a + n].mean(0)
              for k, a, n in zip(model_keys, starts, n_segs)}
    num_utts = {k: int(n) for k, n in zip(model_keys, n_segs)}
    test_spk = np.arange(BE_TESTS) % BE_EVAL_SPK
    test_keys = [f"seg{j:04d}" for j in range(BE_TESTS)]
    test = dict(zip(test_keys, segments(y[test_spk], BE_SHIFT)))
    lang = np.array(["tgl", "yue"])[np.arange(BE_EVAL_SPK) % 2]
    utt2cond = dict(zip(test_keys, lang[test_spk]))
    # trials: every model of the segment's speaker (target) and 210 random
    # nontarget models of its language
    rows, cols = [], []
    for li in range(2):
        models = np.flatnonzero(model_spk % 2 == li)
        tests = np.flatnonzero(test_spk % 2 == li)
        keyr = rng.random((len(tests), len(models)))
        own = model_spk[models][None, :] == test_spk[tests][:, None]
        keyr[own] = np.inf
        pick = np.sort(models[np.argsort(keyr, axis=1)[:, :BE_NONTARGETS]],
                       axis=1)
        tgt = [models[o] for o in own]
        for j, nt, tg in zip(tests, pick, tgt):
            m = np.sort(np.concatenate([tg, nt]))
            rows.append(m)
            cols.append(np.full(len(m), j))
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    order = np.lexsort((rows, cols))
    rows, cols = rows[order].tolist(), cols[order].tolist()
    trials = [(model_keys[m], test_keys[t], int(model_spk[m] == test_spk[t]))
              for m, t in zip(rows, cols)]
    oracle = BP.Plda(mean=mu0 + BE_SHIFT,
                     transform=(q / np.sqrt(within)[None, :]).T,
                     psi=psi * BE_SCALE ** 2)
    return dict(train_xv=train_xv, train_u2s=train_u2s, majors=majors,
                enroll=enroll, test=test, trials=trials, num_utts=num_utts,
                utt2cond=utt2cond, oracle=oracle)


@contextlib.contextmanager
def recorded(targets):
    """Wrap each ``(owner, attribute, label)`` callable for the duration:
    per label, the seconds of every call and its (args, kwargs, result)."""
    seconds, calls, saved = {}, {}, []
    for owner, attr, label in targets:
        fn = getattr(owner, attr)
        saved.append((owner, attr, fn))

        def wrapped(*a, _fn=fn, _label=label, **k):
            t0 = time.perf_counter()
            out = _fn(*a, **k)
            seconds.setdefault(_label, []).append(time.perf_counter() - t0)
            calls.setdefault(_label, []).append((a, k, out))
            return out
        setattr(owner, attr, wrapped)
    try:
        yield seconds, calls
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def span_gap(got, want):
    """(max |got - want|, the span of want)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()), float(want.max() - want.min())


def phase_backend(CB, TK, dev, seed, tag, tmp, wave):
    """The scoring back end at SRE16 evaluation size: Recipe.score_sre16
    (LDA, device EM, adaptation, both scorings, pooled and per-condition
    metrics) as the main path, then score_trials_device over the grid and
    the checks against the host's f64 back end, TF32, the planted model,
    K1's x-vectors from phase 11 and the timings."""
    from xvector_tpu_torch.backend import metrics as BM
    from xvector_tpu_torch.backend import plda as BP
    from xvector_tpu_torch.backend import plda_device as PD
    from xvector_tpu_torch.cli import run as RUN
    from xvector_tpu_torch.io import kaldi_ark as kio
    from xvector_tpu_torch.io.datadir import DataDir

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    data = planted_backend_data(BP, seed)
    trials = data["trials"]
    n_tgt = sum(l for _, _, l in trials)
    print(f"backend: planted data in {time.perf_counter() - t0:.2f} s: "
          f"{len(data['train_xv'])} training x-vectors of {BE_TRAIN_SPK} "
          f"speakers ({BE_DIM}-d), {len(data['majors'])} majors, "
          f"{len(data['enroll'])} models ({sum(data['num_utts'].values())} "
          f"segments), {len(data['test'])} test segments, {len(trials)} "
          f"trials ({n_tgt} target, {n_tgt / len(trials):.2%}); "
          f"{BE_SPK_DIMS} speaker dimensions, psi {BE_PSI} out of domain, "
          f"in domain x{BE_SCALE} and shifted by {BE_SHIFT}")

    # the main path: counts zeroed just before, read just after
    recipe = RUN.Recipe(RUN.RecipeConfig(
        work_dir=os.path.join(tmp, "backend"),
        plda_em_iters=BE_EM_ITERS, device=str(dev)))
    stages = [(BP, "train_lda", "LDA"), (RUN, "train_plda_device", "PLDA EM"),
              (BP.Plda, "adapt", "adaptation"),
              (BP.Plda, "score_trials", "scoring"),
              (BM, "eer", "metrics"), (BM, "min_dcf", "metrics")]
    zero_counts(CB, TK)
    with recorded(stages) as (secs, calls):
        t0 = time.perf_counter()
        res = recipe.score_sre16(
            data["train_xv"], DataDir(utt2spk=data["train_u2s"]),
            data["majors"], data["enroll"], data["test"], trials,
            num_utts=data["num_utts"], utt2cond=data["utt2cond"])
        wall = time.perf_counter() - t0
    launches = TK.launches + sum(CB.launches.values())
    split = {k: sum(v) for k, v in secs.items()}
    print(f"timing backend Recipe.score_sre16: {wall:.3f} s wall; LDA "
          f"{split['LDA']:.3f} s, PLDA EM (device, first call) "
          f"{split['PLDA EM']:.3f} s, adaptation {split['adaptation']:.3f} "
          f"s, scoring out_of_domain {secs['scoring'][0]:.3f} s and "
          f"adapted {secs['scoring'][1]:.3f} s (host f64), metrics "
          f"{split['metrics']:.3f} s over {len(secs['metrics'])} calls, "
          f"the rest (grouping, LDA projection and length-norm of each "
          f"vector, lists) {wall - sum(split.values()):.3f} s [{tag}]")
    print(f"backend: kernel launches over the main path {launches} (no "
          f"kernel on this path: the back end is matrix products, inverses "
          f"and host f64)")
    [(em_args, em_kw, model)] = calls["PLDA EM"]
    grouped = em_args[0]
    if em_kw.get("device") != str(dev) or len(grouped) != BE_TRAIN_SPK:
        fail(f"backend: the PLDA EM ran with {em_kw} on {len(grouped)} "
             "speakers, not on the card")
    lda = calls["LDA"][0][2]
    adapted = calls["adaptation"][0][2]
    (_, e_p, t_p, pairs), sc_kw, _ = calls["scoring"][0]
    num_utts = sc_kw["num_utts"]
    labels = np.array([l for _, _, l in trials])
    for name in ("out_of_domain", "adapted"):
        r = res[name]
        print(f"backend {name}: EER {r['eer']:.6f}, minDCF(0.01) "
              f"{r['min_dcf']:.6f} over {r['num_trials']} trials; "
              + "; ".join(f"{c} EER {p['eer']:.6f} minDCF "
                          f"{p['min_dcf']:.6f} ({p['num_trials']} trials)"
                          for c, p in r["per_condition"].items()))

    # 1. score_trials_device over the enroll x test grid, both models,
    # against the recipe's own host f64 scores on the full trial list
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dev_scores, dev_s = {}, {}
    for name, m in (("out_of_domain", model), ("adapted", adapted)):
        t0 = time.perf_counter()
        dev_scores[name] = PD.score_trials_device(m, e_p, t_p, pairs,
                                                  num_utts, device=dev)
        dev_s[name] = time.perf_counter() - t0
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    for name in dev_scores:
        host = res[name]["scores"]
        gap, span = span_gap(dev_scores[name], host)
        e_dev = BM.eer(dev_scores[name], labels)
        print(f"backend check score_trials_device vs host Plda.score_trials "
              f"({name}, full trial list, {len(pairs)} trials, "
              f"{len(e_p)}x{len(t_p)} grid gathered on the card): max_abs_err "
              f"{gap:.3g}, span {span:.3g} (bound {SCORE_SPAN} x span = "
              f"{SCORE_SPAN * span:.3g}); EER device {e_dev:.6f} vs host "
              f"{res[name]['eer']:.6f}, |gap| "
              f"{abs(e_dev - res[name]['eer']):.3g} (bound {EER_GAP}); "
              f"minDCF device {BM.min_dcf(dev_scores[name], labels):.6f} vs "
              f"host {res[name]['min_dcf']:.6f}")
        if dev_scores[name].shape != host.shape \
                or not np.isfinite(dev_scores[name]).all() \
                or gap > SCORE_SPAN * span \
                or abs(e_dev - res[name]["eer"]) > EER_GAP:
            fail(f"backend: device scoring of {name} disagrees with the host")
    e_keys = list(e_p)
    e_mat = np.stack([e_p[k] for k in e_keys])
    n_e = np.array([num_utts[k] for k in e_keys], np.float32)
    t_mat = np.stack(list(t_p.values()))
    proj = []
    for label, v, kw, hkw in (
            ("enroll, num_utts", e_mat, {"num_examples": n_e}, None),
            ("test", t_mat, {}, {}),
            ("test, simple_length_norm", t_mat,
             {"simple_length_norm": True}, {"simple_length_norm": True})):
        got = PD.project_device(model, v, device=dev, **kw).cpu().numpy()
        if hkw is None:      # the host projects one count at a time
            want = np.empty_like(got, dtype=np.float64)
            for n in np.unique(n_e):
                sel = n_e == n
                want[sel] = model.project(v[sel], num_examples=int(n))
        else:
            want = model.project(v, **hkw)
        err = float((np.abs(got - want) - PROJ_TOL * np.abs(want)).max())
        proj.append(f"{label} max_abs_err {np.abs(got - want).max():.3g}")
        if err > PROJ_TOL:
            fail(f"backend: project_device ({label}) misses Plda.project")
    print("backend check project_device vs Plda.project: " + "; ".join(proj)
          + f" (bound rtol {PROJ_TOL}, atol {PROJ_TOL})")

    # 2. the device EM against the host f64 EM on the same LDA'd,
    # length-normalised training set
    t0 = time.perf_counter()
    host_model = BP.train_plda(grouped, num_em_iters=BE_EM_ITERS)
    host_em_s = time.perf_counter() - t0
    psi_d, psi_h = np.sort(model.psi), np.sort(host_model.psi)
    psi_excess = float((np.abs(psi_d - psi_h)
                        - (EM_PSI_ATOL + EM_PSI_RTOL * np.abs(psi_h))).max())
    s_host_model = PD.score_trials_device(host_model, e_p, t_p, pairs,
                                          num_utts, device=dev)
    gap, span = span_gap(dev_scores["out_of_domain"], s_host_model)
    print(f"backend check device EM vs host f64 EM ({BE_TRAIN_SPK} speakers, "
          f"D={BE_LDA_DIM}, {BE_EM_ITERS} iterations): sorted psi max_abs_err "
          f"{np.abs(psi_d - psi_h).max():.3g} (bound rtol {EM_PSI_RTOL}, "
          f"atol {EM_PSI_ATOL}; excess {psi_excess:.3g}); LLRs over the "
          f"full trial list max_abs_err {gap:.3g}, span {span:.3g} (bound "
          f"{EM_LLR_SPAN} x span = {EM_LLR_SPAN * span:.3g})")
    if psi_excess > 0 or gap > EM_LLR_SPAN * span:
        fail("backend: the device EM disagrees with the host f64 EM")

    # 3. TF32 allowed by the caller must not change a bit
    t_dev = PD.project_device(model, t_mat, device=dev)
    e_dev = PD.project_device(model, e_mat, num_examples=n_e, device=dev)
    n_dev = torch.from_numpy(n_e).to(dev)
    warm = PD.train_plda_device(grouped, num_em_iters=BE_EM_ITERS,
                                device=dev)
    s_off = PD.score_matrix(model, e_dev, t_dev, n_dev, device=dev)
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        on = PD.train_plda_device(grouped, num_em_iters=BE_EM_ITERS,
                                  device=dev)
        s_on = PD.score_matrix(model, e_dev, t_dev, n_dev, device=dev)
        kept = (torch.backends.cuda.matmul.allow_tf32,
                torch.get_float32_matmul_precision())
        # the same product outside the guard, to show TF32 would move it
        raw_on = PD._score_matrix(e_dev, t_dev, torch.from_numpy(
            model.psi.astype(np.float32)).to(dev), n_dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before[0]
        torch.set_float32_matmul_precision(before[1])
    raw_off = PD._score_matrix(e_dev, t_dev, torch.from_numpy(
        model.psi.astype(np.float32)).to(dev), n_dev)
    same_em = all(np.array_equal(getattr(on, f), getattr(warm, f))
                  for f in ("mean", "transform", "psi"))
    same_s = torch.equal(s_on, s_off)
    unguarded = float((raw_on - raw_off).abs().max())
    print(f"backend check TF32 allowed by the caller (allow_tf32=True, "
          f"float32 matmul precision 'high'): device EM identical "
          f"{same_em}, score matrix identical {same_s}; the caller's "
          f"setting after each call {kept}; the unguarded score matrix "
          f"moves by {unguarded:.3g} under TF32")
    if not (same_em and same_s) or kept != (True, "high"):
        fail("backend: TF32 allowed by the caller changed the back end's "
             "numbers or was not restored")

    # 4. the protocol on the planted data: the oracle's EER on these trials
    oracle = data["oracle"]
    ue = (np.stack([data["enroll"][k] for k in e_keys]) - oracle.mean) \
        @ oracle.transform.T
    ut = (np.stack(list(data["test"].values())) - oracle.mean) \
        @ oracle.transform.T
    s_or = PD.score_matrix(oracle, ue, ut, n_e, device=dev)
    e_idx = {k: i for i, k in enumerate(e_keys)}
    t_idx = {k: i for i, k in enumerate(data["test"])}
    rows = torch.tensor([e_idx[a] for a, _ in pairs], device=dev)
    cols = torch.tensor([t_idx[b] for _, b in pairs], device=dev)
    oracle_eer = BM.eer(s_or[rows, cols].cpu().numpy(), labels)
    eer_bound = EER_ORACLE_FACTOR * oracle_eer + EER_ORACLE_MARGIN
    diff = float(np.abs(res["adapted"]["scores"]
                        - res["out_of_domain"]["scores"]).max())
    conds = {n: sorted(res[n]["per_condition"]) for n in res}
    print(f"backend check protocol: planted-model (oracle) EER "
          f"{oracle_eer:.6f}, bound {EER_ORACLE_FACTOR} x oracle + "
          f"{EER_ORACLE_MARGIN} = {eer_bound:.6f}; out_of_domain EER "
          f"{res['out_of_domain']['eer']:.6f}, adapted EER "
          f"{res['adapted']['eer']:.6f}; adapted vs out_of_domain scores "
          f"differ by up to {diff:.3g}; conditions {conds}")
    if max(res[n]["eer"] for n in res) > eer_bound or diff <= 1e-3 \
            or any(c != ["tgl", "yue"] for c in conds.values()):
        fail("backend: the protocol misses on the planted data")

    # 5. composition through K1: phase 11's wave x-vectors, read in bulk
    ark, written = wave
    keys, mat = kio.read_vec_flt_matrix(ark, dim_hint=BE_DIM)
    same_rows = keys == list(written) and all(
        np.array_equal(mat[i], written[k]) for i, k in enumerate(keys))
    mean = BP.global_mean(data["majors"].values())

    def prep(v):
        return BP.length_normalize((np.asarray(v, np.float64) - mean)
                                   @ lda.transform.T)
    w_enroll = {f"wspk{s}": prep(mat[s]) for s in range(BE_WAVE_SPEAKERS)}
    w_test = {k: prep(mat[i]) for i, k in enumerate(keys)
              if i >= BE_WAVE_SPEAKERS}
    w_pairs = [(e, t) for e in w_enroll for t in w_test]
    w_dev = PD.score_trials_device(adapted, w_enroll, w_test, w_pairs,
                                   device=dev)
    w_host = adapted.score_trials(w_enroll, w_test, w_pairs)
    gap, span = span_gap(w_dev, w_host)
    print(f"backend check phase-11 x-vectors (K1): read_vec_flt_matrix "
          f"{mat.shape} rows identical to those written {same_rows}; "
          f"{BE_WAVE_SPEAKERS} synthetic speakers, {len(w_pairs)} trials "
          f"scored with the adapted PLDA: device vs host max_abs_err "
          f"{gap:.3g}, span {span:.3g} (bound {SCORE_SPAN} x span)")
    if not same_rows or mat.shape[1] != BE_DIM or gap > SCORE_SPAN * span:
        fail("backend: the wave x-vectors do not round-trip or score alike")

    # timings
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ev0.record()
    t0 = time.perf_counter()
    PD.train_plda_device(grouped, num_em_iters=BE_EM_ITERS, device=dev)
    ev1.record()
    torch.cuda.synchronize()
    em_host = time.perf_counter() - t0
    em_ev = ev0.elapsed_time(ev1)
    t0 = time.perf_counter()
    PD._em_stats(grouped)
    stats_s = time.perf_counter() - t0
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        PD.train_plda_device(grouped, num_em_iters=BE_EM_ITERS, device=dev)
        torch.cuda.synchronize()
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False))
    print(f"timing backend train_plda_device ({BE_TRAIN_SPK} speakers x "
          f"{BE_TRAIN_UTTS}, D={BE_LDA_DIM}, {BE_EM_ITERS} iterations): "
          f"first call {secs['PLDA EM'][0] * 1e3:.1f} ms host-inclusive "
          f"(inside the recipe, libraries loaded on first use); warm call "
          f"{em_ev:.1f} ms by CUDA events, {em_host * 1e3:.1f} ms "
          f"host-inclusive (host f64 statistics {stats_s * 1e3:.1f} ms); "
          f"device busy {busy / 1e3:.2f} ms under the profiler; host f64 "
          f"train_plda {host_em_s * 1e3:.1f} ms [{tag}]")
    m, p = e_dev.shape[0], t_dev.shape[0]
    sm_ms = cuda_ms(lambda: PD.score_matrix(model, e_dev, t_dev, n_dev,
                                            device=dev))
    psi_dev = torch.from_numpy(model.psi.astype(np.float32)).to(dev)
    with PD._full_f32():
        core_ms = cuda_ms(lambda: PD._score_matrix(e_dev, t_dev, psi_dev,
                                                   n_dev))
    flops = 2 * 2 * m * p * BE_LDA_DIM
    nbytes = 4 * (m * p + (m + p) * BE_LDA_DIM + m)
    bound_ms = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3
    by = "operations" if flops / PEAK_FP32_FLOPS > nbytes / PEAK_BYTES_PER_S \
        else "bytes"
    print(f"timing backend score_matrix {m}x{p}, D={BE_LDA_DIM}: "
          f"{sm_ms:.4f} ms per call by CUDA events ({core_ms:.4f} ms for "
          f"the products and elementwise passes alone), bound "
          f"{bound_ms:.4f} ms ({by}: {flops / 1e9:.3f} GFLOP at FP32 "
          f"{PEAK_FP32_FLOPS / 1e12:g} TFLOP/s, {nbytes / 1e6:.1f} MB at "
          f"{PEAK_BYTES_PER_S / 1e12:g} TB/s) = {bound_ms / core_ms:.1%} "
          f"of bound [{tag}]")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            PD.score_matrix(model, e_dev, t_dev, n_dev, device=dev)
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and not getattr(e, "is_user_annotation", False):
            kernels[e.name] = kernels.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 5
    print(f"profile backend score_matrix (us per call, device busy "
          f"{sum(kernels.values()):.1f}): " + "; ".join(
              f"{n[:50]} {us:.1f}" for n, us in sorted(
                  kernels.items(), key=lambda kv: -kv[1])[:8]) + f" [{tag}]")
    host_s = secs["scoring"]
    print(f"timing backend trials/s over {len(pairs)} trials: "
          f"score_trials_device {len(pairs) / dev_s['out_of_domain']:.0f} "
          f"and {len(pairs) / dev_s['adapted']:.0f} (host-inclusive: "
          f"projection, upload, matrix, gather, copy back; peak device "
          f"memory {peak_mb:.0f} MB); host f64 Plda.score_trials "
          f"{len(pairs) / host_s[0]:.0f} and {len(pairs) / host_s[1]:.0f} "
          f"[{tag}]")
    t0 = time.perf_counter()
    BM.eer(dev_scores["adapted"], labels)
    BM.min_dcf(dev_scores["adapted"], labels)
    print(f"timing backend eer + min_dcf over {len(pairs)} scores: "
          f"{time.perf_counter() - t0:.3f} s [{tag}]")
    print(f"backend: phase wall {time.perf_counter() - t_phase:.1f} s")


def phase_reference_h5(TR, kio, dev, tag, tmp, cli_paths):
    """--reference-h5 on phase 9's model: export_reference_h5 of
    model_final, then cli.extract_embedding --reference-h5, whose rows
    must equal the --model-dir run's.  Skipped, with one line, where h5py
    is not installed (a host file format, not a device path)."""
    try:
        import h5py  # noqa: F401
    except ImportError:
        print("reference-h5: the h5 export is skipped because h5py is not "
              "installed")
        return
    from xvector_tpu_torch.cli import extract_embedding
    from xvector_tpu_torch.train import checkpoints
    from xvector_tpu_torch.utils.export import export_reference_h5

    work, feats_ark, model_dir_ark = cli_paths
    tr = TR.Trainer(TR.TrainConfig(model="no_dropout",
                                   num_targets=TRAIN_CLASSES),
                    os.path.join(tmp, "h5_probe"), device=dev)
    checkpoints.restore_into(tr, os.path.realpath(
        os.path.join(work, "model_final")))
    h5 = os.path.join(tmp, "model.h5")
    export_reference_h5(h5, tr.model_cfg, tr.params, tr.state)
    out_ark = os.path.join(tmp, "h5_xvector.ark")
    out, secs = run_cli(extract_embedding, [
        f"--reference-h5={h5}", "--model=ModelWithoutDropout",
        f"--num-targets={TRAIN_CLASSES}",
        f"--feats-rspecifier=ark:{feats_ark}",
        f"--output-ark={out_ark}", f"--device={dev}"])
    got = dict(kio.read_vec_flt_scp(out_ark.replace(".ark", ".scp")))
    want = dict(kio.read_vec_flt_scp(model_dir_ark.replace(".ark", ".scp")))
    same = set(got) == set(want) and all(np.array_equal(got[k], want[k])
                                         for k in want)
    print(f"reference-h5: {os.path.getsize(h5) / 1e6:.1f} MB model.h5; "
          f"extract_embedding --reference-h5: {out[-1]} in {secs:.3f} s; "
          f"rows identical to the --model-dir run's: {same} "
          f"({len(want)} rows) [{tag}]")
    if not same:
        fail("reference-h5: the --reference-h5 rows differ from the "
             "--model-dir rows")


RECIPE_SPEAKERS = 48         # synthetic speakers of phase 13's corpus
RECIPE_UTTS = 8              # utterances per speaker (half enrol, half test)
RECIPE_SECONDS = (4.0, 12.0)  # utterance lengths, uniform
RECIPE_RIRS = 4              # synthetic room impulse responses
RECIPE_NOISES = 4            # synthetic noise signals
RECIPE_ARCHIVES = 4
# frames planned per archive: ~40 minibatches of 64 x 200-400 frames (the
# recipe's other allocator settings are AllocatorConfig's defaults)
RECIPE_FRAMES_PER_ITER = 40 * 64 * 300
RECIPE_EPOCHS = 2
RECIPE_EER_BOUND = 0.25      # far below chance (0.5)
RECIPE_CLI_SPEAKERS = 16     # cli.run --synthetic-speakers
RECIPE_CLI_UTTS = 6


def voice(rng):
    """A speaker's three resonances (poles at radius 0.97, 250-3600 Hz):
    the denominator of the all-pole filter its speech goes through."""
    a = np.array([1.0])
    for f in rng.uniform(250, 3600, size=3):
        a = np.convolve(a, [1.0, -2 * 0.97 * math.cos(
            2 * math.pi * f / WAVE_SR), 0.97 ** 2])
    return a


def speak(rng, a, n):
    """n samples of phase 11's bursts and gaps through the speaker's
    resonances ``a``, at the bursts' level, in int16 range (float64)."""
    from scipy.signal import lfilter
    x = speechlike(rng, n)
    y = lfilter([1.0], a, x.astype(np.float64))
    y *= x.std() / max(y.std(), 1e-9)
    return np.clip(np.rint(y), -32768, 32767)


def recipe_corpus(seed):
    """RECIPE_SPEAKERS x RECIPE_UTTS utterances of 8 kHz speech-like audio
    from ``seed``: phase 11's bursts and gaps, shaped by three resonances
    of the speaker's own, so that speakers can be told apart; each
    utterance keeps its own random spectral tilt."""
    rng = np.random.RandomState(seed + 130)
    waves, utt2spk = {}, {}
    for s in range(RECIPE_SPEAKERS):
        a = voice(rng)
        for u in range(RECIPE_UTTS):
            utt = f"spk{s:02d}_u{u}"
            waves[utt] = speak(rng, a, int(
                WAVE_SR * rng.uniform(*RECIPE_SECONDS))).astype(np.float32)
            utt2spk[utt] = f"spk{s:02d}"
    return waves, utt2spk


def recipe_rirs_noises(seed):
    """RECIPE_RIRS exponentially decaying noise bursts (0.1-0.4 s, a unit
    direct path) and RECIPE_NOISES coloured noises (3-6 s), from seed."""
    from scipy.signal import lfilter
    rng = np.random.RandomState(seed + 131)
    rirs = []
    for _ in range(RECIPE_RIRS):
        t = np.arange(int(WAVE_SR * rng.uniform(0.1, 0.4))) / WAVE_SR
        h = 0.3 * rng.randn(len(t)) * np.exp(-t / rng.uniform(0.03, 0.1))
        h[0] = 1.0
        rirs.append(h.astype(np.float32))
    noises = [(1000 * lfilter([1.0], [1.0, -rng.uniform(0.0, 0.95)],
                              rng.randn(int(WAVE_SR * rng.uniform(3, 6)))))
              .astype(np.float32) for _ in range(RECIPE_NOISES)]
    return rirs, noises


def file_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def same_archives(a, b, names):
    """The names whose files differ between directories a and b."""
    return [n for n in names if file_bytes(os.path.join(a, n))
            != file_bytes(os.path.join(b, n))]


def phase_recipe(CB, TK, TA, kio, dev, seed, tag, tmp):
    """The recipe (cli/run.py) at full ``no_dropout`` width, stage by
    stage through ``Recipe(RecipeConfig(..., device="cuda"))``: augment
    (reverb and noise copies on the card) → make_features (MFCC and VAD
    on the card, dither on) → make_egs (every archive through libxta;
    the stream route must give archive 0's minibatches byte for byte) →
    train (K2-K4, 6 calls per minibatch step, all "sm90"; the loss must
    fall) → extract (K1 in bf16: the layer-0 kernel, v5 on layers 1-4) and
    extract_from_wav (K1) → score (EER at most RECIPE_EER_BOUND); each
    stage is a main path, its counts zeroed just before it and read just
    after.  Then ``cli.run`` (a synthetic corpus, --extract-from-wav) and
    its ``--stage 3`` rerun, and ``cli.get_egs`` on stage 1's data dir,
    whose archives must equal make_egs's.  Returns the K2-K4 launches by
    design over the training stage and K1's layer launches by design over
    the two extraction stages."""
    from xvector_tpu_torch.cli import get_egs
    from xvector_tpu_torch.cli import run as RUN
    from xvector_tpu_torch.data import allocator as TAL
    from xvector_tpu_torch.extract.extractor import (ExtractorConfig,
                                                     speaker_means)
    from xvector_tpu_torch.io.datadir import DataDir, load_data_dir
    from xvector_tpu_torch.runtime import native
    from xvector_tpu_torch.train.trainer import TrainConfig

    t0 = time.perf_counter()
    waves, utt2spk = recipe_corpus(seed)
    rirs, noises = recipe_rirs_noises(seed)
    clean_s = sum(len(w) for w in waves.values()) / WAVE_SR
    print(f"recipe: corpus of {RECIPE_SPEAKERS} speakers x {RECIPE_UTTS} "
          f"utterances, {clean_s:.1f} audio-s at {WAVE_SR} Hz "
          f"({RECIPE_SECONDS[0]:g}-{RECIPE_SECONDS[1]:g} s each), "
          f"{RECIPE_RIRS} RIRs and {RECIPE_NOISES} noises, made in "
          f"{time.perf_counter() - t0:.2f} s")
    if not native.available():
        fail("recipe: libxta is not available (no C++ compiler found)")
    cfg = RUN.RecipeConfig(
        work_dir=os.path.join(tmp, "recipe"), min_utt_frames=199,
        num_archives=RECIPE_ARCHIVES,
        allocator=TAL.AllocatorConfig(
            frames_per_iter=RECIPE_FRAMES_PER_ITER),
        train=TrainConfig(model="no_dropout", num_targets=1,
                          num_epochs=RECIPE_EPOCHS,
                          compute_dtype="bfloat16", block_size=16),
        extractor=ExtractorConfig(compute_dtype="bfloat16"),
        device=str(dev))
    recipe = RUN.Recipe(cfg)
    secs = {}

    # stages 0 and 1: augmentation and features
    zero_counts(CB, TK)
    t0 = time.perf_counter()
    data, provider = recipe.augment(DataDir(utt2spk=utt2spk),
                                    waves.__getitem__, rirs=rirs,
                                    noises=noises, kinds=("reverb", "noise"))
    feat_dir = recipe.make_features(data, provider, split="all",
                                    dither_seed=seed + 1)
    torch.cuda.synchronize()
    secs["features"] = time.perf_counter() - t0
    audio_s = len(data) / len(waves) * clean_s
    frames = sum(feat_dir.utt2num_frames.values())
    voiced = sum(float(kio.read_vec_flt(feat_dir.vad[u]).sum())
                 for u in data.utts)
    print(f"recipe: stages 0-1 augment + make_features: {len(data)} "
          f"utterances ({len(waves)} clean, reverb and noise copies), "
          f"{audio_s:.1f} audio-s -> {frames} frames ({voiced / frames:.1%} "
          f"voiced) in {secs['features']:.3f} s = "
          f"{audio_s / secs['features']:.1f} audio-s/s [{tag}]")
    if len(feat_dir.feats) != len(data) or len(feat_dir.vad) != len(data):
        fail("recipe: make_features missed utterances")
    for utt in data.utts[:: max(1, len(data) // 16)]:
        m = kio.read_mat(feat_dir.feats[utt])
        if m.shape != (feat_dir.utt2num_frames[utt], 23) \
                or not np.isfinite(m).all():
            fail(f"recipe: features of {utt} are {m.shape} or not finite")
    # stage 1 hands over a Kaldi data dir on disk, as run.sh does; stage 2
    # and cli.get_egs both read it back (the diagnostic archives' plans
    # follow utt2spk's order, which the file sorts)
    data_dir = os.path.join(tmp, "recipe_data")
    feat_dir.save(data_dir)
    feat_dir = load_data_dir(data_dir)

    # stage 2: egs, every archive through libxta
    native_calls = []
    real_native, real_python = (TA.materialize_archive_native,
                                TA.materialize_archive)

    def counted_native(plan, path, *a, **kw):
        done = real_native(plan, path, *a, **kw)
        native_calls.append((os.path.basename(path), done))
        return done

    def refused(*a, **kw):
        fail("recipe: make_egs fell back to the Python materialisation")

    zero_counts(CB, TK)
    TA.materialize_archive_native, TA.materialize_archive = (counted_native,
                                                             refused)
    try:
        t0 = time.perf_counter()
        train_dir, valid_dir, n_targets = recipe.make_egs(feat_dir)
        secs["egs"] = time.perf_counter() - t0
    finally:
        TA.materialize_archive_native, TA.materialize_archive = (real_native,
                                                                 real_python)
    names = [f"egs.{i}.xta" for i in range(RECIPE_ARCHIVES)] + [
        "valid_egs.xta", "train_subset_egs.xta"]
    n_mb = {}
    for name in names:
        with TA.ArchiveReader(recipe._p(name)) as r:
            n_mb[name] = len(r)
    mbytes = sum(os.path.getsize(recipe._p(n)) for n in names) / 1e6
    print(f"recipe: stage 2 make_egs: {n_targets} targets, "
          f"{len(train_dir)} train / {len(valid_dir)} valid utterances, "
          f"archives {n_mb} ({mbytes:.1f} MB) in {secs['egs']:.3f} s; "
          f"libxta calls {native_calls} [{tag}]")
    if native_calls != [(n, True) for n in names]:
        fail("recipe: not every archive came from materialize_archive_native")
    if n_targets != RECIPE_SPEAKERS:
        fail(f"recipe: {n_targets} targets, expected {RECIPE_SPEAKERS}")

    # the stream route and the Python route against archive 0
    src, usable = recipe._prepare_egs_feats(feat_dir)
    s2i = DataDir({**train_dir.utt2spk, **valid_dir.utt2spk}).spk2int()
    plan0 = next(iter(TAL.allocate_archives(
        {u: usable[u] for u in train_dir.utts},
        {u: s2i[s] for u, s in train_dir.utt2spk.items()},
        cfg.allocator, num_archives=RECIPE_ARCHIVES)))
    shuffle = cfg.allocator.seed
    with TA.ArchiveReader(recipe._p("egs.0.xta")) as r:
        stored = list(r)
    streamed = list(TA.iter_plan_minibatches(plan0, utt2src=src,
                                             shuffle_seed=shuffle))
    same = len(stored) == len(streamed) and all(
        xa.tobytes() == xb.tobytes() and np.array_equal(ya, yb) and ta == tb
        for (xa, ya, ta), (xb, yb, tb) in zip(stored, streamed))
    print(f"recipe: iter_plan_minibatches over archive 0's plan (libxta, "
          f"shuffle seed {shuffle}): {len(streamed)} minibatches, byte for "
          f"byte those of egs.0.xta: {same}")
    if not same:
        fail("recipe: the stream route differs from archive 0")
    rates = {}
    size = os.path.getsize(recipe._p("egs.0.xta")) / 1e6
    for route in ("native", "python"):
        out = os.path.join(tmp, f"egs0_{route}.xta")
        t0 = time.perf_counter()
        if route == "native":
            TA.materialize_archive_native(plan0, out, src,
                                          shuffle_seed=shuffle)
        else:
            TA.materialize_archive(
                plan0, out, lambda u: kio.read_mat(f"{src[u][0]}:{src[u][1]}"),
                shuffle_seed=shuffle)
        dt = time.perf_counter() - t0
        rates[route] = (len(plan0.minibatches) / dt, size / dt, dt)
        if file_bytes(out) != file_bytes(recipe._p("egs.0.xta")):
            fail(f"recipe: the {route} materialisation of archive 0 differs")
    print("timing recipe materialisation of archive 0 ("
          f"{len(plan0.minibatches)} minibatches, {size:.1f} MB, from the "
          "egs feature ark): " + "; ".join(
              f"{r} {v[0]:.1f} minibatches/s, {v[1]:.1f} MB/s ({v[2]:.3f} s)"
              for r, v in rates.items())
          + f"; native/python {rates['native'][0] / rates['python'][0]:.2f}x"
          f" [{tag}]")

    # stage 3: train
    zero_counts(CB, TK)
    t0 = time.perf_counter()
    trainer = recipe.train(n_targets)
    torch.cuda.synchronize()
    secs["train"] = time.perf_counter() - t0
    launches, routes = dict(CB.launches), dict(CB.route_launches)
    recs = read_metrics(trainer.work_dir)
    train = [r for r in recs if r.get("kind") == "train"]
    steps = sum(int(r["minibatches"]) for r in train)
    iter_s = sum(r["seconds"] for r in train)
    print(f"recipe: stage 3 train: {len(train)} iterations, {steps} "
          f"minibatch steps, loss {train[0]['loss']:.4f} -> "
          f"{train[-1]['loss']:.4f}, accuracy {train[0]['accuracy']:.4f} -> "
          f"{train[-1]['accuracy']:.4f}; {secs['train']:.3f} s = "
          f"{1e3 * secs['train'] / steps:.2f} ms per minibatch (stage wall: "
          f"checkpoints, diagnostics included), iterations alone "
          f"{1e3 * iter_s / steps:.2f} ms per minibatch [{tag}]")
    wide = 2            # no_dropout's layers 1 and 2: k > 1, k·Cin > 160
    want = {n: wide * steps for n in ("fwd", "dw", "dx")}
    want_routes = {f"{n}_{d}": want[n] if d == "sm90" else 0
                   for n in ("fwd", "dw", "dx") for d in ("sm90", "sm80")}
    print(f"recipe: K2/K3/K4 calls over stage 3 {launches}, by design "
          f"{routes} (expected {want_routes})")
    if len(train) != RECIPE_EPOCHS * RECIPE_ARCHIVES:
        fail(f"recipe: {len(train)} training iterations")
    if launches != want or routes != want_routes:
        fail("recipe: K2/K3/K4 launch counts of stage 3 are off")
    if not all(math.isfinite(r["loss"]) for r in train) \
            or not train[-1]["loss"] < train[0]["loss"]:
        fail("recipe: the training loss did not fall")

    # stage 4: extraction from the feature arks, then from the waveforms
    k1 = {}
    xvs = {}
    for how in ("extract", "extract_from_wav"):
        zero_counts(CB, TK)
        t0 = time.perf_counter()
        if how == "extract":
            xvs[how] = recipe.extract(trainer, feat_dir, "all")
        else:
            xvs[how] = recipe.extract_from_wav(trainer, feat_dir, provider,
                                               "all")
        torch.cuda.synchronize()
        secs[how] = time.perf_counter() - t0
        k1[how] = dict(TK.route_launches)
        xv = xvs[how]
        print(f"recipe: stage 4 {how}: {len(xv)} x-vectors in "
              f"{secs[how]:.3f} s = {len(xv) / secs[how]:.1f} x-vectors/s; "
              f"K1 layer launches by design {k1[how]} [{tag}]")
        if len(xv) != len(data) or not all(
                v.shape == (512,) and np.isfinite(v).all()
                for v in xv.values()):
            fail(f"recipe: {how} gave {len(xv)} x-vectors or bad ones")
        if not k1_by_rule(k1[how]):
            fail(f"recipe: K1 did not run the layer-0 kernel on layer 0 and "
                 f"v5 on layers 1-4 in {how}")
    cos = [cosine(xvs["extract"][u], xvs["extract_from_wav"][u])
           for u in data.utts]
    print(f"recipe: feature-ark vs waveform x-vectors (dither on in stage 1 "
          f"only, compressed arks): cosine median {np.median(cos):.6f}, min "
          f"{min(cos):.6f}")

    # stage 5: score, enrolment on half of each speaker's clean utterances
    t0 = time.perf_counter()
    results = {}
    for how, xv in xvs.items():
        enroll = {u: xv[u] for u in waves if int(u[-1]) < RECIPE_UTTS // 2}
        test = {u: xv[u] for u in waves if int(u[-1]) >= RECIPE_UTTS // 2}
        spk_enroll, num_utts = speaker_means(enroll, utt2spk)
        trials = [(s, t, int(utt2spk[t] == s)) for s in spk_enroll
                  for t in test]
        train_xv = {u: xv[u] for u in train_dir.utts}
        results[how] = recipe.score(train_xv, train_dir, spk_enroll, test,
                                    trials, num_utts=num_utts)
    secs["score"] = time.perf_counter() - t0
    print("recipe: stage 5 score: " + "; ".join(
        f"{how} EER {r['eer']:.4f}, minDCF {r['min_dcf']:.4f} "
        f"({r['num_trials']} trials)" for how, r in results.items())
        + f" in {secs['score']:.3f} s (bound {RECIPE_EER_BOUND}) [{tag}]")
    for how, r in results.items():
        if not r["eer"] <= RECIPE_EER_BOUND:
            fail(f"recipe: {how} EER {r['eer']:.4f} above "
                 f"{RECIPE_EER_BOUND}")
    print("timing recipe stages (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in secs.items())
        + f"; total {sum(secs.values()):.3f} [{tag}]")

    # cli.run end to end, then a --stage 3 rerun
    work = os.path.join(tmp, "cli_run")
    argv = [f"--work-dir={work}", f"--synthetic-speakers="
            f"{RECIPE_CLI_SPEAKERS}", f"--synthetic-utts={RECIPE_CLI_UTTS}",
            "--model=no_dropout", "--extract-from-wav", f"--device={dev}"]
    kept = ("feats_all.ark", "egs_feats.ark", "egs.0.xta", "egs.1.xta")
    ckpt = os.path.join(work, "exp", "model_0", "ckpt.pt")
    for rerun in (False, True):
        zero_counts(CB, TK)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = RUN.main(argv + (["--stage=3"] if rerun else []))
        dt = time.perf_counter() - t0
        routes_cli, k1_cli = dict(CB.route_launches), dict(TK.route_launches)
        print(f"recipe: cli.run {' '.join(argv)}"
              + (" --stage=3" if rerun else "") + f": {dt:.3f} s, EER "
              f"{res['eer']:.4f} ({res['num_trials']} trials); K2-K4 by "
              f"design {routes_cli}, K1 {k1_cli} [{tag}]")
        if not (routes_cli["fwd_sm90"] > 0 and routes_cli["fwd_sm90"]
                == routes_cli["dw_sm90"] == routes_cli["dx_sm90"]
                and k1_by_rule(k1_cli)):
            fail("recipe: cli.run did not train through K2-K4 and extract "
                 "through K1")
        if not rerun:
            stamps = {n: os.stat(os.path.join(work, n)).st_mtime_ns
                      for n in kept}
            ckpt_stamp = os.stat(ckpt).st_mtime_ns
        elif ({n: os.stat(os.path.join(work, n)).st_mtime_ns for n in kept}
              != stamps or os.stat(ckpt).st_mtime_ns == ckpt_stamp
              or "forcing re-run from stage 3" not in buf.getvalue()):
            fail("recipe: the --stage 3 rerun did not reuse the features "
                 "and egs and retrain")

    # cli.get_egs on stage 1's data dir: make_egs's archives, byte for byte
    egs = os.path.join(tmp, "get_egs")
    flags = ["--min-frames-per-chunk=200", "--max-frames-per-chunk=400",
             "--minibatch-size=64", "--num-repeats=35",
             f"--frames-per-iter={RECIPE_FRAMES_PER_ITER}",
             f"--num-train-archives={RECIPE_ARCHIVES}",
             f"--num-heldout-utts={cfg.num_valid_utts}",
             f"--min-utt-frames={cfg.min_utt_frames}",
             f"--min-spk-utts={cfg.min_spk_utts}",
             f"--random-seed={cfg.allocator.seed}", f"--device={dev}",
             data_dir, egs]
    out, dt = run_cli(get_egs, flags)
    differ = same_archives(egs, recipe.cfg.work_dir,
                           names + ["pdf2num", "egs_info.json"])
    print(f"recipe: cli.get_egs {' '.join(flags[:-2])} <data> <egs>: "
          f"{out[-1]} in {dt:.3f} s; files differing from make_egs's: "
          f"{differ} [{tag}]")
    if differ:
        fail("recipe: get_egs archives differ from make_egs's")
    return routes, {d: k1["extract"][d] + k1["extract_from_wav"][d]
                    for d in TK.route_launches}


# ---------------------------------------------------------------------------
# phase 14: the SRE16 recipe (cli/run_sre16.py) on a synthetic LDC tree
# ---------------------------------------------------------------------------

SRE16_SWBD_SPEAKERS = 48     # SWBD cellular 1 speakers, one per call side
SRE16_SWBD_CALLS = 2         # calls each SWBD speaker takes part in
SRE16_POOL_SPEAKERS = 104    # --sre-data-dir speakers: more than --lda-dim
SRE16_POOL_UTTS = 2          # utterances per pool speaker
SRE16_MODELS = 40            # eval models, half tgl and half yue
SRE16_TESTS = 2              # test segments per eval speaker
SRE16_MAJOR_SPEAKERS = 24    # unlabeled majors: 2 segments each, 16 kHz
SRE16_SECONDS = (9.0, 12.0)  # every utterance: > 500 voiced frames
SRE16_EPOCHS = 1
SRE16_NUM_REPEATS = 20       # cut from run_sre16's default 35
# (run_xvector.sh:62) to keep the script's time as phase 16 joined it:
# ~4 archives of ~230 minibatches over the augmented training list
SRE16_FRAMES_PER_ITER = 4_600_000
SRE16_EER_BOUND = 0.25       # out-of-domain, far below chance (0.5)
SRE16_AUG = ("reverb", "noise", "music", "babble")
SRE16_SWBD_BASE = 40100      # conversation ids clear of the bad-audio lists
SRE16_WORKERS = 8            # shorten encoder processes


def _encode_shorten_call(samples):
    """Embedded-shorten SPHERE bytes of (n, 2) int16 call sides, through
    tests/shorten_ref.py (loaded by path: it runs in a worker process)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "shorten_ref", os.path.join(REPO, "tests", "shorten_ref.py"))
    enc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(enc)
    return enc.sphere_with_shorten(samples.astype(np.int64),
                                   sample_rate=WAVE_SR)


def sphere_pcm(samples, rate=WAVE_SR, byte_fmt="01"):
    """SPHERE 16-bit PCM bytes of (n,) or (n, channels) int16 values."""
    s = np.asarray(samples)
    s = s[:, None] if s.ndim == 1 else s
    return sphere(s.astype("<i2" if byte_fmt == "01" else ">i2").tobytes(),
                  "pcm", 2, byte_fmt, n=s.shape[0], channels=s.shape[1],
                  rate=rate)


def _put(path, data):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def _lines(path, rows):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")


def write_sre16_tree(tmp, seed):
    """The LDC/NIST tree phase 14 reads, from ``seed``:

    - ``LDC2001S13``: SWBD cellular 1, calls of two speakers as
      two-channel embedded-shorten SPHERE (one speaker per side), each
      speaker in SRE16_SWBD_CALLS calls, and ``doc/swb_callstats.tbl``;
    - ``sre_pool``: a pre-built Kaldi data dir (``--sre-data-dir``) of
      SRE16_POOL_SPEAKERS speakers, two-channel PCM SPHERE with ``#chN``
      entries: the PLDA pool;
    - ``R149_0_1``: the SRE16 eval tree, SRE16_MODELS speakers with 1-3
      µ-law enrolment segments and SRE16_TESTS PCM test segments each,
      half tgl and half yue;
    - ``download/sre16_evaluation_key`` beside it (the reference's
      layout): segment → call, call → language, and same-language trials;
    - ``major``: unlabeled majors at 16 kHz (resampled on reading);
    - ``musan`` (noise, music, speech; some files at 16 kHz) and
      ``RIRS_NOISES/simulated_rirs`` (small and medium rooms).

    Returns the roots, the trial key as (model, segment, label) rows and
    the pool's utterance ids."""
    from scipy.signal import lfilter
    from xvector_tpu_torch.io import wav as TW
    rng = np.random.RandomState(seed + 140)
    root = os.path.join(tmp, "ldc")

    def secs():
        return int(WAVE_SR * rng.uniform(*SRE16_SECONDS))

    # SWBD cellular 1: speakers paired anew in every round of calls
    swbd = os.path.join(root, "LDC2001S13")
    voices = [voice(rng) for _ in range(SRE16_SWBD_SPEAKERS)]
    genders = ["MF"[rng.randint(2)] for _ in voices]
    calls, rows = [], []
    for _ in range(SRE16_SWBD_CALLS):
        order = rng.permutation(SRE16_SWBD_SPEAKERS)
        for a, b in zip(order[0::2], order[1::2]):
            n = secs()
            conv = str(SRE16_SWBD_BASE + len(calls))
            calls.append((conv, np.stack([speak(rng, voices[a], n),
                                          speak(rng, voices[b], n)], 1)))
            rows.append(f"{conv},{1000 + a},{1000 + b},{genders[a]},"
                        f"{genders[b]}")
    _lines(os.path.join(swbd, "doc", "swb_callstats.tbl"), rows)
    import multiprocessing
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=min(SRE16_WORKERS, os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        blobs = list(pool.map(_encode_shorten_call, [c for _, c in calls]))
    for (conv, _), blob in zip(calls, blobs):
        _put(os.path.join(swbd, "data", "audio", f"sw_{conv}.sph"), blob)

    # the SRE pool: two pool utterances per two-channel file
    pool_dir = os.path.join(root, "sre_pool")
    utts = [(f"srespk{s:03d}", f"sre{s:03d}_{u}", voice_s)
            for s, voice_s in enumerate(voice(rng)
                                        for _ in range(SRE16_POOL_SPEAKERS))
            for u in range(SRE16_POOL_UTTS)]
    order = rng.permutation(len(utts))
    u2s, scp = [], []
    for i in range(0, len(order), 2):
        n = secs()
        pair = [utts[j] for j in order[i:i + 2]]
        path = os.path.join(pool_dir, "audio", f"call{i // 2:03d}.sph")
        _put(path, sphere_pcm(np.stack([speak(rng, v, n) for _, _, v in pair],
                                       1), byte_fmt="10"))
        for ch, (spk, utt, _) in enumerate(pair):
            u2s.append(f"{utt} {spk}")
            scp.append(f"{utt} {path}#ch{ch}")
    _lines(os.path.join(pool_dir, "utt2spk"), sorted(u2s))
    _lines(os.path.join(pool_dir, "wav.scp"), sorted(scp))

    # the SRE16 eval tree and its evaluation key
    ev = os.path.join(root, "R149_0_1")
    key = os.path.join(root, "download", "sre16_evaluation_key")
    enroll, subj, seg_call, lang_rows = (["modelid\tsegmentid"],
                                         ["segmentid\tsubjectid"],
                                         ["segmentid callid"], [])
    tests = []
    mu_dec = TW._mulaw_decode
    for m in range(SRE16_MODELS):
        v = voice(rng)
        lang = ("tgl", "yue")[m % 2]
        for u in range(1 + 2 * int(rng.rand() < 0.5)):   # 1 or 3 segments
            seg = f"en{m:03d}{u}"
            _put(os.path.join(ev, "data", "enrollment", f"{seg}.sph"),
                 sphere(law_encode(speak(rng, v, secs()), mu_dec).tobytes(),
                        "ulaw", 1))
            enroll.append(f"model{m:03d}\t{seg}")
        for u in range(SRE16_TESTS):
            seg = f"te{m:03d}{u}"
            _put(os.path.join(ev, "data", "test", f"{seg}.sph"),
                 sphere_pcm(speak(rng, v, secs())))
            subj.append(f"{seg}\tsubject{m:03d}")
            seg_call.append(f"{seg} call_{seg}")
            lang_rows.append(f"call_{seg} {lang}")
            tests.append((seg, m))
    trials = [(f"model{m:03d}", seg, int(m == t)) for seg, t in tests
              for m in range(t % 2, SRE16_MODELS, 2)]
    _lines(os.path.join(ev, "docs", "sre16_eval_enrollment.tsv"), enroll)
    _lines(os.path.join(ev, "docs", "sre16_eval_segment_key.tsv"), subj)
    _lines(os.path.join(key, "docs", "sre16_eval_segment_key.tsv"), seg_call)
    _lines(os.path.join(key, "metadata", "calls.tsv"), lang_rows)
    _lines(os.path.join(key, "docs", "sre16_eval_trial_key.tsv"),
           ["modelid segmentid side targettype"] + [
               f"{m} {seg} a {'target' if t else 'nontarget'}"
               for m, seg, t in trials])

    # unlabeled majors at 16 kHz
    major = os.path.join(root, "major")
    for s in range(SRE16_MAJOR_SPEAKERS):
        v = voice(rng)
        for u in range(2):
            x = speak(rng, v, secs())
            wide = np.interp(np.arange(2 * len(x)) / 2, np.arange(len(x)), x)
            _put(os.path.join(major, "data", "unlabeled", "major",
                              f"mj{s:03d}{u}.sph"),
                 sphere_pcm(np.rint(wide), rate=2 * WAVE_SR))

    # MUSAN and RIRS_NOISES
    musan = os.path.join(root, "musan")
    for i in range(4):
        rate = WAVE_SR * (1 + i % 2)
        x = 1500 * lfilter([1.0], [1.0, -rng.uniform(0.0, 0.95)],
                           rng.randn(int(rate * rng.uniform(4, 8))))
        _put(os.path.join(musan, "noise", "free-sound", f"noise-{i}.wav"),
             riff(np.clip(np.rint(x), -32768, 32767), rate=rate))
    for i in range(3):
        t = np.arange(int(WAVE_SR * rng.uniform(6, 10))) / WAVE_SR
        x = sum(2000 * np.sin(2 * np.pi * f * t) * (1 + np.sin(t * r))
                for f, r in zip(rng.uniform(150, 1500, 4),
                                rng.uniform(1, 6, 4)))
        _put(os.path.join(musan, "music", "fma", f"music-{i}.wav"),
             riff(np.rint(x / 4), rate=WAVE_SR))
    for i in range(8):
        _put(os.path.join(musan, "speech", "librivox", f"speech-{i}.wav"),
             riff(speak(rng, voice(rng), secs()), rate=WAVE_SR))
    rirs = os.path.join(root, "RIRS_NOISES")
    for room in ("smallroom", "mediumroom"):
        for i in range(3):
            t = np.arange(int(WAVE_SR * rng.uniform(0.1, 0.4))) / WAVE_SR
            h = 0.3 * rng.randn(len(t)) * np.exp(-t / rng.uniform(0.03, 0.1))
            h[0] = 1.0
            _put(os.path.join(rirs, "simulated_rirs", room, f"Room{i:03d}",
                              f"{room}-Room{i:03d}-00001.wav"),
                 riff(np.rint(h / np.abs(h).max() * 20000), rate=WAVE_SR))
    return {"swbd": swbd, "pool": pool_dir, "eval": ev, "major": major,
            "musan": musan, "rirs": rirs, "trials": trials,
            "pool_utts": sorted(u for _, u, _ in utts),
            "n_calls": len(calls), "enroll": len(enroll) - 1,
            "tests": len(tests)}


def time_extraction(RUN, splits):
    """Wrap ``Recipe.extract`` and ``Recipe.extract_from_wav`` so that each
    call records split -> (x-vectors, seconds) in ``splits``; returns the
    function that restores them."""
    real = RUN.Recipe.extract, RUN.Recipe.extract_from_wav

    def timed(fn):
        def wrapper(*args, **kw):       # split: the last positional or kw
            t = time.perf_counter()
            out = fn(*args, **kw)
            splits[kw.get("split", args[-1])] = (len(out),
                                                 time.perf_counter() - t)
            return out
        return wrapper

    RUN.Recipe.extract, RUN.Recipe.extract_from_wav = map(timed, real)

    def restore():
        RUN.Recipe.extract, RUN.Recipe.extract_from_wav = real
    return restore


# run_sre16 in a child process: ``python -m`` semantics (runpy), with the
# kernels' launch counts and the extraction stages' times sent back as the
# last line of its output
SRE16_CHILD = r"""
import json, runpy, sys
import chip_smoke
from xvector_tpu_torch.cli import run as RUN
from xvector_tpu_torch.ops import conv_bwd as CB, tdnn_kernel as TK
secs = {}
chip_smoke.time_extraction(RUN, secs)
sys.argv = ["run_sre16"] + json.loads(sys.argv[1])
runpy.run_module("xvector_tpu_torch.cli.run_sre16", run_name="__main__")
print(json.dumps({"k1": TK.route_launches, "conv": CB.route_launches,
                  "splits": secs}))
"""


def sre16_expected_trials(trials, work, prefix):
    """The key's trials whose model has an enrolment x-vector and whose
    segment a test x-vector in this run (run_sre16.py's filter)."""
    from xvector_tpu_torch.io import kaldi_ark as kio
    enroll = {u.split("-", 1)[0] for u, _ in kio.read_vec_flt_scp(
        os.path.join(work, f"{prefix}sre16_enroll.scp"))}
    test = {u for u, _ in kio.read_vec_flt_scp(
        os.path.join(work, f"{prefix}sre16_test.scp"))}
    return [t for t in trials if t[0] in enroll and t[1] in test]


def check_sre16_run(name, work, res, tree, prefix, tag):
    """The checks both runs share: both variants per language over the
    filtered trials, the out-of-domain EER, the PLDA pool, the score
    files and the archive count."""
    from xvector_tpu_torch.io import kaldi_ark as kio
    want = sre16_expected_trials(tree["trials"], work, prefix)
    with open(os.path.join(work, "sre16_results.json")) as f:
        results = json.load(f)
    for variant in ("out_of_domain", "adapted"):
        r, j = res.get(variant), results.get(variant)
        if r is None or j is None:
            fail(f"sre16 {name}: no {variant} result")
        if set(j.get("per_condition", {})) != {"tgl", "yue"} or \
                set(r.get("per_condition", {})) != {"tgl", "yue"}:
            fail(f"sre16 {name}: {variant} per_condition "
                 f"{sorted(j.get('per_condition', {}))}, not tgl and yue")
        if not r["num_trials"] == j["num_trials"] == len(want) > 0:
            fail(f"sre16 {name}: {variant} scored {j['num_trials']} trials, "
                 f"the key's filtered trials are {len(want)}")
        with open(os.path.join(work, f"scores_{variant}.txt")) as f:
            lines = f.read().splitlines()
        if [tuple(x.split()[:2]) for x in lines] != [t[:2] for t in want] \
                or not all(math.isfinite(float(x.split()[2]))
                           for x in lines):
            fail(f"sre16 {name}: scores_{variant}.txt is not one finite "
                 f"score per trial")
        with open(os.path.join(work, f"scores_{variant}.tsv")) as f:
            tsv = [x.split("\t") for x in f.read().splitlines()]
        if tsv[0] != ["modelid", "segmentid", "side", "LLR"] \
                or len(tsv) != len(want) + 1 \
                or not all(len(x) == 4 and math.isfinite(float(x[3]))
                           for x in tsv[1:]):
            fail(f"sre16 {name}: scores_{variant}.tsv does not parse")
    ood = results["out_of_domain"]["eer"]
    if not ood <= SRE16_EER_BOUND:
        fail(f"sre16 {name}: out-of-domain EER {ood:.4f} above "
             f"{SRE16_EER_BOUND}")
    pool = {u for u, _ in kio.read_vec_flt_scp(
        os.path.join(work, "xvector_sre_combined.scp"))}
    want_pool = {u + sfx for u in tree["pool_utts"]
                 for sfx in ("",) + tuple(f"-{k}" for k in SRE16_AUG)}
    if pool != want_pool:
        fail(f"sre16 {name}: sre_combined holds {len(pool)} utterances, "
             f"not the SRE speakers' {len(want_pool)} clean and augmented")
    with open(os.path.join(work, "egs_info.json")) as f:
        info = json.load(f)
    formula = (info["num_train_frames"] * SRE16_NUM_REPEATS
               // SRE16_FRAMES_PER_ITER + 1)
    if info["num_archives"] != formula:
        fail(f"sre16 {name}: {info['num_archives']} archives, get_egs.sh:120 "
             f"gives {formula}")
    print(f"sre16 {name}: " + "; ".join(
        f"{v} EER {results[v]['eer']:.4f} minDCF {results[v]['min_dcf']:.4f}"
        f" (" + ", ".join(f"{c} {m['eer']:.4f}" for c, m in
                          results[v]["per_condition"].items()) + ")"
        for v in ("out_of_domain", "adapted"))
        + f"; {len(want)} trials; PLDA pool {len(pool)} utterances; "
        f"{info['num_archives']} archives = {info['num_train_frames']} "
        f"frames x {SRE16_NUM_REPEATS} // {SRE16_FRAMES_PER_ITER} + 1 "
        f"[{tag}]")
    return results


def print_sre16_walls(name, work, splits, wall, tag):
    with open(os.path.join(work, "stage_walls.json")) as f:
        walls = json.load(f)
    print(f"timing sre16 {name} stage_walls.json (s): " + ", ".join(
        f"{k} {v}" for k, v in walls.items())
        + f"; whole run {wall:.3f} s [{tag}]")
    print(f"timing sre16 {name} extraction: " + "; ".join(
        f"{split} {n} x-vectors in {dt:.3f} s = {n / dt:.1f} x-vectors/s"
        for split, (n, dt) in splits.items()) + f" [{tag}]")
    return walls


def phase_sre16(CB, TK, kio, dev, seed, tag, tmp):
    """``cli/run_sre16.py`` at full ``no_dropout`` width on the tree of
    ``write_sre16_tree``: run 1 in-process (``main``, --extract-from-wav,
    final combination, MUSAN and RIRS on disk: K2-K4 in training, K1 in
    both extraction routes), counts zeroed just before and read just
    after; run 2 ``--stage 7`` without --extract-from-wav in a child
    process (the feature-ark route), which must leave the egs and the
    model untouched.  Returns the K2-K4 launches by design of run 1 and
    K1's layer launches by design over both runs."""
    from xvector_tpu_torch.cli import run as RUN
    from xvector_tpu_torch.cli import run_sre16

    t_phase = t0 = time.perf_counter()
    tree = write_sre16_tree(tmp, seed)
    print(f"sre16: LDC tree in {time.perf_counter() - t0:.2f} s: SWBD "
          f"cellular 1 {tree['n_calls']} two-channel shorten calls of "
          f"{SRE16_SWBD_SPEAKERS} speakers, SRE pool {len(tree['pool_utts'])} "
          f"utterances of {SRE16_POOL_SPEAKERS} speakers, SRE16 eval "
          f"{SRE16_MODELS} models ({tree['enroll']} enrolment, "
          f"{tree['tests']} test segments, {len(tree['trials'])} trials in "
          f"the key), {2 * SRE16_MAJOR_SPEAKERS} majors at 16 kHz, MUSAN "
          f"and RIRS on disk [{tag}]")
    work = os.path.join(tmp, "sre16")
    argv = ["--work-dir", work, "--swbd-cell1-root", tree["swbd"],
            "--sre-data-dir", tree["pool"], "--sre16-eval-root", tree["eval"],
            "--sre16-major-root", tree["major"], "--musan-dir",
            tree["musan"], "--rirs-dir", tree["rirs"],
            "--model", "no_dropout", "--num-epochs", str(SRE16_EPOCHS),
            "--frames-per-iter", str(SRE16_FRAMES_PER_ITER),
            "--num-repeats", str(SRE16_NUM_REPEATS),
            "--min-chunk", "200", "--max-chunk", "400",
            "--minibatch-size", "64", "--compute-dtype", "bfloat16",
            "--do-final-combination", "--device", str(dev)]

    # run 1: in-process, the waveform route
    splits = {}
    zero_counts(CB, TK)
    restore = time_extraction(RUN, splits)
    buf = io.StringIO()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = run_sre16.main(argv + ["--extract-from-wav"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        restore()
        for line in buf.getvalue().splitlines():
            print(f"sre16 run 1 | {line}")
    routes, k1 = dict(CB.route_launches), dict(TK.route_launches)
    check_sre16_run("run 1 (--extract-from-wav)", work, res, tree,
                    "xvector_wav_", tag)
    walls = print_sre16_walls("run 1", work, splits, wall, tag)
    train = [r for r in read_metrics(os.path.join(work, "exp"))
             if r.get("kind") == "train"]
    steps = sum(int(r["minibatches"]) for r in train)
    iter_s = sum(r["seconds"] for r in train)
    print(f"timing sre16 run 1 stage 3 train: {len(train)} iterations, "
          f"{steps} minibatch steps, loss {train[0]['loss']:.4f} -> "
          f"{train[-1]['loss']:.4f}; {1e3 * walls['train'] / steps:.2f} ms "
          f"per minibatch (stage wall), iterations alone "
          f"{1e3 * iter_s / steps:.2f} ms [{tag}]")
    want_routes = {f"{n}_{d}": 2 * steps if d == "sm90" else 0
                   for n in ("fwd", "dw", "dx") for d in ("sm90", "sm80")}
    print(f"sre16 run 1: K2/K3/K4 calls by design {routes} (expected "
          f"{want_routes}); K1 layer launches by design {k1}")
    if routes != want_routes or steps == 0:
        fail("sre16 run 1: K2/K3/K4 did not run 6 sm90 calls per step")
    if not k1_by_rule(k1):
        fail("sre16 run 1: K1 did not run the layer-0 kernel on layer 0 "
             "and v5 on layers 1-4")
    if not os.path.isdir(os.path.join(work, "exp", "model_combined")):
        fail("sre16 run 1: no final combination")

    # run 2: --stage 7 in a child process, the feature-ark route (it
    # clears run 1's x-vectors: keep the test split's for a comparison)
    wav_xv = dict(kio.read_vec_flt_scp(os.path.join(
        work, "xvector_wav_sre16_test.scp")))
    # egs_info.json is rewritten by every make_egs call: its contents
    # must stay, the archives, features and checkpoints their files
    kept = sorted(n for n in os.listdir(work)
                  if (n.startswith("egs") or n.startswith("feats_train"))
                  and n != "egs_info.json")
    kept += [os.path.join("exp", d, "ckpt.pt")
             for d in sorted(os.listdir(os.path.join(work, "exp")))
             if os.path.exists(os.path.join(work, "exp", d, "ckpt.pt"))]
    stamps = {n: os.stat(os.path.join(work, n)).st_mtime_ns for n in kept}
    with open(os.path.join(work, "egs_info.json")) as f:
        info = f.read()
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-c", SRE16_CHILD, json.dumps(argv + ["--stage",
                                                                "7"])],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    wall2 = time.perf_counter() - t0
    lines = out.stdout.splitlines()
    for line in lines[:-1]:
        print(f"sre16 run 2 | {line}")
    if out.returncode != 0:
        print(out.stderr[-4000:], file=sys.stderr)
        fail(f"sre16 run 2: python -m xvector_tpu_torch.cli.run_sre16 "
             f"--stage 7 exited {out.returncode}")
    child = json.loads(lines[-1])
    with open(os.path.join(work, "sre16_results.json")) as f:
        res2 = json.load(f)
    check_sre16_run("run 2 (--stage 7, feature arks)", work, res2, tree,
                    "xvector_", tag)
    print_sre16_walls("run 2", work, {k: tuple(v) for k, v in
                                      child["splits"].items()}, wall2, tag)
    moved = [n for n in kept
             if os.stat(os.path.join(work, n)).st_mtime_ns != stamps[n]]
    with open(os.path.join(work, "egs_info.json")) as f:
        moved += [] if f.read() == info else ["egs_info.json's contents"]
    print(f"sre16 run 2: K2/K3/K4 calls by design {child['conv']}; K1 layer "
          f"launches by design {child['k1']}; of {len(kept)} egs, feature "
          f"and checkpoint files {len(moved)} rewritten {moved}")
    if "forcing re-run from stage 7" not in out.stdout or moved:
        fail("sre16 run 2: --stage 7 did not keep the egs and the model")
    if any(child["conv"].values()):
        fail("sre16 run 2: --stage 7 trained again")
    if not k1_by_rule(child["k1"]):
        fail("sre16 run 2: K1 did not run the layer-0 kernel on layer 0 "
             "and v5 on layers 1-4")
    ark_xv = dict(kio.read_vec_flt_scp(os.path.join(
        work, "xvector_sre16_test.scp")))
    cos = [cosine(wav_xv[u], ark_xv[u]) for u in wav_xv]
    print(f"sre16: test x-vectors, waveform route (run 1) vs compressed "
          f"feature arks (run 2): cosine median "
          f"{np.median(cos):.6f}, min {min(cos):.6f} over {len(cos)}; phase "
          f"wall {time.perf_counter() - t_phase:.1f} s [{tag}]")
    return routes, {d: k1[d] + child["k1"][d] for d in TK.route_launches}


# ---------------------------------------------------------------------------
# phase 15: the multi-rank paths, several ranks on the one card
# ---------------------------------------------------------------------------

MC_RANKS = 2                 # gloo ranks sharing the card (parts 1, 2, 4)
MC_SHARDS = 3                # sre16_full's model axis: 7,185 = 3 x 2,395
MC_ARCHIVES = 2              # part 1: archives of MC_FULL full minibatches
MC_FULL = 16                 # ... and one ragged each
MC_FRAMES = 300              # part 1's extraction corpus: 50 utterances
MC_LR = 1e-3
MC_TIMEOUT = 300             # seconds per group of ranks
MC_STEP_BOUND = 1e-6         # f32 step, 2 ranks vs 1: params and BN state
MC_STEP_LOSS_BOUND = 2e-5    # ... and the loss (tests/test_scaling.py:84-93)
MC_SHARDED_BOUND = 1e-5      # sharded head vs the dense one, f32
SEQ_FRAMES, SEQ_VALID = 20000, 19995   # beyond the reference's 10,000 chunk
SEQ_BOUND = 1e-4             # tests/test_seqshard.py:32
MC_CHILD = r"""
import sys
import chip_smoke
chip_smoke.mc_worker(sys.argv[1:])
"""


def mc_step_cfg(TR, seed, dtype, **kw):
    """One SGD update from carried weights: the full-width ``no_dropout``
    step of part 2 (and, with ``head``, part 3)."""
    return TR.TrainConfig(model="no_dropout", num_targets=TRAIN_CLASSES,
                          compute_dtype=dtype, block_size=16,
                          optimizer="sgd", momentum=0.5, random_seed=seed,
                          **kw)


def mc_worker(argv):
    """One rank of phase 15's parts 2-5, in a child process of
    ``MC_CHILD``: argv part rank world backend init work seed device
    (``cuda:0`` for every gloo rank, ``cuda:<rank>`` under NCCL).  Part
    ``parity`` (2 and 4, and 5 with NCCL): one f32 and one bf16 SGD step
    on the rank's rows of the carried batch, then the sequence-sharded
    x-vector; part ``sharded`` (3): ``sre16_full`` with the head split
    over every rank.  Results go to ``<work>/<part>_<rank>.pt``."""
    import torch.distributed as dist

    from xvector_tpu_torch.models import tdnn as tt
    from xvector_tpu_torch.models.convert import (gather_params, tree_leaves,
                                                  tree_map)
    from xvector_tpu_torch.ops import conv_bwd as CB
    from xvector_tpu_torch.ops import tdnn_kernel as TK
    from xvector_tpu_torch.parallel import launch, seqshard
    from xvector_tpu_torch.parallel import mc_harness
    from xvector_tpu_torch.parallel import mesh as meshlib
    from xvector_tpu_torch.presets import BENCHMARK_CONFIGS
    from xvector_tpu_torch.train import checkpoints as C
    from xvector_tpu_torch.train import trainer as TR

    part, rank, world, backend, init, work, seed, device = (
        argv[0], int(argv[1]), int(argv[2]), argv[3], argv[4], argv[5],
        int(argv[6]), argv[7])
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = meshlib.init_distributed(backend, init, world, rank, device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    out = {"start_s": time.time() - float(os.environ["XVEC_SPAWN_TIME"]),
           "device": str(dev)}
    inputs = torch.load(os.path.join(work, f"{part}_inputs.pt"),
                        weights_only=False)
    x, y = inputs["x"], inputs["y"]

    def trunk_sha(params):
        return mc_harness.tree_sha({k: v for k, v in params.items()
                                    if k != "output"})

    if part == "parity":
        mesh = meshlib.make_mesh(data=world, model=1, device=dev)
        lo, hi = launch.host_local_batch_slice(TRAIN_B, mesh)
        for dtype in (("float32",) if backend == "nccl"
                      else ("float32", "bfloat16")):
            tr = TR.Trainer(mc_step_cfg(TR, seed, dtype),
                            os.path.join(work, f"{part}_{dtype}"), mesh=mesh)
            tr._place_all(*inputs["weights"])
            zero_counts(CB, TK)
            st = tr.train_one_iteration(0, iter([(x[lo:hi], y[lo:hi],
                                                  TRAIN_T)]),
                                        MC_LR, 0.0, 1.0)
            out[dtype] = {
                "loss": st["loss"], "sha": mc_harness.tree_sha(tr.params),
                "routes": dict(CB.route_launches),
                "params": ([p.detach().cpu() for p in tree_leaves(tr.params)]
                           + [s.cpu() for s in tree_leaves(tr.state)]
                           if rank == 0 else None)}
        # the step's flat gradient all-reduce on this backend
        grads = [torch.ones_like(p.detach()) for p in tree_leaves(tr.params)]
        meshlib.all_reduce_flat(grads, mesh.data_group)
        sync()
        t0 = time.perf_counter()
        for _ in range(5):
            meshlib.all_reduce_flat(grads, mesh.data_group)
        sync()
        out["allreduce_ms"] = (time.perf_counter() - t0) / 5 * 1e3
        out["floats"] = sum(g.numel() for g in grads)
        if backend != "nccl":
            cfg = tt.MODEL_ZOO["no_dropout"]
            p, s = (tree_map(lambda t: t.to(dev), tree)
                    for tree in inputs["seq_weights"])
            xs = inputs["seq_x"]
            xv = seqshard.seq_sharded_xvector(cfg, p, s, xs, mesh,
                                              valid_len=SEQ_VALID)
            sync()
            t0 = time.perf_counter()
            for _ in range(5):
                seqshard.seq_sharded_xvector(cfg, p, s, xs, mesh,
                                             valid_len=SEQ_VALID)
            sync()
            out["seq"] = xv.cpu()
            out["seq_ms"] = (time.perf_counter() - t0) / 5 * 1e3
    else:                          # "sharded": data 1 x model world
        mesh = meshlib.make_mesh(data=1, model=world, device=dev)
        tr = TR.Trainer(mc_step_cfg(TR, seed, "float32",
                                    head="sharded_softmax"),
                        os.path.join(work, "sharded_f32"), mesh=mesh)
        tr._place_all(*inputs["weights"])
        st = tr.train_one_iteration(0, iter([(x, y, TRAIN_T)]), MC_LR, 0.0,
                                    1.0)
        whole = gather_params(tr.params, mesh)
        out["f32"] = {"loss": st["loss"], "trunk": trunk_sha(tr.params),
                      "params": ([t.detach().cpu()
                                  for t in tree_leaves(whole)]
                                 if rank == 0 else None)}
        cfg = replace(BENCHMARK_CONFIGS["sre16_full"], random_seed=seed)
        tr = TR.Trainer(cfg, os.path.join(work, "sharded_bf16"), mesh=mesh)
        zero_counts(CB, TK)
        losses, steps = [], 0
        t0 = time.perf_counter()
        for it in range(2):
            st = tr.train_one_iteration(it, iter(inputs["block"]), MC_LR,
                                        0.0, 1.0)
            losses.append(st["loss"])
            steps += int(st["minibatches"])
        sync()
        secs = time.perf_counter() - t0
        routes = dict(CB.route_launches)
        t0 = time.perf_counter()
        C.save_iteration(tr, 1)
        out["bf16"] = {"losses": losses, "steps": steps, "routes": routes,
                       "ms_per_step": secs / steps * 1e3,
                       "save_ms": (time.perf_counter() - t0) * 1e3,
                       "trunk": trunk_sha(tr.params),
                       "head": {k: v.detach().cpu()
                                for k, v in tr.params["output"].items()}}
    torch.save(out, os.path.join(work, f"{part}_{rank}.pt"))
    dist.destroy_process_group()


def mc_spawn(part, world, backend, work, seed, inputs, dev):
    """Run ``mc_worker`` on ``world`` ranks, all on ``dev`` (gloo) or one
    card each (NCCL), and return their results."""
    from xvector_tpu_torch.parallel import mc_harness
    os.makedirs(work, exist_ok=True)
    torch.save(inputs, os.path.join(work, f"{part}_inputs.pt"))
    script = os.path.join(work, "mc_child.py")
    with open(script, "w") as f:
        f.write(MC_CHILD)
    init = "file://" + os.path.join(work, f"rdv_{part}_{backend}")
    mc_harness.spawn(script, [
        [part, r, world, backend, init, work, seed,
         f"cuda:{r}" if backend == "nccl" else str(dev)]
        for r in range(world)], timeout=MC_TIMEOUT)
    return [torch.load(os.path.join(work, f"{part}_{r}.pt"),
                       weights_only=False) for r in range(world)]


def mc_close(got, want, bound):
    """(every pair within ``bound`` absolute + ``bound`` relative, as
    ``tests/test_scaling.py`` holds them; the largest |difference|)."""
    ok = all(torch.allclose(a, b, rtol=bound, atol=bound)
             for a, b in zip(got, want))
    return ok, max(float((a - b).abs().max()) for a, b in zip(got, want))


def mc_compare(TR, dev, cfg, weights, batch, work):
    """One process's SGD update from the carried weights on the whole
    batch: (loss, params and BN state on the CPU)."""
    from xvector_tpu_torch.models.convert import tree_leaves
    tr = TR.Trainer(cfg, work, device=dev)
    tr._place_all(*weights)
    st = tr.train_one_iteration(0, iter([batch]), MC_LR, 0.0, 1.0)
    return st["loss"], ([p.detach().cpu() for p in tree_leaves(tr.params)]
                        + [s.cpu() for s in tree_leaves(tr.state)])


def mc_conv_timing(CB, dev, seed, tag):
    """K2, K3 and K4 (their "sm90" design) at the 32 rows a rank of part 1
    gives them: each held against its plain version on the same inputs
    (``KERNEL_BOUND``, ``DW_BOUND`` for K3's f32 output), then ms per call
    beside the bound, the plain version and the library call."""
    b = TRAIN_B // MC_RANKS
    for k in (5, 7):
        x, w, g = conv_inputs(b, TRAIN_T, 512, 512, k, dev, seed + k)
        left = (k - 1) // 2
        xc = x.transpose(1, 2).contiguous()
        gc = g.transpose(1, 2).contiguous()
        wc = w.permute(2, 1, 0).contiguous()

        def lib_bwd(mask):
            return torch.ops.aten.convolution_backward(
                gc, xc, wc, None, [1], [left], [1], False, [0], 1, mask)

        for name, kern, plain, lib in (
                ("K2", lambda: CB.conv_fwd(x, w, 1),
                 lambda: CB.conv_fwd_reference(x, w, 1),
                 lambda: F.conv1d(xc, wc, padding=left)),
                ("K3", lambda: CB.conv_dw(x, g, k, 1),
                 lambda: CB.conv_dw_reference(x, g, k, 1),
                 lambda: lib_bwd([False, True, False])),
                ("K4", lambda: CB.conv_dx(g, w, 1),
                 lambda: CB.conv_dx_reference(g, w, 1),
                 lambda: lib_bwd([True, False, False]))):
            which = {"K2": "fwd", "K3": "dw", "K4": "dx"}[name]
            before = CB.route_launches[f"{which}_sm90"]
            got = kern()
            torch.cuda.synchronize()
            if CB.route_launches[f"{which}_sm90"] - before != 1:
                fail(f"mc conv {name} k={k} {b}x{TRAIN_T}: not on sm90")
            want = plain()
            label = f"mc conv {name} sm90 k={k} {b}x{TRAIN_T} 512->512"
            if (got.shape != want.shape or got.dtype != want.dtype
                    or not torch.isfinite(got).all()):
                fail(f"{label}: {tuple(got.shape)} {got.dtype} or "
                     f"non-finite, expected {tuple(want.shape)} "
                     f"{want.dtype}")
            limit = DW_BOUND if name == "K3" else KERNEL_BOUND
            abs_err, err = norm_err(got, want)
            print(f"{label}: max_abs_err={abs_err:.6g} normalised="
                  f"{err:.3g} (bound {limit})")
            if err > limit:
                fail(f"{label} disagrees with its plain version")
            bms, by = bound(*conv_work(b, TRAIN_T, 512, 512, k, which))
            ms = cuda_ms(kern, 20, 3)
            print(f"timing mc conv {name} sm90 k={k} {b}x{TRAIN_T} "
                  f"512->512: {ms:.4f} ms/call, bound {bms:.4f} ms by {by} "
                  f"({bms / ms:.1%}), plain {cuda_ms(plain, 10, 2):.4f} ms, "
                  f"library {cuda_ms(lib, 20, 3):.4f} ms [{tag}]")


def mc_part1(TA, dev, seed, tag, tmp):
    """Part 1: ``parallel/mc_harness`` at full ``no_dropout`` width, two
    gloo ranks on the card.  Returns the straight run's launch counts,
    summed over its ranks."""
    from xvector_tpu_torch.extract.extractor import (ExtractorConfig,
                                                     XvectorExtractor)
    from xvector_tpu_torch.io import kaldi_ark as kio
    from xvector_tpu_torch.parallel import mc_harness as MH
    from xvector_tpu_torch.presets import BENCHMARK_CONFIGS
    from xvector_tpu_torch.train import checkpoints as C
    from xvector_tpu_torch.train import trainer as TR

    base = BENCHMARK_CONFIGS["baseline"]       # no_dropout, dense softmax
    fields = {k: getattr(base, k) for k in (
        "model", "head", "compute_dtype", "optimizer", "block_size")}
    spec = {"train": dict(fields, num_targets=TRAIN_CLASSES,
                          random_seed=seed),
            "global_mb": TRAIN_B, "frames": MC_FRAMES, "params_flat": False,
            "extract": {"compute_dtype": "bfloat16", "use_fused": True,
                        "batch_size": 32, "min_chunk": 25,
                        "max_chunk": 10000}}
    runs = {}
    for name in ("interrupted", "straight", "single"):
        work = os.path.join(tmp, f"mc_{name}")
        os.makedirs(work)
        for i in range(MC_ARCHIVES):     # the same archives in every run
            write_train_archive(TA, os.path.join(work, f"egs.{i}.xta"),
                                seed + 100 + i, 23, full=MC_FULL)
        valid = os.path.join(work, "valid_egs.xta")
        write_train_archive(TA, valid, seed + 110, 23, full=2, ragged=False)
        run_spec = dict(spec, valid=valid, timing=name == "straight")
        t0 = time.perf_counter()
        if name == "single":
            runs[name] = MH.run_single_controller(
                work, device=dev,
                spec=dict(run_spec, num_archives=MC_ARCHIVES,
                          final_combine=True))
        else:
            runs[name] = MH.run_group(
                work, interrupt=name == "interrupted", n_procs=MC_RANKS,
                num_archives=MC_ARCHIVES, final_combine=True,
                device=str(dev), backend="gloo", timeout=MC_TIMEOUT,
                spec=run_spec)
        runs[name]["wall"] = time.perf_counter() - t0
        runs[name]["work"] = work
    a, b = runs["interrupted"], runs["straight"]
    print(f"mc part 1 (mc_harness, {MC_RANKS} gloo ranks on {dev}, "
          f"no_dropout {TRAIN_CLASSES} classes bf16 Adam, {MC_ARCHIVES} "
          f"archives of {MC_FULL}+1 {TRAIN_B}x{TRAIN_T} minibatches, 2 "
          f"epochs, combination): interrupted after {MH.STOP_AFTER} "
          f"iterations and resumed {a['wall']:.1f} s, straight "
          f"{b['wall']:.1f} s, one process {runs['single']['wall']:.1f} s")
    if (a["params_sha"], a["state_sha"]) != (b["params_sha"], b["state_sha"]):
        fail("mc part 1: the interrupted run's model differs from the "
             "straight run's")
    if a["final_target"] != "model_combined" or a["final_iterations"] != 4:
        fail(f"mc part 1: {a['final_iterations']} iterations, model_final "
             f"-> {a['final_target']}")
    if set(a["xv"]) != set(b["xv"]) or any(
            not np.array_equal(v, b["xv"][u]) for u, v in a["xv"].items()):
        fail("mc part 1: the interrupted run's x-vectors differ")
    print(f"mc part 1: interrupted == straight bit for bit (params and BN "
          f"state sha256 {a['params_sha'][:16]}.., the combined model, "
          f"{len(a['xv'])} x-vectors); both ranks the same bits")
    recs = read_metrics(os.path.join(b["work"], "exp"))
    train = sorted((r for r in recs if r.get("kind") == "train"),
                   key=lambda r: r["iteration"])
    if not (all(math.isfinite(r["loss"]) for r in train)
            and train[-1]["loss"] < train[0]["loss"]):
        fail(f"mc part 1: the loss did not fall: {[r['loss'] for r in train]}")
    # kernels: every rank, every step, on sm90 (the workers are fresh
    # processes: their counts start at 0 with the run and are read at its
    # end); 2 wide layers per step
    steps = int(sum(r["minibatches"] for r in train))
    want = {f"{n}_{d}": 2 * steps if d == "sm90" else 0
            for n in ("fwd", "dw", "dx") for d in ("sm90", "sm80")}
    launches = {"conv": {}, "k1": {}}
    for run in (a, b):
        ranks = run["ranks"]["phase2"]
        if run is a:
            per_rank = [{k: v + p1["launches"]["conv"][k]
                         for k, v in p2["launches"]["conv"].items()}
                        for p1, p2 in zip(run["ranks"]["phase1"], ranks)]
        else:
            per_rank = [r["launches"]["conv"] for r in ranks]
        for r, got in enumerate(per_rank):
            if got != want:
                fail(f"mc part 1 rank {r}: K2-K4 calls {got}, expected "
                     f"{want} (2 wide layers x {steps:g} steps, all sm90)")
    for r in b["ranks"]["phase2"]:
        for key in ("conv", "k1"):
            for k, v in r["launches"][key].items():
                launches[key][k] = launches[key].get(k, 0) + v
    print(f"mc part 1: K2-K4 {want} per rank in each run; straight run "
          f"over its ranks {launches}; loss "
          + " -> ".join(f"{r['loss']:.4f}" for r in train))
    # the utterance shards against one process's fused extraction of the
    # same shards from the same model_final
    final = os.path.realpath(os.path.join(a["work"], "exp", "model_final"))
    ckpt = torch.load(os.path.join(final, C.CKPT), map_location=dev,
                      weights_only=True)
    utt2src = MH._utt2src(a["work"])
    ex = XvectorExtractor(MH._model_cfg("no_dropout"), ckpt["params"],
                          ckpt["state"], ExtractorConfig(**spec["extract"]),
                          device=dev)
    for shard in a["xv_shards"]:
        got = dict(ex.extract_iter((u, kio.read_mat("%s:%d" % utt2src[u]))
                                   for u in shard))
        if any(not np.array_equal(np.asarray(got[u], np.float32),
                                  a["xv"][u]) for u in shard):
            fail("mc part 1: the sharded extraction differs from one "
                 "process's")
    # K1 on the ranks held against the plain stack: rank 0's shard again
    # without the fused kernel, at phase 4's fused vs unfused bound
    shard = a["xv_shards"][0]
    plain_ex = XvectorExtractor(
        MH._model_cfg("no_dropout"), ckpt["params"], ckpt["state"],
        ExtractorConfig(**dict(spec["extract"], use_fused=False)),
        device=dev)
    plain = dict(plain_ex.extract_iter(
        (u, kio.read_mat("%s:%d" % utt2src[u])) for u in shard))
    cos = min(cosine(a["xv"][u], np.asarray(plain[u], np.float32))
              for u in shard)
    print(f"mc part 1: rank 0's {len(shard)} fused x-vectors vs the "
          f"unfused bf16 stack min cosine {cos:.6f} (bound {COSINE_BOUND})")
    if cos < COSINE_BOUND:
        fail("mc part 1: the ranks' fused x-vectors disagree with the "
             "unfused stack")
    tr = TR.Trainer(TR.TrainConfig(**spec["train"]),
                    os.path.join(tmp, "mc_restore"), device=dev)
    C.restore_into(tr, final)
    if MH.tree_sha(tr.params) != a["params_sha"]:
        fail("mc part 1: model_final restored in one process differs")
    print(f"mc part 1: utterance shards {a['shard_sizes']} equal one "
          f"process's fused extraction bit for bit; model_final restores "
          f"in one process")
    # timings: ms per minibatch step over the iterations, 2 ranks vs 1
    single = read_metrics(os.path.join(runs["single"]["work"], "exp"))
    per = {}
    for name, rs in (("2 ranks", recs), ("1 rank", single)):
        it = [r for r in rs if r.get("kind") == "train"]
        n = sum(r["minibatches"] for r in it)
        per[name] = sum(r["seconds"] for r in it) / n * 1e3
    audio = TRAIN_B * TRAIN_T / FRAMES_PER_SECOND
    tim = b["ranks"]["phase2"][0]["timing"]
    print(f"timing mc step: {per['2 ranks']:.2f} ms per global minibatch "
          f"with {MC_RANKS} ranks on one card ({audio / per['2 ranks'] * 1e3:.1f} "
          f"audio-s/s) vs {per['1 rank']:.2f} ms with one rank "
          f"({audio / per['1 rank'] * 1e3:.1f} audio-s/s), iterations' "
          f"seconds over their minibatches [{tag}]")
    print(f"timing mc gradient all-reduce (gloo, {MC_RANKS} ranks, "
          f"{tim['grad_floats']:,} floats = {tim['grad_floats'] * 4 / 1e6:.1f} "
          f"MB): {tim['grad_allreduce_ms']:.2f} ms = "
          f"{tim['grad_allreduce_ms'] / per['2 ranks']:.1%} of the step; "
          f"checkpoint save (barriers, rank 0 writes) "
          f"{tim['save_ms']:.1f} ms; process start "
          + ", ".join(f"{r['start_s']:.2f}" for r in b["ranks"]["phase2"])
          + f" s [{tag}]")
    return launches


def mc_nccl(TR, dev, seed, tag, tmp, batch):
    """Part 5: part 2's f32 step under NCCL, one card per rank, where the
    machine has a card for each rank; else one line says why not.
    ``batch`` is part 2's (x, y, carried weights)."""
    x, y, weights = batch
    cards = torch.cuda.device_count()
    if cards < MC_RANKS:
        print(f"mc part 5: NCCL not run: {cards} card(s) here and NCCL "
              f"takes one card per rank ({MC_RANKS} ranks)")
        return
    work = os.path.join(tmp, "mc_nccl")
    res = mc_spawn("parity", MC_RANKS, "nccl", work, seed,
                   {"x": x, "y": y, "weights": weights}, dev)
    loss1, one = mc_compare(TR, dev, mc_step_cfg(TR, seed, "float32"),
                            weights, (x, y, TRAIN_T),
                            os.path.join(work, "one"))
    ok, err = mc_close(res[0]["float32"]["params"], one, MC_STEP_BOUND)
    print(f"mc part 5 f32 SGD step, NCCL on {[r['device'] for r in res]}: "
          f"loss {res[0]['float32']['loss']:.7f} vs {loss1:.7f}, params "
          f"max |diff| {err:.3g} (bounds {MC_STEP_LOSS_BOUND}, "
          f"{MC_STEP_BOUND} abs + rel)")
    print(f"timing mc gradient all-reduce (NCCL, {MC_RANKS} cards, "
          f"{res[0]['floats']:,} floats): {res[0]['allreduce_ms']:.3f} ms; "
          "process start " + ", ".join(f"{r['start_s']:.2f}" for r in res)
          + f" s [{tag}]")
    if (abs(res[0]["float32"]["loss"] - loss1) > MC_STEP_LOSS_BOUND
            or not ok
            or res[0]["float32"]["sha"] != res[1]["float32"]["sha"]):
        fail("mc part 5: the NCCL step differs")


def phase_mc(TR, TA, CB, TK, dev, seed, tag, tmp):
    """Phase 15: parts 1-5 (see the module docstring).  Returns part 1's
    launch counts summed over its ranks."""
    from xvector_tpu_torch.models import tdnn as tt
    from xvector_tpu_torch.models.convert import tree_leaves, tree_map

    t_phase = time.perf_counter()
    launches = mc_part1(TA, dev, seed, tag, tmp)

    # parts 2 and 4: one SGD step, 2 ranks against 1; the long utterance
    rng = np.random.default_rng(seed + 120)
    means = rng.standard_normal((TRAIN_CLASSES, 23), dtype=np.float32)
    y = rng.integers(0, TRAIN_CLASSES, TRAIN_B, dtype=np.int32)
    x = (means[y][:, None, :] + rng.standard_normal(
        (TRAIN_B, TRAIN_T, 23), dtype=np.float32)).astype(np.float16)
    _, p0, s0 = model(tt, "no_dropout", seed + 121, TRAIN_CLASSES, "cpu")
    weights = (p0, s0)
    _, sp, ss = model(tt, "no_dropout", seed + 122, TRAIN_CLASSES, "cpu")
    seq_x = np.zeros((SEQ_FRAMES, 23), np.float32)
    seq_x[:SEQ_VALID] = rng.standard_normal((SEQ_VALID, 23),
                                            dtype=np.float32)
    work = os.path.join(tmp, "mc_parity")
    inputs = {"x": x, "y": y, "weights": weights, "seq_x": seq_x,
              "seq_weights": (sp, ss)}
    res = mc_spawn("parity", MC_RANKS, "gloo", work, seed, inputs, dev)
    for dtype in ("float32", "bfloat16"):
        if len({r[dtype]["sha"] for r in res}) != 1:
            fail(f"mc part 2 {dtype}: the ranks hold different bits")
        loss1, one = mc_compare(TR, dev, mc_step_cfg(TR, seed, dtype),
                                weights, (x, y, TRAIN_T),
                                os.path.join(work, f"one_{dtype}"))
        got = res[0][dtype]
        if dtype == "float32":
            ok, err = mc_close(got["params"], one, MC_STEP_BOUND)
            print(f"mc part 2 f32 SGD step, {MC_RANKS} gloo ranks vs 1: loss "
                  f"{got['loss']:.7f} vs {loss1:.7f}, params and BN state "
                  f"max |diff| {err:.3g} (bounds {MC_STEP_LOSS_BOUND}, "
                  f"{MC_STEP_BOUND} abs + rel); K2-K4 calls {got['routes']} "
                  f"(f32 takes the plain convs)")
            if abs(got["loss"] - loss1) > MC_STEP_LOSS_BOUND or not ok:
                fail("mc part 2: the f32 step on 2 ranks differs from 1")
        else:
            before = tree_leaves(weights)
            n = len(before)
            cos = min(float(F.cosine_similarity(
                (a - w).double().flatten(), (b - w).double().flatten(),
                dim=0)) for a, b, w in zip(got["params"][:n], one[:n],
                                           before))
            rel = abs(got["loss"] - loss1) / abs(loss1)
            # one step, 2 wide layers: each kernel twice on every rank
            want = {f"{k}_{d}": 2 if d == "sm90" else 0
                    for k in ("fwd", "dw", "dx") for d in ("sm90", "sm80")}
            print(f"mc part 2 bf16 SGD step (K2-K4), {MC_RANKS} ranks vs 1: "
                  f"loss {got['loss']:.6f} vs {loss1:.6f} (relative "
                  f"{rel:.3g}, bound {TRAIN_LOSS_BOUND}), update cosine min "
                  f"{cos:.6f} (bound {TRAIN_COSINE_BOUND}); each rank's "
                  f"K2-K4 calls {[r[dtype]['routes'] for r in res]}")
            if rel > TRAIN_LOSS_BOUND or cos < TRAIN_COSINE_BOUND:
                fail("mc part 2: the bf16 step on 2 ranks differs from 1")
            if any(r[dtype]["routes"] != want for r in res):
                fail(f"mc part 2: K2-K4 calls per rank are not {want}")
    cfg = tt.MODEL_ZOO["no_dropout"]
    sp_d, ss_d = (tree_map(lambda t: t.to(dev), t_) for t_ in (sp, ss))
    with torch.no_grad():
        want = tt.extract_xvector(cfg, sp_d, ss_d, torch.from_numpy(
            seq_x[None, :SEQ_VALID]).to(dev))[0].cpu()
    errs = [norm_err(r["seq"], want)[1] for r in res]
    print(f"mc part 4 seq_sharded_xvector ({MC_RANKS} gloo ranks, "
          f"no_dropout f32, {SEQ_FRAMES} frames, valid {SEQ_VALID}) vs one "
          f"process's unchunked extract_xvector: normalised error "
          + ", ".join(f"{e:.3g}" for e in errs) + f" (bound {SEQ_BOUND})")
    if max(errs) > SEQ_BOUND or not torch.equal(res[0]["seq"], res[1]["seq"]):
        fail("mc part 4: the sequence-sharded x-vector differs")
    print(f"timing mc seq_sharded_xvector {SEQ_FRAMES} frames on "
          f"{MC_RANKS} ranks: {res[0]['seq_ms']:.2f} ms per call; gradient "
          f"all-reduce (gloo, {res[0]['floats']:,} floats) "
          f"{res[0]['allreduce_ms']:.2f} ms; process start "
          + ", ".join(f"{r['start_s']:.2f}" for r in res) + f" s [{tag}]")

    # part 3: sre16_full, the head split over MC_SHARDS ranks
    from xvector_tpu_torch.presets import BENCHMARK_CONFIGS
    from xvector_tpu_torch.train import checkpoints as C
    block = write_train_archive(TA, os.path.join(tmp, "mc_block.xta"),
                                seed + 130, 23, full=16, ragged=False)
    work = os.path.join(tmp, "mc_sharded")
    res = mc_spawn("sharded", MC_SHARDS, "gloo", work, seed,
                   {"x": x, "y": y, "weights": weights, "block": block}, dev)
    loss1, one = mc_compare(TR, dev, mc_step_cfg(TR, seed, "float32",
                                                 head="softmax"),
                            weights, (x, y, TRAIN_T),
                            os.path.join(work, "one"))
    n = len(tree_leaves(weights[0]))
    got = res[0]["f32"]
    ok, err = mc_close(got["params"], one[:n], MC_SHARDED_BOUND)
    rel = abs(got["loss"] - loss1) / abs(loss1)
    print(f"mc part 3 sre16_full f32 SGD step, head split over "
          f"{MC_SHARDS} ranks ({TRAIN_CLASSES // MC_SHARDS} columns each) vs "
          f"one process's dense softmax: loss {got['loss']:.7f} vs "
          f"{loss1:.7f} (relative {rel:.3g}), params max |diff| {err:.3g} "
          f"(bound {MC_SHARDED_BOUND} each)")
    if rel > MC_SHARDED_BOUND or not ok:
        fail("mc part 3: the sharded head's step differs from the dense one")
    bf = [r["bf16"] for r in res]
    want = {f"{k}_{d}": 2 * bf[0]["steps"] if d == "sm90" else 0
            for k in ("fwd", "dw", "dx") for d in ("sm90", "sm80")}
    print(f"mc part 3 sre16_full bf16, 2 blocks of 16: loss "
          f"{bf[0]['losses'][0]:.4f} -> {bf[0]['losses'][1]:.4f}; trunk "
          f"sha256 {[r['trunk'][:12] for r in bf]}; K2-K4 calls per rank "
          f"{[r['routes'] for r in bf]} (expected {want})")
    if not (all(math.isfinite(v) for v in bf[0]["losses"])
            and bf[0]["losses"][1] < bf[0]["losses"][0]):
        fail("mc part 3: the sharded bf16 loss did not fall")
    if (len({r["trunk"] for r in bf}) != 1
            or len({r["f32"]["trunk"] for r in res}) != 1):
        fail("mc part 3: the ranks' trunks differ")
    if any(r["routes"] != want for r in bf):
        fail("mc part 3: K2-K4 calls per rank are not 6 per step on sm90")
    tr = TR.Trainer(BENCHMARK_CONFIGS["sre16_full"],
                    os.path.join(work, "restore"), device=dev)
    C.restore_into(tr, C.iteration_path(os.path.join(work, "sharded_bf16"),
                                        1))
    for key, dim in (("w", 1), ("b", 0)):
        whole = torch.cat([r["head"][key] for r in bf], dim)
        if not torch.equal(tr.params["output"][key].detach().cpu(), whole):
            fail("mc part 3: the restored head is not the shards side by "
                 "side")
    print(f"mc part 3: the checkpoint restores in one process, its head "
          f"the {MC_SHARDS} shards side by side")
    print(f"timing mc sharded step (sre16_full bf16, {MC_SHARDS} ranks on one "
          f"card): {bf[0]['ms_per_step']:.2f} ms per minibatch; checkpoint "
          f"save with the head's gather {bf[0]['save_ms']:.1f} ms; process "
          "start " + ", ".join(f"{r['start_s']:.2f}" for r in res)
          + f" s [{tag}]")

    mc_nccl(TR, dev, seed, tag, tmp, (x, y, weights))
    mc_conv_timing(CB, dev, seed, tag)
    print(f"mc: phase 15 took {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# 16. the entry points on every card of the call
# ---------------------------------------------------------------------------

MR_ARCHIVES = 2              # part A: 2 archives x 1 full 64x304 minibatch,
MR_MINIBATCHES = 1           # 1 epoch: 2 steps (bf16 runs part after more)
MR_LR = 1e-3
MR_F32_BOUND = 1e-5          # f32 SGD model_final, W ranks vs 1, max |diff|
MR_TIMING_ARCHIVES = 3       # part C: iteration 0 warms, 1 is timed, 2 is
MR_TIMING_FULL = 16          # profiled; 16 full minibatches each, block 16
MR_TIMEOUT = 300             # seconds per run of an entry point
MR_GLOO_RANKS = 2            # part A on a one-card call
MR_PAD_RANKS = 3             # part B's padded run: 8-row minibatches
MR_CHILD = r"""
import chip_smoke
chip_smoke.mr_child()
"""


def mr_child():
    """One process of a phase-16 run of an entry point: ``python
    <MR_CHILD> <module> <flags...>``, as the launching process, as one of
    the ranks it starts (the same command line) or as a single process.
    It runs ``<module>.main()`` and writes ``proc_<rank>.json`` (``main``
    for a process without ``XVEC_PROCESS_ID``) into ``$SMOKE_OUT``: the
    kernel wrappers' launch counts, the seconds from ``$SMOKE_T0`` to
    here (process start), the (rows, frames) shapes K2 ran at, and on
    request (``$SMOKE_CHECK``) K2-K4 held against their plain versions at
    each of those shapes, and (``$SMOKE_PROFILE_IT``) a profile of that
    iteration; with ``$SMOKE_SGD`` the entry point's ``TrainConfig``
    trains with SGD."""
    import importlib
    from functools import partial

    from xvector_tpu_torch.ops import conv_bwd as CB
    from xvector_tpu_torch.ops import tdnn_kernel as TK
    from xvector_tpu_torch.train import trainer as TR

    module = sys.argv[1]
    rank = os.environ.get("XVEC_PROCESS_ID", "main")
    out = {"start_s": time.time() - float(os.environ["SMOKE_T0"])}
    torch.backends.cuda.matmul.allow_tf32 = False
    mod = importlib.import_module(module)
    if os.environ.get("SMOKE_SGD"):
        mod.TrainConfig = partial(mod.TrainConfig, optimizer="sgd",
                                  momentum=0.5)
    profile_it = int(os.environ.get("SMOKE_PROFILE_IT", "-1"))
    if profile_it >= 0:
        TR.Trainer.train_one_iteration = _profiled(
            TR.Trainer.train_one_iteration, profile_it, out)
    shapes, conv_fwd = set(), CB.conv_fwd

    def recorded(x, w, dilation, **kw):
        shapes.add(tuple(x.shape[:2]))
        return conv_fwd(x, w, dilation, **kw)

    CB.conv_fwd = recorded
    sys.argv = [module] + sys.argv[2:]
    if "XVEC_NUM_PROCESSES" not in os.environ:
        # the ranks this process may start count their start from here
        os.environ["SMOKE_T0"] = repr(time.time())
    result = mod.main()
    CB.conv_fwd = conv_fwd
    out["conv"], out["k1"] = dict(CB.route_launches), dict(TK.route_launches)
    out["shapes"] = sorted(shapes)
    if result is not None:
        out["result"] = {k: v for k, v in result.items()
                         if k in ("eer", "min_dcf", "num_trials")}
    if os.environ.get("SMOKE_CHECK") and shapes:
        dev = (torch.device("cuda", torch.cuda.current_device())
               if torch.cuda.is_available() else torch.device("cpu"))
        out["conv_check"] = {f"{b}x{t}": mr_conv_check(CB, dev, b, t)
                             for b, t in sorted(shapes)}
    with open(os.path.join(os.environ["SMOKE_OUT"],
                           f"proc_{rank}.json"), "w") as f:
        json.dump(out, f)


def _profiled(one_iteration, profile_it, out):
    """``Trainer.train_one_iteration`` that runs iteration ``profile_it``
    under ``torch.profiler`` and records, per minibatch, the host wall
    time, the device's busy time (the union of its kernels' intervals)
    and the NCCL kernels' time, with the largest NCCL kernel's median."""
    from torch.profiler import ProfilerActivity, profile

    def run(self, it, *args, **kwargs):
        if it != profile_it:
            return one_iteration(self, it, *args, **kwargs)
        torch.cuda.synchronize(self.device)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            stats = one_iteration(self, it, *args, **kwargs)
            torch.cuda.synchronize(self.device)
            wall_us = (time.perf_counter() - t0) * 1e6
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        busy, end = 0.0, -math.inf
        for s, e, _ in spans:
            if e > end:
                busy += e - max(s, end)
                end = e
        nccl = [e - s for s, e, name in spans if "nccl" in name.lower()]
        n = stats["minibatches"]
        out["profile"] = {
            "minibatches": n, "wall_ms": wall_us / n / 1e3,
            "busy_ms": busy / n / 1e3, "device_events": len(spans),
            "nccl_ms": sum(nccl) / n / 1e3, "nccl_kernels": len(nccl),
            "nccl_largest_ms": (statistics.median(sorted(nccl)[-int(n):])
                                / 1e3 if nccl else 0.0)}
        return stats

    return run


def mr_conv_check(CB, dev, rows, frames, taps=((5, 1), (7, 1)), cin=512,
                  cout=512):
    """K2, K3 and K4 ("sm90") against their plain versions at the rows x
    frames one rank trains on, for each (k, dilation) of ``taps`` (the
    wide layers of ``no_dropout``: k=5 and 7, 512 -> 512): the largest
    normalised error of each (bounds ``KERNEL_BOUND``, ``DW_BOUND`` for
    K3)."""
    errs = {}
    for k, d in taps:
        x, w, g = conv_inputs(rows, frames, cin, cout, k, dev,
                              150 + 10 * d + k)
        for name, kern, plain in (
                ("K2", lambda: CB.conv_fwd(x, w, d),
                 lambda: CB.conv_fwd_reference(x, w, d)),
                ("K3", lambda: CB.conv_dw(x, g, k, d),
                 lambda: CB.conv_dw_reference(x, g, k, d)),
                ("K4", lambda: CB.conv_dx(g, w, d),
                 lambda: CB.conv_dx_reference(g, w, d))):
            got, want = kern(), plain()
            if got.shape != want.shape or not torch.isfinite(got).all():
                errs[name] = math.inf
            else:
                errs[name] = max(errs.get(name, 0.0), norm_err(got, want)[1])
    return errs


def mr_check_convs(label, trained):
    """Each training process's K2-K4 against their plain versions at every
    (rows, frames) shape its K2 ran at; a process with no check, or a
    kernel past ``KERNEL_BOUND`` (``DW_BOUND`` for K3), fails."""
    for r in sorted(trained):
        checks = trained[r].get("conv_check")
        if not checks:
            fail(f"multicard {label} rank {r}: no K2-K4 check was made")
        worst = {k: max(c[k] for c in checks.values())
                 for k in ("K2", "K3", "K4")}
        print(f"multicard {label} rank {r}: K2-K4 against the plain "
              f"versions at its {len(checks)} shape(s) "
              f"{', '.join(sorted(checks))}: worst "
              + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
              + f" (bounds {KERNEL_BOUND}, K3 {DW_BOUND})")
        if (worst["K2"] > KERNEL_BOUND or worst["K4"] > KERNEL_BOUND
                or worst["K3"] > DW_BOUND):
            fail(f"multicard {label} rank {r}: a kernel disagrees with its "
                 "plain version")


def mr_env(out, **extra):
    """The environment of a run: no launch variables unless ``extra``
    sets them, this repository on ``PYTHONPATH``, outputs in ``out``."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("XVEC_") and not k.startswith("SMOKE_")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(SMOKE_OUT=out, SMOKE_T0=repr(time.time()), **extra)
    return env


def mr_run(module, flags, out, ranks, tmp, **extra):
    """One run of ``module``'s entry point through ``MR_CHILD``:
    ``ranks`` None lets the entry point start one NCCL rank per visible
    card itself (no launch variables); 1 is a single process; k > 1 is k
    gloo ranks that this process starts through the launch contract, all
    on the one card.  Returns (the processes' records by rank, seconds).
    A failed rank fails the run."""
    from xvector_tpu_torch.parallel import launch
    os.makedirs(out, exist_ok=True)
    script = os.path.join(tmp, "mr_child.py")
    with open(script, "w") as f:
        f.write(MR_CHILD)
    t0 = time.perf_counter()
    if ranks is not None and ranks > 1:
        saved, env = dict(os.environ), mr_env(out, XVEC_BACKEND="gloo",
                                              **extra)
        os.environ.clear()
        os.environ.update(env)
        try:
            launch.spawn_local_ranks([script, module, *flags], out,
                                     world=ranks, timeout=MR_TIMEOUT)
        finally:
            os.environ.clear()
            os.environ.update(saved)
    else:
        env = mr_env(out, **extra)
        if ranks == 1:
            env["XVEC_NUM_PROCESSES"] = "1"
        # a session of its own: a timeout stops the ranks it started too
        proc = subprocess.Popen([sys.executable, script, module, *flags],
                                cwd=REPO, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True,
                                start_new_session=True)
        try:
            stdout, stderr = proc.communicate(timeout=MR_TIMEOUT)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            print(stdout[-3000:])
            print(stderr[-6000:], file=sys.stderr)
            fail(f"multicard: {module} {' '.join(flags)} exited "
                 f"{proc.returncode}")
    secs = time.perf_counter() - t0
    recs = {}
    for name in os.listdir(out):
        if name.startswith("proc_") and name.endswith(".json"):
            with open(os.path.join(out, name)) as f:
                recs[name[5:-5]] = json.load(f)
    return recs, secs


def mr_ranks(recs):
    """The records of the processes that trained: the ranks, or the one
    process of a single-process run."""
    ranks = {k: v for k, v in recs.items() if k != "main"}
    return ranks or recs


def mr_final(work):
    """(params and BN state of ``model_final``, params of ``model_1``, the
    first update's result, as CPU tensors; the last iteration's training
    loss)."""
    from xvector_tpu_torch.models.convert import tree_leaves

    def leaves(name, parts):
        ckpt = torch.load(os.path.join(os.path.realpath(
            os.path.join(work, name)), "ckpt.pt"), map_location="cpu",
            weights_only=True)
        return [t for part in parts for t in tree_leaves(ckpt[part])]

    loss = [r["loss"] for r in read_metrics(work)
            if r.get("kind") == "train"][-1]
    return (leaves("model_final", ("params", "state")),
            leaves("model_1", ("params",)), loss)


def phase_multicard(TR, TA, kio, dev, seed, tag, tmp):
    """Phase 16: parts A-C (see the module docstring).  Returns the kernel
    launches of its multi-rank runs, summed over their ranks."""
    import shutil

    from xvector_tpu_torch.cli.run import _read_scp
    from xvector_tpu_torch.extract.extractor import (ExtractorConfig,
                                                     XvectorExtractor,
                                                     preprocess)
    from xvector_tpu_torch.models import tdnn as tt
    from xvector_tpu_torch.models.convert import tree_leaves
    from xvector_tpu_torch.train import checkpoints as C

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    multi = None if cards >= 2 else MR_GLOO_RANKS
    world = cards if multi is None else MR_GLOO_RANKS
    how = (f"{cards} NCCL ranks, one per card, started by the entry point"
           if multi is None else
           f"{world} gloo ranks sharing the call's one card through the "
           "launch variables")
    print(f"multicard: the call has {cards} card(s); multi-rank runs: {how}")
    launches = {"conv": {}, "k1": {}}

    def add(recs):
        for r in mr_ranks(recs).values():
            for key in ("conv", "k1"):
                for name, n in r[key].items():
                    launches[key][name] = launches[key].get(name, 0) + n

    # part A: cli.train_dnn, W ranks against 1, f32 then bf16 SGD
    egs = os.path.join(tmp, "mr_egs")
    os.makedirs(egs)
    for a in range(MR_ARCHIVES):
        write_train_archive(TA, os.path.join(egs, f"egs.{a}.xta"),
                            seed + 160 + a, 23, full=MR_MINIBATCHES,
                            ragged=False)
    _, p0, s0 = model(tt, "no_dropout", seed + 165, TRAIN_CLASSES, dev)
    src = os.path.join(tmp, "mr_model0")
    tr = TR.Trainer(mc_step_cfg(TR, seed, "float32"), src, device=dev)
    tr._place_all(p0, s0)
    C.save_iteration(tr, 0)
    init = [t.detach().cpu() for t in tree_leaves(tr.params)]
    del tr
    steps = MR_ARCHIVES * MR_MINIBATCHES
    local_rows = -(-TRAIN_B // world)        # padded to a multiple of W
    n = len(init)

    def update_cosines(a_leaves, b_leaves):
        """The cosine of two updates from ``init``: all parameters as one
        vector, and each leaf's."""
        da = [(a - w).double().flatten() for a, w in zip(a_leaves, init)]
        db = [(b - w).double().flatten() for b, w in zip(b_leaves, init)]
        return (float(F.cosine_similarity(torch.cat(da), torch.cat(db),
                                          dim=0)),
                {nm: float(F.cosine_similarity(u, v, dim=0))
                 for nm, u, v in zip(leaf_names(p0), da, db)})

    for dtype in ("float32", "bfloat16"):
        runs = {}
        for label, ranks in (("w", multi), ("one", 1)):
            work = os.path.join(tmp, f"mr_{dtype}_{label}")
            os.makedirs(work)
            shutil.copytree(C.iteration_path(src, 0),
                            C.iteration_path(work, 0))
            flags = ["--model=no_dropout", f"--num-targets={TRAIN_CLASSES}",
                     "--num-epochs=1", f"--compute-dtype={dtype}",
                     f"--egs-dir={egs}", f"--dir={work}", "--block-size=2",
                     f"--initial-effective-lrate={MR_LR}",
                     f"--final-effective-lrate={MR_LR}",
                     f"--device={dev.type}"]
            recs, secs = mr_run(
                "xvector_tpu_torch.cli.train_dnn", flags, work + "_out",
                ranks, tmp, SMOKE_SGD="1",
                **({"SMOKE_CHECK": "1"} if label == "w" else {}))
            runs[label] = (recs, secs) + mr_final(work)
        ((recs, secs, got, got1, loss),
         (one_recs, one_secs, want, want1, loss1)) = runs["w"], runs["one"]
        ranks_w = mr_ranks(recs)
        if len(ranks_w) != world:
            fail(f"multicard part A {dtype}: {len(ranks_w)} ranks reported, "
                 f"expected {world}")
        print(f"multicard part A cli.train_dnn {dtype} SGD, {world} ranks: "
              f"{secs:.1f} s (one rank {one_secs:.1f} s); final loss "
              f"{loss:.6f} vs one rank {loss1:.6f}; process start "
              + ", ".join(f"{ranks_w[r]['start_s']:.2f}"
                          for r in sorted(ranks_w)) + f" s [{tag}]")
        if dtype == "float32":
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            print(f"multicard part A f32 model_final, {world} ranks vs 1: "
                  f"max |diff| {err:.3g} (bound {MR_F32_BOUND})")
            if err > MR_F32_BOUND:
                fail("multicard part A: the f32 model_final of the ranks "
                     "differs from one rank's")
            exact1 = want1            # the exact first update (f32)
            continue
        # Two correct bf16 runs whose roundings differ anywhere part by up
        # to ~7% per leaf after one step, ranks or not: one process's bf16
        # update is itself that far from the exact f32 one on these inputs
        # (bench/bf16_ranks.py; phase 15's inputs happen to round alike on
        # 1 and 2 ranks).  So each leaf of the ranks' first update is held
        # against the exact one at TRAIN_COSINE_BOUND or, where one
        # process's bf16 update lies farther from it, at one process's
        # cosine squared (an angle up to ~sqrt(2) times one process's).
        cos, final = update_cosines(got[:n], want[:n])
        _, first = update_cosines(got1, want1)
        _, acc_w = update_cosines(got1, exact1)
        _, acc_1 = update_cosines(want1, exact1)
        bound = {nm: min(TRAIN_COSINE_BOUND, c * c)
                 for nm, c in acc_1.items()}
        worst = min(acc_w, key=lambda nm: acc_w[nm] - bound[nm])
        rel = abs(loss - loss1) / abs(loss1)
        print(f"multicard part A bf16, {world} ranks vs 1: final loss "
              f"relative {rel:.3g} (bound {TRAIN_LOSS_BOUND}); update cosine "
              f"{cos:.6f} (bound {TRAIN_COSINE_BOUND}), per leaf min "
              f"{min(final.values()):.4f} ({min(final, key=final.get)}); "
              f"first update per leaf min {min(first.values()):.4f} "
              f"({min(first, key=first.get)}), median "
              f"{statistics.median(first.values()):.4f}")
        print(f"multicard part A bf16 first update against the exact (f32) "
              f"one, per leaf: {world} ranks min {min(acc_w.values()):.4f} "
              f"({min(acc_w, key=acc_w.get)}), median "
              f"{statistics.median(acc_w.values()):.4f}; one process min "
              f"{min(acc_1.values()):.4f} ({min(acc_1, key=acc_1.get)}), "
              f"median {statistics.median(acc_1.values()):.4f}; closest to "
              f"its bound: {worst} {acc_w[worst]:.4f} (bound "
              f"{bound[worst]:.4f})")
        if (rel > TRAIN_LOSS_BOUND or cos < TRAIN_COSINE_BOUND
                or acc_w[worst] < bound[worst]):
            fail("multicard part A: the bf16 run of the ranks differs from "
                 "one rank's")
        want_calls = {f"{k}_{d}": 2 * steps if d == "sm90" else 0
                      for k in ("fwd", "dw", "dx") for d in ("sm90", "sm80")}
        for r in sorted(ranks_w):
            print(f"multicard part A rank {r}: K2-K4 calls "
                  f"{ranks_w[r]['conv']} at {ranks_w[r]['shapes']}")
            if ranks_w[r]["conv"] != want_calls:
                fail(f"multicard part A rank {r}: K2-K4 calls are not "
                     f"{want_calls}")
            if ranks_w[r]["shapes"] != [[local_rows, TRAIN_T]]:
                fail(f"multicard part A rank {r}: K2 ran at "
                     f"{ranks_w[r]['shapes']}, not {local_rows}x{TRAIN_T}")
        mr_check_convs("part A", ranks_w)
        add(recs)

    # part B: cli.run on the ranks against one process
    base = [f"--synthetic-speakers={RECIPE_CLI_SPEAKERS}",
            f"--synthetic-utts={RECIPE_CLI_UTTS}", "--model=no_dropout",
            f"--device={dev.type}"]
    step = 1.0 / (RECIPE_CLI_SPEAKERS * RECIPE_CLI_UTTS // 2)
    b_runs = [("one", 1, {})]
    if multi is None:
        b_runs.append((f"{cards} NCCL", None, {}))
        if cards > MR_PAD_RANKS:
            b_runs.append((f"{MR_PAD_RANKS} NCCL", None, {
                "CUDA_VISIBLE_DEVICES": ",".join(
                    str(i) for i in range(MR_PAD_RANKS))}))
    else:
        b_runs.append((f"{MR_PAD_RANKS} gloo", MR_PAD_RANKS, {}))
    results = {}
    for label, ranks, extra in b_runs:
        work = os.path.join(tmp, f"mr_run_{label.replace(' ', '_')}")
        recs, secs = mr_run("xvector_tpu_torch.cli.run",
                            [f"--work-dir={work}", *base], work + "_out",
                            ranks, tmp, SMOKE_CHECK="1", **extra)
        trained = mr_ranks(recs)
        top = recs.get("0") or recs["main"]
        res = top["result"]
        results[label] = res
        print(f"multicard part B cli.run, {label} rank(s) ({len(trained)} "
              f"reported): {secs:.1f} s, EER {res['eer']:.4f} "
              f"({res['num_trials']} trials); K1 on rank 0 {top['k1']}; "
              f"K2-K4 per rank {[trained[r]['conv'] for r in sorted(trained)]}"
              f" [{tag}]")
        k1 = top["k1"]
        if not k1_by_rule(k1):
            fail(f"multicard part B {label}: rank 0 did not extract through "
                 "K1 by the rule")
        for r in trained.values():
            c = r["conv"]
            if not c["fwd_sm90"] == c["dw_sm90"] == c["dx_sm90"] > 0:
                fail(f"multicard part B {label}: a rank did not train "
                     "through K2-K4")
            if r is not top and sum(r["k1"].values()):
                fail(f"multicard part B {label}: a rank other than 0 "
                     "extracted")
        mr_check_convs(f"part B {label}", trained)
        if label == "one":
            continue
        add(recs)
        gap = abs(res["eer"] - results["one"]["eer"])
        print(f"multicard part B {label}: EER {res['eer']:.4f} vs one rank "
              f"{results['one']['eer']:.4f} (bound one target trial, "
              f"{step:.4f})")
        if gap > step + 1e-9:
            fail(f"multicard part B {label}: the EER moved by more than "
                 "one trial")
        # rank 0's K1 x-vectors against the unfused stack on its inputs
        ckpt = torch.load(os.path.join(os.path.realpath(os.path.join(
            work, "exp", "model_final")), "ckpt.pt"), map_location=dev,
            weights_only=True)
        cfg = tt.MODEL_ZOO["no_dropout"]
        feats = _read_scp(os.path.join(work, "feats_all.ark.scp"))
        vads = _read_scp(os.path.join(work, "vad_all.ark.scp"))
        xv = dict(kio.read_vec_flt_scp(os.path.join(work,
                                                    "xvector_all.scp")))
        utts = sorted(xv)[:16]
        ex = XvectorExtractor(cfg, ckpt["params"], ckpt["state"],
                              ExtractorConfig(min_chunk=25, max_chunk=400,
                                              batch_size=8,
                                              compute_dtype="bfloat16",
                                              use_fused=False), device=dev)
        plain = ex.extract([(u, preprocess(
            kio.read_mat(feats[u]), 300, kio.read_vec_flt(vads[u]),
            device=dev)) for u in utts])
        cos = min(cosine(xv[u], plain[u]) for u in utts)
        print(f"multicard part B {label}: rank 0's K1 x-vectors vs the "
              f"unfused bf16 stack on {len(utts)} utterances: cosine min "
              f"{cos:.6f} (bound {COSINE_BOUND})")
        if cos < COSINE_BOUND:
            fail(f"multicard part B {label}: rank 0's K1 x-vectors differ "
                 "from the unfused stack")

    # part C: the NCCL run measured end to end
    if multi is not None:
        print(f"multicard part C: not run: the call has {cards} card, and "
              "NCCL takes one card per rank")
    else:
        egs = os.path.join(tmp, "mr_timing_egs")
        os.makedirs(egs)
        for a in range(MR_TIMING_ARCHIVES):
            write_train_archive(TA, os.path.join(egs, f"egs.{a}.xta"),
                                seed + 170 + a, 23, full=MR_TIMING_FULL,
                                ragged=False)
        timing = {}
        for label, ranks in ((f"{cards} cards", None), ("one card", 1)):
            work = os.path.join(tmp, f"mr_timing_{label.replace(' ', '_')}")
            flags = ["--model=no_dropout", f"--num-targets={TRAIN_CLASSES}",
                     "--num-epochs=1", f"--egs-dir={egs}", f"--dir={work}",
                     f"--device={dev.type}"]
            recs, secs = mr_run("xvector_tpu_torch.cli.train_dnn", flags,
                                work + "_out", ranks, tmp,
                                SMOKE_PROFILE_IT="2")
            it1 = [r for r in read_metrics(work)
                   if r.get("kind") == "train" and r["iteration"] == 1][0]
            ms = it1["seconds"] / it1["minibatches"] * 1e3
            timing[label] = ms
            trained = mr_ranks(recs)
            for r in sorted(trained):
                p = trained[r]["profile"]
                print(f"timing multicard {label} rank {r}: profiled "
                      f"iteration {p['wall_ms']:.2f} ms per minibatch, "
                      f"device busy {p['busy_ms']:.2f} ms = "
                      f"{1 - p['busy_ms'] / p['wall_ms']:.1%} idle; NCCL "
                      f"kernels {p['nccl_ms']:.3f} ms per minibatch "
                      f"({p['nccl_kernels']} kernels, largest "
                      f"{p['nccl_largest_ms']:.3f} ms = "
                      f"{p['nccl_largest_ms'] / p['wall_ms']:.1%} of the "
                      f"step); process start {trained[r]['start_s']:.2f} s "
                      f"[{tag}, {cards} cards]")
            if ranks is None:
                add(recs)
            print(f"timing multicard cli.train_dnn bf16 Adam {label}: "
                  f"{ms:.2f} ms per global 64x304 minibatch (iteration 1, "
                  f"{it1['minibatches']} minibatches, "
                  f"{TRAIN_B * TRAIN_T / FRAMES_PER_SECOND / ms * 1e3:.1f} "
                  f"audio-s/s); run {secs:.1f} s [{tag}, {cards} cards]")
        many = timing[f"{cards} cards"]
        print(f"timing multicard: {cards} cards {many:.2f} ms against one "
              f"card {timing['one card']:.2f} ms per global minibatch "
              f"({timing['one card'] / many:.2f}x) [{tag}, {cards} cards]")
    print(f"multicard: phase 16 took {time.perf_counter() - t_phase:.1f} s")
    return launches



# ---------------------------------------------------------------------------
# phase 17: the measurement tooling
# ---------------------------------------------------------------------------

BENCH_SWEEP_RUNS = (2, 5)     # extract_sweep: rounds, calls per round
BENCH_STEP_RUNS = (2, 1)      # dense and adam_mu: rounds, blocks per round
SCALE_SPEAKERS = (16, 8, 4)   # scale_sre16: training, SRE pool, evaluation
SCALE_UTTS = 8                # utterances per speaker (the tool's)
SCALE_REPEATS = 20            # of the tool's 35 (phase 14's cut), for time
SCALE_FRAMES_PER_ITER = 2.5e5  # 11 archives: 22 iterations


def phase_bench(CB, TK, dev, seed, tag, tmp):
    """Phase 17: the bench modules on the card, short runs (see the
    module docstring).  Returns the K1 and K2-K4 launches of the phase."""
    from xvector_tpu_torch.bench import adam_mu, dense, extract_sweep
    from xvector_tpu_torch.bench import headline as H
    from xvector_tpu_torch.bench import scale_sre16

    t_phase = time.perf_counter()
    shapes, conv_fwd = set(), CB.conv_fwd

    def recorded(x, w, dilation, **kw):
        # (rows, frames, k, Cin, Cout, dilation) of each K2 call
        shapes.add((*x.shape[:2], *w.shape, dilation))
        return conv_fwd(x, w, dilation, **kw)

    CB.conv_fwd = recorded
    zero_counts(CB, TK)
    try:
        t0 = time.perf_counter()
        head = H.run(seed, quick=True, device=dev, tag=tag)
        print(f"timing bench headline --quick: {time.perf_counter() - t0:.1f}"
              f" s [{tag}]")
        t0 = time.perf_counter()
        rows = extract_sweep.sweep(*BENCH_SWEEP_RUNS, device=dev, seed=seed,
                                   tag=tag)["rows"]
        print(f"timing bench extract_sweep: {len(rows)} shapes in "
              f"{time.perf_counter() - t0:.1f} s [{tag}]")
        steps = {}
        for name, mod in (("dense", dense), ("adam_mu", adam_mu)):
            t0 = time.perf_counter()
            steps[name] = mod.compare(*BENCH_STEP_RUNS, device=dev,
                                      seed=seed, tag=tag)
            print(f"timing bench {name}: {time.perf_counter() - t0:.1f} s, "
                  f"{json.dumps(steps[name])} [{tag}]")
        t0 = time.perf_counter()
        scale = scale_sre16.run_both(
            os.path.join(tmp, "scale"), *SCALE_SPEAKERS, SCALE_UTTS,
            SCALE_FRAMES_PER_ITER, tag=tag, num_repeats=SCALE_REPEATS,
            device=dev.type)
        print(f"timing bench scale_sre16 ({'+'.join(map(str, SCALE_SPEAKERS))}"
              f" speakers x {SCALE_UTTS}, {SCALE_REPEATS} repeats): "
              f"{time.perf_counter() - t0:.1f} s, materialised "
              f"{scale['materialised']['wall_s']:.1f} s, streamed "
              f"{scale['stream']['wall_s']:.1f} s [{tag}]")
    except H.CheckFailed as exc:
        fail(f"bench: {exc}")
    finally:
        CB.conv_fwd = conv_fwd
    conv, k1 = dict(CB.route_launches), dict(TK.route_launches)
    if not (k1["sm90"] and k1["l0_sm90"] and not k1["sm80"] and all(
            conv[f"{k}_sm90"] for k in ("fwd", "dw", "dx"))):
        fail(f"bench: a kernel was not launched: K1 {k1}, K2-K4 {conv}")
    bench_conv_checks(CB, dev, shapes)
    print(json.dumps({"bench_headline": {k: head[k] for k in H.KEYS},
                      "device": tag}))
    print(f"bench: phase 17 took {time.perf_counter() - t_phase:.1f} s, "
          f"launches K1 {k1}, K2-K4 {conv}")
    return {"conv": conv, "k1": k1}


def bench_conv_checks(CB, dev, shapes):
    """K2, K3 and K4 against their plain versions at every (rows, frames,
    k, Cin, Cout, dilation) that phase 17's K2 ran at (the E-TDNN's
    dilated layers and the scale runs' chunk lengths among them); a
    kernel past ``KERNEL_BOUND`` (``DW_BOUND`` for K3) at any of them
    fails the phase.  Its launches come after the phase's counts were
    read."""
    if not shapes:
        fail("bench: K2 ran at no shape")
    t0 = time.perf_counter()
    groups = {}
    for b, t, k, cin, cout, d in sorted(shapes):
        groups.setdefault((b, t, cin, cout), []).append((k, d))
    worst, where = {"K2": 0.0, "K3": 0.0, "K4": 0.0}, {}
    for (b, t, cin, cout), taps in sorted(groups.items()):
        errs = mr_conv_check(CB, dev, b, t, taps, cin, cout)
        for name, e in errs.items():
            if name not in where or not e <= worst[name]:
                worst[name], where[name] = e, f"{b}x{t} {cin}->{cout} {taps}"
    print(f"bench: K2-K4 against the plain versions at the phase's "
          f"{len(shapes)} K2 shapes ({len(groups)} rows x frames x "
          f"channels; k, d in {sorted({(k, d) for _, _, k, _, _, d in shapes})}"
          f") in {time.perf_counter() - t0:.1f} s: worst "
          + ", ".join(f"{n} {e:.3g} at {where.get(n)}"
                      for n, e in worst.items())
          + f" (bounds {KERNEL_BOUND}, K3 {DW_BOUND})")
    if (not worst["K2"] <= KERNEL_BOUND or not worst["K4"] <= KERNEL_BOUND
            or not worst["K3"] <= DW_BOUND):
        fail("bench: a kernel disagrees with its plain version at a shape "
             "of phase 17")


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
    from xvector_tpu_torch.runtime import native
    from xvector_tpu_torch.ops import conv_bwd as CB
    from xvector_tpu_torch.ops import features as FE
    from xvector_tpu_torch.ops import tdnn_kernel as TK
    from xvector_tpu_torch.train import schedules
    from xvector_tpu_torch.train import trainer as TR

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    # phases 1-15 drive one card, also on a call with several: the entry
    # points they call in this process are one process each
    os.environ["XVEC_NUM_PROCESSES"] = "1"
    card = card_line()
    print(card)   # exactly as nvidia-smi gives it
    tag = card

    # 2. build every kernel source, all nvcc processes started together,
    # and the host data plane (libxta, g++) beside them
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        libxta = pool.submit(native.available)
        logs = _build.build()
        if not libxta.result():
            fail("build: libxta is unavailable (no C++ compiler found)")
    print(f"build: {time.perf_counter() - t0:.2f} s for {sorted(logs)} and "
          f"{os.path.relpath(native.lib_path(native._compiler()), REPO)} "
          f"({native.threads()} materialisation threads)")
    for src, text in logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "warning")):
                print(f"build {src}: {line.strip()}")

    # 3. K1 against its plain version, then sliding CMVN's kernel
    errs = phase_kernel_checks(tt, TK, dev, args.seed)
    cmvn = phase_cmvn(FE, TE, dev, args.seed, tag)

    # 4. the serving path
    _, main_routes, cmvn_launches = phase_serving(tt, TE, TK, FE, kio, dev,
                                                  args.seed, tag)

    # 5. the serving metric at 32x1024, then K1 at the same shape
    phase_batch_timing(tt, TE, dev, args.seed, tag)
    phase_profile(tt, TE, dev, args.seed, tag)
    k1 = phase_k1_timing(tt, TK, dev, args.seed, tag)
    k1_etdnn = phase_k1_timing(tt, TK, dev, args.seed, tag, "etdnn")
    k1_l0 = phase_k1_layer0_timing(tt, TK, dev, args.seed, tag)

    # 6. K2, K3 and K4 against their plain versions
    conv_errs = phase_conv_checks(CB, dev, args.seed)

    # 7. the training path, then 8. its timings
    with tempfile.TemporaryDirectory() as tmp:
        _, routes = phase_training(TR, TA, CB, schedules, dev, args.seed,
                                   tag, tmp)
        phase_train_timing(TR, dev, args.seed, tag, tmp)

    # 9. the train -> checkpoint -> extract lifecycle through the CLIs,
    # then 10. the attention and AM-softmax presets
    with tempfile.TemporaryDirectory() as tmp:
        cli_routes, cli_k1, cli_paths = phase_cli(TR, TA, CB, TK, kio, dev,
                                                  args.seed, tag, tmp)
        phase_reference_h5(TR, kio, dev, tag, tmp, cli_paths)
        phase_presets(TR, CB, TK, TE, dev, args.seed, tag, tmp)
    conv = phase_conv_timing(CB, dev, args.seed, tag)

    # 11. the wave front end: wav.scp -> WaveExtractor (K1) -> ark, its
    # checks, then its timings
    with tempfile.TemporaryDirectory() as tmp:
        wave_routes, waves, mdl, files, wave_ark = phase_wave(
            tt, TE, CB, TK, kio, dev, args.seed, tag, tmp)
        phase_wave_timing(tt, TE, TK, dev, tag, waves, mdl, files)

        # 12. the scoring back end at SRE16 evaluation size, scoring also
        # phase 11's x-vectors
        phase_backend(CB, TK, dev, args.seed, tag, tmp, wave_ark)

    # 13. the recipe at full width: augment -> features -> egs -> train ->
    # extract -> score, then cli.run and cli.get_egs
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        recipe_routes, recipe_k1 = phase_recipe(CB, TK, TA, kio, dev,
                                                args.seed, tag, tmp)
    print(f"recipe: phase 13 took {time.perf_counter() - t0:.1f} s")

    # 14. the SRE16 recipe (cli/run_sre16.py) on a synthetic LDC tree
    with tempfile.TemporaryDirectory() as tmp:
        sre16_routes, sre16_k1 = phase_sre16(CB, TK, kio, dev, args.seed,
                                             tag, tmp)

    # 15. the multi-rank paths: several ranks on the one card
    with tempfile.TemporaryDirectory() as tmp:
        mc = phase_mc(TR, TA, CB, TK, dev, args.seed, tag, tmp)

    # 16. the entry points on every card of the call
    with tempfile.TemporaryDirectory() as tmp:
        multicard = phase_multicard(TR, TA, kio, dev, args.seed, tag, tmp)
    # 17. the measurement tooling: bench/ on the card, short runs
    with tempfile.TemporaryDirectory() as tmp:
        bench = phase_bench(CB, TK, dev, args.seed, tag, tmp)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from the device "
          f"check to here")

    # K1: the main path runs layer 0 on its Hopper kernel and layers 1-4 on
    # v5, no layer on v4.  Rows: the stack by the rule ("ms": its layer
    # kernels per call, profiled; launches: v5's), layer 0's kernel alone
    # ("ms": its profiled time in the stack; launches: its own), and v4
    # ("ms": v4 on every layer; launches 0 on every path, its forced ones
    # apart).  Per-path launches count each row's own design.
    kernels = []
    for key, label, source, design in (
            ("rule", "tdnn_frame_stack", "fwd_sm90.cu", "sm90"),
            ("l0", "tdnn_layer0_sm90", "fwd_sm90.cu", "l0_sm90"),
            ("sm80", "tdnn_frame_stack_sm80", "tdnn_stack.cu", "sm80")):
        if key == "l0":
            ms_bound, by = k1["layer_bounds"][0]
            times = {"ms": (k1["rule"]["layers_us"][0] / 1e3
                            if k1["rule"]["layers_us"] else None),
                     "plain_ms": k1["layer_plain_ms"][0],
                     "bound_ms": ms_bound, "bound_by": by}
            err = errs[("no_dropout", 23, "layer", 0)]
        else:
            times = {m: k1[key][m] for m in ("ms", "plain_ms", "bound_ms",
                                             "bound_by")}
            err = errs[("no_dropout", 32, 1024,
                        None if key == "rule" else "sm80")]
        kernels.append({
            "name": label,
            "route": "cuda",
            "source": f"xvector_tpu_torch/csrc/{source}",
            "replaces": "xvector_tpu/ops/tdnn_kernel.py:99",
            "launches": main_routes[design],
            "max_abs_err": err,
            **times,
            # no single PyTorch call computes a TDNN layer (conv, bias,
            # activation, batch norm, mask); F.conv1d is the yardstick
            "library_ms": None,
            "shapes": "no_dropout 32x1024"
                      + (" layer 0" if key == "l0" else
                         " (ms: the layer kernels per call)"),
            # the layer launches of its design over extract_embedding's run
            "cli_launches": cli_k1[design],
            # ... and over the wave path's main run (phase 11)
            "wave_launches": wave_routes[design],
            # ... and over the recipe's two extraction stages (phase 13)
            "recipe_launches": recipe_k1[design],
            # ... and over run_sre16's two runs (phase 14: the waveform
            # route and the feature-ark route)
            "sre16_launches": sre16_k1[design],
            # ... and over the multi-rank run's utterance-sharded
            # extraction (phase 15 part 1, summed over its ranks)
            "mc_launches": mc["k1"].get(design, 0),
            # ... and over phase 16's multi-rank runs of cli.run (rank 0's
            # extraction)
            "multicard_launches": multicard["k1"].get(design, 0),
            # ... and over phase 17's bench runs (the headline's and the
            # sweep's extraction)
            "bench_launches": bench["k1"][design],
            **({"wrapper_ms": k1[key]["wrapper_ms"],
                "layers_us": k1[key]["layers_us"],
                "etdnn_ms": k1_etdnn[key]["ms"],
                "etdnn_layers_us": k1_etdnn[key]["layers_us"]}
               if key != "l0" else
               {"conv1d_ms": k1["conv_ms"][0],
                "alone_ms": k1_l0[23]["ms"], "alone_v4_ms": k1_l0[23]["v4_ms"],
                "feat40": {"max_abs_err": errs[("no_dropout", 40, "layer", 0)],
                           **k1_l0[40]}}),
            **({"launches_by_design": main_routes,
                "etdnn_last_layer": {
                    "max_abs_err": errs[("etdnn", 23, "layer", 9)],
                    "ms": (k1_etdnn["rule"]["layers_us"][9] / 1e3
                           if k1_etdnn["rule"]["layers_us"] else None),
                    "plain_ms": k1_etdnn["layer_plain_ms"][9],
                    "bound_ms": k1_etdnn["layer_bounds"][9][0],
                    "bound_by": k1_etdnn["layer_bounds"][9][1],
                    "conv1d_ms": k1_etdnn["conv_ms"][9]},
                "fold_ms": k1["fold_ms"]} if key == "rule" else {}),
            **({"forced_launches": k1["forced_v4_launches"]
                + k1_etdnn["forced_v4_launches"]} if key == "sm80" else {}),
        })
    # K2-K4: the main path makes one k=5 and one k=7 call of each per
    # step, so each time below is the mean of the two per-call times.
    # The sm90 designs are the main path's; the sm80 designs stay for
    # channel counts off 8 (0 main-path launches).
    for key, label, source, line in (
            ("fwd", "conv_fwd", "fwd_sm90.cu", 114),
            ("dw", "conv_dw", "conv_sm90.cu", 174),
            ("dx", "conv_dx", "conv_sm90.cu", 201),
            ("fwd_sm80", "conv_fwd_sm80", "conv_bwd.cu", 114),
            ("dw_sm80", "conv_dw_sm80", "conv_bwd.cu", 174),
            ("dx_sm80", "conv_dx_sm80", "conv_bwd.cu", 201)):
        per_k = [conv[(key, k)] for k in (5, 7)]
        mean = {m: sum(c[m] for c in per_k) / 2
                for m in ("ms", "plain_ms", "bound_ms", "library_ms")}
        route = key if "_" in key else f"{key}_sm90"
        kernels.append({
            "name": label,
            "route": "cuda",
            "source": f"xvector_tpu_torch/csrc/{source}",
            "replaces": f"xvector_tpu/ops/conv_bwd.py:{line}",
            "launches": routes[route],
            # its calls over train_dnn's run (6 iterations, combination)
            "cli_launches": cli_routes[route],
            # ... and over the recipe's training stage (phase 13)
            "recipe_launches": recipe_routes[route],
            # ... and over run_sre16's training (phase 14, run 1)
            "sre16_launches": sre16_routes[route],
            # ... and over the multi-rank run's training (phase 15 part 1,
            # the straight run, summed over its ranks)
            "mc_launches": mc["conv"].get(route, 0),
            # ... and over phase 16's multi-rank runs of the entry points
            # (training, summed over their ranks)
            "multicard_launches": multicard["conv"].get(route, 0),
            # ... and over phase 17's bench runs (the training benches and
            # both scale runs)
            "bench_launches": bench["conv"][route],
            "max_abs_err": conv_errs[key],
            **mean,
            "bound_by": per_k[0]["bound_by"],
            "shapes": "64x304, 512->512, k=5 and k=7 (mean per call)",
        })
    # sliding CMVN: replaces no TPU kernel (the JAX package takes its
    # window sums with lax.reduce_window); without a map it serves
    # preprocess without a VAD, which phase 4 does not call
    kernels.append({
        "name": "sliding_cmvn",
        "route": "cuda",
        "source": "xvector_tpu_torch/csrc/cmvn_sm90.cu",
        "replaces": None,
        "launches": None,
        **cmvn[CMVN_SHAPES[0]],
        # no single PyTorch call computes it
        "library_ms": None,
        "shapes": "8526x23, window 300, centred",
        "t30000": cmvn[CMVN_SHAPES[1]],
    })
    # ... with a VAD's destination map, CMVN and voiced-frame selection in
    # one launch: one a preprocess call on the card (phase 4's calls)
    kernels.append({
        "name": "sliding_cmvn_select",
        "route": "cuda",
        "source": "xvector_tpu_torch/csrc/cmvn_sm90.cu",
        "replaces": None,
        "launches": cmvn_launches,
        **cmvn[("select",) + CMVN_SHAPES[0]],
        "library_ms": None,
        "shapes": "8526x23, window 300, centred, ~74% of frames voiced",
        "t30000": cmvn[("select",) + CMVN_SHAPES[1]],
    })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
