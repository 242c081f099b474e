"""Tiny sizes of the benchmark's cells for CPU tests: the program's
``tiny`` preset, a few short archives, a small extraction pool."""

from __future__ import annotations

import copy
import tempfile
import time

import torch

from xvbench import harness

TINY = {"preset": "tiny", "feat_dim": 23, "kernel_sizes": [5, 5, 7, 1, 1],
        "dilations": [1, 1, 1, 1, 1], "channels": [32, 32, 32, 32, 96],
        "embed_dims": [64, 64], "activation": "relu", "pooling": "stats",
        "num_targets": 20,
        "train": {"compute_dtype": "bfloat16", "optimizer": "adam",
                  "lr": 1e-3, "block_size": 2},
        "extract": {"compute_dtype": "bfloat16", "batch_size": 4,
                    "min_chunk": 25, "max_chunk": 300, "cmvn_window": 300}}
TRAIN = {"driver": "train_egs", "ranks": 1, "archives": 3,
         "minibatches_per_archive": 4, "rows": 8,
         "chunk_lengths": [40, 48, 56], "check_blocks": 2,
         "trace_seconds": 0.3}
# Large enough that bf16 rounding reads well below the fp8 control and the
# faults by the training cells' own limits; the program's ``tiny`` preset is
# widened to it with :func:`widen_tiny`.
MEDIUM = dict(TINY, channels=[128, 128, 128, 128, 384],
              embed_dims=[128, 128], num_targets=200)
MEDIUM_TRAIN = dict(TRAIN, rows=32, chunk_lengths=[100, 120, 140])
EXTRACT = {"driver": "extract_feats", "utterances": 12, "min_frames": 100,
           "max_frames": 900, "speech_run": [50, 300],
           "silence_run": [20, 100], "check_utterances": 4,
           "trace_seconds": 0.3}


def widen_tiny(monkeypatch, cfg=MEDIUM):
    """Give the program's ``tiny`` preset ``cfg``'s widths."""
    from dataclasses import replace
    from xvector_tpu_torch.models import tdnn
    monkeypatch.setitem(tdnn.MODEL_ZOO, "tiny", replace(
        tdnn.MODEL_ZOO["tiny"], channels=tuple(cfg["channels"]),
        embed_dims=tuple(cfg["embed_dims"])))


def context(traffic, limits, seed=2**31 + 11, seconds=1.0, trace=False,
            cfg=TINY, tmp=None) -> harness.Context:
    per_layer = {"train_egs": ["train_window_audio_s_per_s",
                               "train_upload_wait_share",
                               "train_dispatch_ms", "train_mfu"],
                 "extract_feats": ["extract_preprocess_share",
                                   "extract_mfu"]}[traffic["driver"]]
    e2e, unit = {"train_egs": ("train_peak_memory_gb", "GB"),
                 "extract_feats": ("extract_audio_s_per_s", "audio-s/s")
                 }[traffic["driver"]]
    return harness.Context(
        workload="tiny", seed=seed, seconds=seconds, trace=trace,
        cell={"chips": 1}, cfg=copy.deepcopy(cfg),
        traffic=copy.deepcopy(traffic), limits=dict(limits),
        end_to_end=[{"name": "setup_s", "unit": "s"},
                    {"name": e2e, "unit": unit}],
        per_layer=[{"name": n, "unit": "%"} for n in per_layer],
        t_start=time.time(), device=torch.device("cpu"),
        work_dir=tmp or tempfile.mkdtemp(prefix="xvbench_test_"),
        owns_work_dir=tmp is None)
