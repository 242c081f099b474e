"""Benchmark configuration presets (BASELINE.json configs 1–5).

Own copy of ``xvector_tpu/presets.py``: each entry pairs a model topology
with training knobs; callers ``dataclasses.replace`` in their corpus
specifics (num_targets, egs paths).  ``sre16_full``'s sharded head needs a
mesh of several devices, which the port does not have yet: its
``Trainer`` raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict

from .train.trainer import TrainConfig

__all__ = ["BENCHMARK_CONFIGS"]

BENCHMARK_CONFIGS: Dict[str, TrainConfig] = {
    # 1 — Baseline Snyder 5-layer TDNN + stats pooling, 512-d x-vector,
    #     softmax head (the recipe default, run_xvector.sh:88-107)
    "baseline": TrainConfig(model="no_dropout", head="softmax"),

    # 2 — AM-softmax / angular-margin head + training tricks from
    #     Zeinali et al. (dropout schedule + SGD schedule)
    "am_softmax_tricks": TrainConfig(
        model="base", head="am_softmax", optimizer="sgd", momentum=0.9,
        dropout_schedule="0,0@0.10,0.1@0.50,0",
        apply_shrink=True, proportional_shrink=10.0),

    # 3 — Extended/dilated TDNN topology (ModelWithoutDropoutTdnn)
    "etdnn": TrainConfig(model="tdnn_dilated", head="softmax"),

    # 4 — Attention-based pooling replacing statistics pooling
    "attention": TrainConfig(model="l2_lrelu_attention", head="softmax"),

    # 5 — Full SRE16 scale: ~7k-speaker head sharded over the model axis
    "sre16_full": TrainConfig(model="no_dropout", head="sharded_softmax",
                              num_targets=7185),
}
