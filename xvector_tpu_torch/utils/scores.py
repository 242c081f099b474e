"""Score-file conversion + training report utilities.

Own copy of ``xvector_tpu/utils/scores.py`` (pure Python):

* :func:`kaldi_scores_to_nist_tsv` — the reference's
  ``convert_kaldi_score_file.py:53-101``: Kaldi trial score lines
  ``<model> <segment> <score>`` → NIST SRE18 submission tsv
  ``modelid segmentid side LLR``, with optional max-pooled merge of
  per-candidate diarisation scores.
* :func:`generate_report` — the reference's ``accuracy.report`` generator
  (``ze_utils.py:491-558``) rebuilt over structured metrics: it reads the
  trainer's ``metrics.jsonl`` and emits train/valid objective + accuracy
  per iteration and their difference.
* :func:`partition_trials` — trials grouped by the test segment's
  condition.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Tuple

__all__ = ["kaldi_scores_to_nist_tsv", "generate_report",
           "partition_trials"]


def partition_trials(trials: Iterable[Tuple[str, str, int]],
                     utt2cond: Dict[str, str]
                     ) -> Dict[str, List[Tuple[str, str, int]]]:
    """Group trials by the test segment's condition (the reference's
    per-language trial filters, ``run.sh:289-294,309-312``).  Trials whose
    test segment has no condition go under ``"unknown"``."""
    out: Dict[str, List[Tuple[str, str, int]]] = {}
    for enroll, test, label in trials:
        out.setdefault(utt2cond.get(test, "unknown"), []).append(
            (enroll, test, label))
    return out


def kaldi_scores_to_nist_tsv(
        score_lines: Iterable[str],
        side: str = "a",
        merge_candidates: bool = False) -> List[str]:
    """Convert ``<model> <segment> <score>`` lines to NIST tsv rows.

    ``merge_candidates=True`` max-pools scores whose segment ids carry a
    diarisation-candidate suffix ``<segment>-<k>``.
    """
    best: Dict[Tuple[str, str], float] = {}
    order: List[Tuple[str, str]] = []
    for line in score_lines:
        parts = line.split()
        if len(parts) != 3:
            continue
        model, segment, score = parts[0], parts[1], float(parts[2])
        if merge_candidates and "-" in segment:
            base, _, suffix = segment.rpartition("-")
            if suffix.isdigit():
                segment = base
        key = (model, segment)
        if key not in best:
            order.append(key)
            best[key] = score
        else:
            best[key] = max(best[key], score)
    out = ["modelid\tsegmentid\tside\tLLR"]
    for model, segment in order:
        out.append(f"{model}\t{segment}\t{side}\t{best[(model, segment)]:.6f}")
    return out


def generate_report(metrics_path: str) -> str:
    """Build the accuracy report from metrics.jsonl: per-iteration train /
    valid objectives and accuracies (ze_utils.py:531-558's TSV layout)."""
    rows: Dict[int, Dict[str, float]] = {}
    with open(metrics_path) as f:
        for line in f:
            rec = json.loads(line)
            it = int(rec.get("iteration", -1))
            if it < 0:
                continue
            row = rows.setdefault(it, {})
            kind = rec.get("kind", "train")
            if "loss" in rec:
                row[f"{kind}_loss"] = rec["loss"]
            if "accuracy" in rec:
                row[f"{kind}_accuracy"] = rec["accuracy"]
            if "lr" in rec:
                row["lr"] = rec["lr"]
            if "seconds" in rec:
                row["seconds"] = rec["seconds"]
    header = ["iter", "lr", "seconds", "train_loss", "valid_loss",
              "loss_diff", "train_accuracy", "valid_accuracy"]
    lines = ["\t".join(header)]
    for it in sorted(rows):
        r = rows[it]
        t_loss = r.get("train_loss")
        v_loss = r.get("valid_loss")
        diff = (t_loss - v_loss) if (t_loss is not None
                                     and v_loss is not None) else None

        def fmt(x):
            return f"{x:.4f}" if isinstance(x, float) else "-"

        lines.append("\t".join([
            str(it), fmt(r.get("lr")), fmt(r.get("seconds")),
            fmt(t_loss), fmt(v_loss), fmt(diff),
            fmt(r.get("train_accuracy")), fmt(r.get("valid_accuracy"))]))
    return "\n".join(lines) + "\n"
