"""Verification metrics: EER and minDCF.

Own copy of ``xvector_tpu/backend/metrics.py`` (numpy only).  Replaces
Kaldi ``compute-eer`` (run.sh:291-293) and adds the minDCF (NIST SRE
definition) that the reference never computes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["eer", "min_dcf", "roc_points"]


def roc_points(scores: np.ndarray, labels: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sweep thresholds (descending score); return (thresholds, FAR, FRR).

    labels: 1 = target (same speaker), 0 = nontarget.
    """
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels)
    order = np.argsort(-scores, kind="stable")
    s = scores[order]
    l = labels[order]
    n_tgt = max(int(l.sum()), 1)
    n_non = max(int((1 - l).sum()), 1)
    # accepting the top k trials: false accepts among them / misses below
    fa = np.cumsum(1 - l) / n_non          # FAR after accepting k-th
    fr = 1.0 - np.cumsum(l) / n_tgt        # FRR after accepting k-th
    thresholds = s
    # prepend the "reject everything" operating point
    return (np.concatenate([[np.inf], thresholds]),
            np.concatenate([[0.0], fa]),
            np.concatenate([[1.0], fr]))


def eer(scores: np.ndarray, labels: np.ndarray) -> float:
    """Equal error rate (Kaldi compute-eer semantics: the FAR at the first
    operating point where FAR >= FRR)."""
    _, far, frr = roc_points(scores, labels)
    idx = np.argmax(far >= frr)
    # linear interpolation between the crossing's neighbours
    if idx == 0:
        return float(far[0])
    x1, x2 = far[idx - 1] - frr[idx - 1], far[idx] - frr[idx]
    if x2 == x1:
        return float(far[idx])
    t = -x1 / (x2 - x1)
    return float(far[idx - 1] + t * (far[idx] - far[idx - 1]))


def min_dcf(scores: np.ndarray, labels: np.ndarray,
            p_target: float = 0.01, c_miss: float = 1.0,
            c_fa: float = 1.0) -> float:
    """Minimum normalized detection cost (NIST SRE definition)."""
    _, far, frr = roc_points(scores, labels)
    dcf = c_miss * frr * p_target + c_fa * far * (1.0 - p_target)
    floor = min(c_miss * p_target, c_fa * (1.0 - p_target))
    return float(dcf.min() / floor)
