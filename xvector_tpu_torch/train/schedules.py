"""Training schedules: effective learning rate, dropout, proportional shrink.

Own copy of ``xvector_tpu/train/schedules.py`` (pure Python, no tensors):
the reference scheduler math (``ze_utils.py:111-120`` exponential
effective-LR decay scaled by job count; ``ze_utils.py:310-443``
piecewise-linear dropout schedule; ``train_dnn.py:531-535`` proportional
shrink) as functions of training progress.  Proportional shrink is applied
as a post-update parameter scale only when ``TrainConfig.apply_shrink`` is
set (the reference parses it but never applies it).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

__all__ = [
    "learning_rate",
    "parse_dropout_schedule",
    "dropout_proportion",
    "shrink_value",
]


def learning_rate(num_archives_processed: int, num_archives_to_process: int,
                  initial_effective_lrate: float,
                  final_effective_lrate: float,
                  num_jobs: int = 1, is_final_iter: bool = False) -> float:
    """Exponential decay in archives-processed, ×num_jobs
    (ze_utils.py:111-120)."""
    if is_final_iter:
        return num_jobs * final_effective_lrate
    return num_jobs * initial_effective_lrate * math.exp(
        num_archives_processed
        * math.log(final_effective_lrate / initial_effective_lrate)
        / num_archives_to_process)


def parse_dropout_schedule(schedule: str) -> List[Tuple[float, float]]:
    """Parse ``'0,0@0.10,0.1@0.50,0'`` → [(fraction, proportion), ...]
    ascending, with implicit endpoints at fractions 0.0 and 1.0."""
    if not schedule:
        return []
    parts = schedule.split(",")
    points: List[Tuple[float, float]] = []
    for i, part in enumerate(parts):
        if "@" in part and 0 < i < len(parts) - 1:
            value, frac = part.split("@")
            points.append((float(frac), float(value)))
        elif i == 0:
            points.append((0.0, float(part)))
        elif i == len(parts) - 1:
            points.append((1.0, float(part)))
        else:
            # bare interior entry = proportion at half of training
            # (ze_utils.py:391-397)
            points.append((0.5, float(part)))
    fracs = [f for f, _ in points]
    if fracs != sorted(fracs):
        raise ValueError(
            f"dropout schedule fractions not ascending: {schedule}")
    return points


def dropout_proportion(points: Sequence[Tuple[float, float]],
                       data_fraction: float) -> float:
    """Piecewise-linear interpolation of the parsed schedule at
    ``data_fraction`` ∈ [0, 1]."""
    if not points:
        return 0.0
    if data_fraction <= points[0][0]:
        return points[0][1]
    # Half-open segments [f0, f1): at an exactly-duplicated breakpoint the
    # value of the LATER-listed entry wins, matching the reference's
    # descending-order lower-bound search (ze_utils.py:330-343: the first
    # descending tuple with fraction <= data_fraction is the later
    # ascending duplicate, interpolated at t=0).
    for (f0, v0), (f1, v1) in zip(points, points[1:]):
        if data_fraction < f1 and f1 > f0:
            # expression order matches ze_utils.py:358-361 bit for bit
            return (data_fraction - f0) * (v1 - v0) / (f1 - f0) + v0
    return points[-1][1]


def shrink_value(proportional_shrink: float, lrate: float) -> float:
    """1 − proportional_shrink·lrate (train_dnn.py:531-535); must stay
    > 0.5 or the schedule is mis-configured."""
    shrink = 1.0 - proportional_shrink * lrate
    if shrink <= 0.5:
        raise ValueError(
            f"shrink-value {shrink} <= 0.5: proportional-shrink "
            f"{proportional_shrink} is too large for lrate {lrate}")
    return shrink
