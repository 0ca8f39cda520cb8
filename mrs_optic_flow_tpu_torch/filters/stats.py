"""A-posteriori precision statistics (``analyzeSpeeds``,
``src/utilityFunctions.cpp:291-344``); a copy of
:mod:`mrs_optic_flow_tpu.filters.stats`, whose package imports JAX.

The reference keeps a rolling window of (flow speed, odometry speed) sample
pairs and reports mean/stddev of their disagreement over the last
``analyze_duration`` seconds (``config/default.yaml:52``) — the data source
for the ``velocity_stddev_out`` diagnostic topic
(``src/optic_flow.cpp:1040``).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class SpeedBox:
    """One sample (``include/utilityFunctions.h`` SpeedBox struct)."""

    time: float
    speed: np.ndarray  # [2] measured flow velocity
    odometry_speed: np.ndarray  # [2] reference velocity


@dataclasses.dataclass
class StatData:
    mean: float
    std_dev: float
    num: int
    mean_x: float
    std_dev_x: float
    mean_y: float
    std_dev_y: float


def analyze_speeds(from_time: float, speeds: List[SpeedBox]) -> StatData:
    """Error statistics vs odometry over samples newer than ``from_time``.

    Matches the accumulation of ``src/utilityFunctions.cpp:291-344``:
    euclidean error mean/std plus per-axis absolute-difference stats
    (E[X^2] - E[X]^2 form, including its NaN-when-empty behaviour) — except
    that the variance cancellation for near-constant samples clamps to 0
    instead of propagating sqrt(-eps) = NaN (ARCHITECTURE.md deviation 8).
    """
    sel = [s for s in speeds if s.time > from_time]
    n = len(sel)
    if n == 0:
        nan = float("nan")
        return StatData(nan, nan, 0, nan, nan, nan, nan)
    d = np.stack([np.asarray(s.odometry_speed) - np.asarray(s.speed) for s in sel])
    dist_sq = np.sum(d**2, axis=1)
    dist = np.sqrt(dist_sq)
    ax = np.abs(d)
    exx = dist_sq.mean()
    ex = dist.mean()

    def _std(e2, e):
        # E[X^2] - E[X]^2 cancels to a tiny negative for near-constant
        # samples; clamp instead of emitting NaN + a RuntimeWarning
        return float(np.sqrt(max(e2 - e * e, 0.0)))

    return StatData(
        mean=float(ex),
        std_dev=_std(exx, ex),
        num=n,
        mean_x=float(ax[:, 0].mean()),
        std_dev_x=_std((ax[:, 0] ** 2).mean(), ax[:, 0].mean()),
        mean_y=float(ax[:, 1].mean()),
        std_dev_y=_std((ax[:, 1] ** 2).mean(), ax[:, 1].mean()),
    )
