"""Optimization objectives (Eq. 1-3 and the A.6 accuracy-constrained dual;
the port of ``repro/core/objective.py``).

    L_a(b) = f_a(V, b) + delta(L - f_l(V, c, b))            (Eq. 2)

delta is either the hard step (Eq. 3) or a soft linear penalty (Lagrange).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

NEG_INF = -np.inf


def hard_delta(x: float) -> float:
    """Eq. 3: -inf if the constraint is violated, else 0."""
    return NEG_INF if x < 0 else 0.0


def soft_delta(lam: float) -> Callable[[float], float]:
    """Linear (Lagrange-multiplier) activation; penalizes violation but
    does not reward slack (one-sided, as a constraint should be)."""
    def delta(x: float) -> float:
        return lam * min(x, 0.0)
    return delta


@dataclasses.dataclass(frozen=True)
class LatencyConstrainedObjective:
    """max f_a  s.t.  f_l <= L  (the paper's real-time setting)."""
    latency_budget: float
    delta: Callable[[float], float] = hard_delta

    def __call__(self, acc: float, lat: float) -> float:
        return acc + self.delta(self.latency_budget - lat)

    def feasible(self, lat: float) -> bool:
        return lat <= self.latency_budget


@dataclasses.dataclass(frozen=True)
class AccuracyConstrainedObjective:
    """A.6 dual: min f_l  s.t.  f_a >= A.  Returned as a value to MAXIMIZE
    (negated latency) so the same search code optimizes both forms."""
    accuracy_floor: float
    delta: Callable[[float], float] = hard_delta

    def __call__(self, acc: float, lat: float) -> float:
        return -lat + self.delta(acc - self.accuracy_floor)

    def feasible(self, acc: float) -> bool:
        return acc >= self.accuracy_floor
