"""Exact statistics from per-query stamps and device intervals."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def percentile(values: Sequence[float], pct: float) -> float:
    """The ``pct``-th percentile of every value, linear between the two
    nearest ranks (numpy's default), with no binning."""
    if not len(values):
        raise ValueError("percentile of no values")
    return float(np.percentile(np.asarray(values, np.float64), pct))


def merge(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of ``(start, end)`` intervals as sorted, disjoint ones
    (overlapping and touching intervals merge)."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def union_length(intervals: Sequence[Tuple[float, float]]) -> float:
    return float(sum(e - s for s, e in merge(intervals)))


def gaps(intervals: Sequence[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    out, t = [], lo
    for s, e in merge(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def flushes_of(spans) -> list:
    """One span a flush: the riders of a co-batch share its flush stamp
    and size."""
    out = {}
    for s in spans:
        out.setdefault((s.t_flush, s.batch_n), s)
    return list(out.values())
