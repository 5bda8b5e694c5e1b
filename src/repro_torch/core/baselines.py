"""Composer baselines (§4.2): RD, AF, LF, NPO (the port of
``repro/core/baselines.py``).

Each returns a ComposerResult so the benchmark harness treats every method
uniformly.  RD/AF/LF greedily grow an ensemble until it EXCEEDS the latency
budget (then back off one step), per the paper's descriptions.  NPO is the
non-parametric random-subset search of Snoek et al. as modified in §4.2.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional

import numpy as np

from repro_torch.core.composer import ComposerResult
from repro_torch.core.objective import LatencyConstrainedObjective


def _result(B, Ya, Yl, budget, calls, t0, history=None) -> ComposerResult:
    obj = LatencyConstrainedObjective(budget)
    values = np.asarray([obj(a, l) for a, l in zip(Ya, Yl)])
    j = int(np.argmax(values))
    feasible = bool(np.isfinite(values[j]))
    if not feasible:
        j = int(np.argmin(Yl))
    return ComposerResult(
        b_star=B[j].copy(), accuracy=float(Ya[j]), latency=float(Yl[j]),
        feasible=feasible, n_profiler_calls=calls,
        B=np.asarray(B), Y_acc=np.asarray(Ya), Y_lat=np.asarray(Yl),
        history=history or [], wall_seconds=time.time() - t0)


def _greedy(order: List[int], n: int, f_a, f_l, budget) -> ComposerResult:
    t0 = time.time()
    b = np.zeros(n, np.int8)
    B, Ya, Yl, hist = [], [], [], []
    calls = 0
    for idx in order:
        cand = b.copy()
        cand[idx] = 1
        acc, lat = f_a(cand), f_l(cand)
        calls = len(B) + 1
        B.append(cand)
        Ya.append(acc)
        Yl.append(lat)
        hist.append({"iteration": len(B) - 1, "profiler_calls": len(B),
                     "best_acc": acc, "best_lat": lat,
                     "new_acc": acc, "new_lat": lat})
        if lat > budget:
            break                      # paper: stop once budget exceeded
        b = cand
    return _result(B, Ya, Yl, budget, calls, t0, hist)


def random_baseline(n: int, f_a, f_l, budget, seed: int = 0
                    ) -> ComposerResult:
    """RD: random single model added iteratively, without replacement."""
    rng = np.random.default_rng(seed)
    order = list(rng.permutation(n))
    return _greedy(order, n, f_a, f_l, budget)


def accuracy_first(n: int, f_a, f_l, budget, single_acc: np.ndarray
                   ) -> ComposerResult:
    """AF: next most-accurate single model first."""
    order = list(np.argsort(-np.asarray(single_acc), kind="stable"))
    return _greedy(order, n, f_a, f_l, budget)


def latency_first(n: int, f_a, f_l, budget, single_lat: np.ndarray
                  ) -> ComposerResult:
    """LF: next lowest-latency single model first."""
    order = list(np.argsort(np.asarray(single_lat), kind="stable"))
    return _greedy(order, n, f_a, f_l, budget)


def npo(n: int, f_a, f_l, budget, max_subset: int, n_calls: int,
        seed: int = 0, warm_start: Optional[List[np.ndarray]] = None
        ) -> ComposerResult:
    """NPO (modified from Snoek et al. 2012): iteratively merge a random
    subset (size bounded by the LF ensemble size) into the current set,
    profiling each merged candidate, until the call budget N is spent."""
    t0 = time.time()
    rng = np.random.default_rng(seed)
    B, Ya, Yl, hist = [], [], [], []
    cur = np.zeros(n, np.int8)
    for b0 in (warm_start or []):
        b0 = np.asarray(b0, np.int8)
        B.append(b0)
        Ya.append(f_a(b0))
        Yl.append(f_l(b0))
    while len(B) < n_calls:
        size = int(rng.integers(1, max(2, max_subset + 1)))
        subset = rng.choice(n, size=size, replace=False)
        cand = cur.copy()
        cand[subset] = 1
        acc, lat = f_a(cand), f_l(cand)
        B.append(cand)
        Ya.append(acc)
        Yl.append(lat)
        if lat <= budget:
            cur = cand                 # keep growing only while feasible
        else:
            cur = np.zeros(n, np.int8)
        feas = np.asarray(Yl) <= budget
        best_acc = float(np.max(np.where(feas, np.asarray(Ya), -np.inf))) \
            if feas.any() else float("nan")
        hist.append({"iteration": len(B) - 1, "profiler_calls": len(B),
                     "best_acc": best_acc,
                     "best_lat": float(np.min(Yl)),
                     "new_acc": acc, "new_lat": lat})
    return _result(B, Ya, Yl, budget, len(B), t0, hist)
