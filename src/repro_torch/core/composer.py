"""Ensemble Composer (Algorithm 1): sequential model-based Bayesian
optimization with genetic exploration over binary ensemble selectors.
The port of ``repro/core/composer.py``: numpy only, the same draws in
the same order, so the same seed composes the same ensemble.

The profilers are injected callables:
    f_a(b) -> float   true ensemble validation accuracy  (accuracy profiler)
    f_l(b) -> float   true serving latency under config c (latency profiler)
so the same search runs against the real serving system, the DES simulator,
or an analytic model (§3.4 exposes f_l(V, c, b) as an API).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.genetic import explore
from repro_torch.core.objective import LatencyConstrainedObjective, soft_delta
from repro_torch.core.surrogate import SurrogatePair


@dataclasses.dataclass
class ComposerParams:
    """Algorithm 1 parameters (names follow the paper)."""
    N: int = 15                 # search iterations
    N0: int = 16                # warm-start samples
    M: int = 200                # explore samples per iteration
    K: int = 8                  # newly profiled samples per iteration
    S: int = 2                  # mutation degree
    p: float = 0.8              # P(genetic explore)  (else uniform random)
    q: float = 0.5              # P(mutation)         (else recombination)
    lam: float = 1.0            # lambda for the surrogate-side soft score
    seed: int = 0


@dataclasses.dataclass
class ComposerResult:
    b_star: np.ndarray
    accuracy: float
    latency: float
    feasible: bool
    n_profiler_calls: int
    B: np.ndarray               # all profiled selectors
    Y_acc: np.ndarray
    Y_lat: np.ndarray
    history: List[Dict]         # per-iteration trajectory (Fig. 6 / 8)
    wall_seconds: float


def _profile(B_new, f_a, f_l):
    acc = np.asarray([f_a(b) for b in B_new], np.float64)
    lat = np.asarray([f_l(b) for b in B_new], np.float64)
    return acc, lat


def _screen(surrogates: SurrogatePair, candidates: np.ndarray,
            latency_budget: float, soft, k: int) -> np.ndarray:
    """Surrogate screening (lines 17-19): estimated accuracy plus the
    one-sided soft latency penalty, top-k by score.  Shared by the
    search loop and recompose's warm-start seed selection so the
    screening objective cannot drift between them."""
    a_hat, l_hat = surrogates.predict(candidates)
    scores = a_hat + np.asarray(
        [soft(latency_budget - l) for l in l_hat])
    return candidates[np.argsort(-scores, kind="stable")[:k]]


def compose(n_models: int,
            f_a: Callable[[np.ndarray], float],
            f_l: Callable[[np.ndarray], float],
            latency_budget: float,
            params: Optional[ComposerParams] = None,
            warm_start: Optional[Sequence[np.ndarray]] = None,
            heldout_B: Optional[np.ndarray] = None,
            heldout_acc: Optional[np.ndarray] = None,
            heldout_lat: Optional[np.ndarray] = None) -> ComposerResult:
    """Algorithm 1.  ``warm_start``: seed selectors (the paper adds the
    RD/AF/LF solutions).  ``heldout_*``: optional independent selectors for
    the Fig.-8 surrogate-R² tracking (never added to B)."""
    t0 = time.time()
    prm = params or ComposerParams()
    rng = np.random.default_rng(prm.seed)
    objective = LatencyConstrainedObjective(latency_budget)
    soft = soft_delta(prm.lam)

    # ---- warm start (line 6) -------------------------------------------
    seeds: List[np.ndarray] = [np.asarray(b, np.int8)
                               for b in (warm_start or [])]
    while len(seeds) < prm.N0:
        size = int(rng.integers(1, max(2, n_models // 2)))
        b = np.zeros(n_models, np.int8)
        b[rng.choice(n_models, size=size, replace=False)] = 1
        seeds.append(b)
    # dedupe
    uniq, seen = [], set()
    for b in seeds:
        k = b.tobytes()
        if k not in seen:
            seen.add(k)
            uniq.append(b)
    B_new = np.stack(uniq)

    B = np.zeros((0, n_models), np.int8)
    Y_acc = np.zeros((0,))
    Y_lat = np.zeros((0,))
    surrogates = SurrogatePair(seed=prm.seed)
    history: List[Dict] = []
    calls = 0

    for it in range(prm.N):
        # ---- profile the new candidates (lines 9-11) -------------------
        acc_new, lat_new = _profile(B_new, f_a, f_l)
        calls += len(B_new)
        B = np.concatenate([B, B_new])
        Y_acc = np.concatenate([Y_acc, acc_new])
        Y_lat = np.concatenate([Y_lat, lat_new])

        # ---- fit surrogates (line 13) ----------------------------------
        surrogates.fit(B, Y_acc, Y_lat)

        # ---- genetic exploration (line 15, Algorithm 2) ----------------
        B_prime = explore(B, prm.M, prm.S, prm.p, prm.q, rng)
        if len(B_prime) == 0:
            break

        # ---- surrogate screening (lines 17-19) -------------------------
        B_new = _screen(surrogates, B_prime, latency_budget, soft, prm.K)

        # ---- trajectory bookkeeping ------------------------------------
        feas = Y_lat <= latency_budget
        best = (int(np.argmax(np.where(feas, Y_acc, -np.inf)))
                if feas.any() else int(np.argmin(Y_lat)))
        rec = {"iteration": it, "profiler_calls": calls,
               "best_acc": float(Y_acc[best]),
               "best_lat": float(Y_lat[best]),
               "new_acc": float(acc_new.mean()),
               "new_lat": float(lat_new.mean())}
        if heldout_B is not None and len(heldout_B):
            r2a, r2l = surrogates.r2(heldout_B, heldout_acc, heldout_lat)
            rec["r2_acc"], rec["r2_lat"] = r2a, r2l
        history.append(rec)

    # ---- final answer over the true-profiled set (line 24) -------------
    values = np.asarray([objective(a, l) for a, l in zip(Y_acc, Y_lat)])
    j = int(np.argmax(values))
    feasible = bool(np.isfinite(values[j]))
    if not feasible:                      # nothing fits: least-bad latency
        j = int(np.argmin(Y_lat))
    return ComposerResult(
        b_star=B[j].copy(), accuracy=float(Y_acc[j]),
        latency=float(Y_lat[j]), feasible=feasible,
        n_profiler_calls=calls, B=B, Y_acc=Y_acc, Y_lat=Y_lat,
        history=history, wall_seconds=time.time() - t0)


def recompose(f_a: Callable[[np.ndarray], float],
              f_l: Callable[[np.ndarray], float],
              latency_budget: float,
              warm_start: ComposerResult,
              params: Optional[ComposerParams] = None,
              seed_pool: int = 6) -> ComposerResult:
    """Incremental Algorithm-1 re-run: the online control plane's inner
    loop, warm-started from a previous ``ComposerResult``.

    Two things carry over from the previous run:

    * accuracy observations — f_a is load-invariant, so every
      previously profiled (b, acc) pair becomes a memo entry and only
      genuinely NEW selectors hit the accuracy profiler;
    * the incumbent's surrogate — refit on the previous profiled set,
      it screens a genetic neighbourhood of b_star to pick the
      warm-start seeds (prior latencies are stale in absolute terms
      under the new load but still rank candidates by cost).

    Latency is always re-profiled: f_l must reflect the CURRENT load
    (arrival rate / census), which is exactly what changed.
    """
    prev = warm_start
    n_models = prev.B.shape[1]
    prm = params or ComposerParams(N=4, N0=8, M=120, K=6)
    rng = np.random.default_rng(prm.seed + 1)
    soft = soft_delta(prm.lam)

    memo: Dict[bytes, float] = {
        np.asarray(b, np.int8).tobytes(): float(a)
        for b, a in zip(prev.B, prev.Y_acc)}

    def f_a_memo(b: np.ndarray) -> float:
        k = np.asarray(b, np.int8).tobytes()
        if k not in memo:
            memo[k] = float(f_a(b))
        return memo[k]

    # seeds: the incumbent + the best previously profiled selectors
    seeds: List[np.ndarray] = [prev.b_star.astype(np.int8)]
    for j in np.argsort(-prev.Y_acc)[:seed_pool]:
        seeds.append(prev.B[j].astype(np.int8))

    # surrogate-screened genetic neighbourhood of the incumbent
    prior = SurrogatePair.from_observations(prev.B, prev.Y_acc,
                                            prev.Y_lat, seed=prm.seed)
    cand = explore(np.stack(seeds), prm.M, prm.S, prm.p, prm.q, rng)
    if len(cand):
        take = max(0, prm.N0 - len(seeds))
        seeds += list(_screen(prior, cand, latency_budget, soft, take))

    return compose(n_models, f_a_memo, f_l, latency_budget,
                   params=prm, warm_start=seeds)
