"""Latency estimation (§3.4): T-hat = T_q + T_s.  The port of
``repro/serving/latency.py`` (numpy only; the same answers).

T_s — serving latency of the ensemble — comes from throughput capacity
(closed-loop measurement on the real zoo, or the analytic roofline model
for datacenter-scale members).

T_q — queueing delay — via NETWORK CALCULUS (Fig. 5): the maximum
horizontal distance between the empirical arrival curve (max #queries in
any window of length dt, from the observed trace) and the analytic service
curve (rate-latency function beta(t) = mu * (t - T0)+) is a tight upper
bound on queueing delay.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.core.profiles import ModelZoo, SystemConfig
from repro_torch.serving.placement import Placement, lpt_placement


# ------------------------------------------------------- network calculus
def arrival_curve(arrivals: np.ndarray, dts: np.ndarray) -> np.ndarray:
    """Empirical arrival curve: alpha(dt) = max #arrivals in any
    half-open window [t, t+dt).  The max is attained with a window
    anchored at some arrival, where the count is
    ``searchsorted(a, a[i] + dt, 'left') - i``, so each dt costs one
    vectorized searchsorted over the sorted trace.  An empty trace
    yields the zero curve."""
    arrivals = np.sort(np.asarray(arrivals, np.float64))
    dts = np.atleast_1d(np.asarray(dts, np.float64))
    n = len(arrivals)
    if n == 0:
        return np.zeros(len(dts))
    ends = np.searchsorted(arrivals,
                           arrivals[None, :] + dts[:, None], side="left")
    return (ends - np.arange(n)[None, :]).max(axis=1).astype(np.float64)


def service_curve(mu: float, T0: float, dts: np.ndarray) -> np.ndarray:
    """Rate-latency curve beta(dt) = mu * max(dt - T0, 0)."""
    return mu * np.maximum(np.asarray(dts, np.float64) - T0, 0.0)


def max_horizontal_distance(dts: np.ndarray, alpha: np.ndarray,
                            mu: float, T0: float) -> float:
    """sup_t h(t) where h(t) = inf{d >= 0 : alpha(t) <= beta(t + d)}.
    For the rate-latency beta this is closed-form:
        h(t) = T0 + alpha(t)/mu - t.
    """
    if mu <= 0:
        return float("inf")
    h = T0 + alpha / mu - dts
    return float(max(np.max(h), 0.0))


def queueing_bound(arrivals: np.ndarray, mu: float, T0: float) -> float:
    """T_q: tight upper bound on queueing delay from the observed trace.

    Exact evaluation of sup_t [T0 + alpha(t)/mu - t]: alpha is a step
    function, so the sup is attained where a count c first becomes
    reachable — at the MINIMAL window containing c arrivals:
        bound = T0 + max_c ( c/mu - min_i (a[i+c-1] - a[i]) ).
    (A sampled arrival curve under-states alpha between grid points and
    can violate the bound; this closed form cannot.)
    """
    a = np.sort(np.asarray(arrivals, np.float64))
    n = len(a)
    if n == 0 or mu <= 0:
        return 0.0 if n == 0 else float("inf")
    best = 1.0 / mu                       # c = 1, zero-length window
    for c in range(2, n + 1):
        min_win = np.min(a[c - 1:] - a[:n - c + 1])
        best = max(best, c / mu - min_win)
    return float(T0 + max(best, 0.0))


# ------------------------------------------------------- latency profiler
@dataclasses.dataclass
class LatencyProfiler:
    """f_l(V, c, b) (§3.4).  Two Ts sources share one Tq methodology:

    * cost_fn given  — measured mode: per-model service seconds/query
      (e.g. ``EnsembleService.measured_costs`` on the card).
    * cost_fn None   — analytic mode from profile MACs and c.device_flops.
    """
    zoo: ModelZoo
    config: SystemConfig
    cost_fn: Optional[Callable[[int], float]] = None   # model idx -> sec/q
    flops_efficiency: float = 0.35
    fixed_overhead: float = 0.004        # queue/RPC/dispatch seconds
    trace_seconds: float = 120.0
    p95: bool = True
    seed: int = 0
    # infeasible configurations (OOM / unstable queue) get a large FINITE
    # latency so surrogate models can still fit the profiled set
    infeasible_latency: float = 100.0
    # per-device relative speeds (heterogeneous pool): costs are
    # reference-device seconds, so device j serves cost c in
    # c / device_speeds[j] seconds.  None == homogeneous (unit) pool;
    # length must equal config.n_devices when given.
    device_speeds: Optional[Sequence[float]] = None

    def _speeds(self) -> Optional[Sequence[float]]:
        sp = self.device_speeds
        if sp is not None and len(sp) != self.config.n_devices:
            raise ValueError(f"{len(sp)} device_speeds != "
                             f"{self.config.n_devices} devices")
        return sp

    def model_cost(self, i: int) -> float:
        if self.cost_fn is not None:
            return float(self.cost_fn(i))
        macs = self.zoo.profiles[i].macs
        return 2.0 * macs / (self.config.device_flops
                             * self.flops_efficiency)

    def ensemble_memory(self, b: np.ndarray) -> float:
        return float(sum(p.memory_bytes for p, bi
                         in zip(self.zoo.profiles, b) if bi))

    def serving_latency(self, b: np.ndarray,
                        placement: Optional[Placement] = None) -> float:
        """T_s: PER-DEVICE MAKESPAN of the selected models under their
        device placement — the ensemble members run concurrently (§3.4
        stateless actors), so T_s is the slowest device's total work,
        not the sum over members.  ``placement=None`` plans with the
        same ``lpt_placement`` the live sharded service actuates, so
        the offline model and the serving path share one planner; pass
        the ACTIVE plan to score what is actually deployed."""
        costs = [self.model_cost(i) for i in range(len(b)) if b[i]]
        if not costs:
            return self.fixed_overhead
        if placement is None:
            placement = lpt_placement(costs, self.config.n_devices,
                                      speeds=self._speeds())
        return placement.makespan + self.fixed_overhead

    def throughput(self, b: np.ndarray) -> float:
        """mu (queries/s): total reference-device work per ensemble
        query is sum(costs); the pool retires sum(speeds) work units
        per second under perfect pipelining, so
        mu = sum(speeds) / sum(costs) (n_devices/total when unit)."""
        total = sum(self.model_cost(i) for i in range(len(b)) if b[i])
        if total <= 0:
            return float("inf")
        sp = self._speeds()
        capacity = (float(np.sum(sp)) if sp is not None
                    else float(self.config.n_devices))
        return capacity / total

    def query_arrivals(self) -> np.ndarray:
        """Ensemble queries: each patient fires once per observation
        window, with phase jitter (patients are not synchronized)."""
        rng = np.random.default_rng(self.seed)
        c = self.config
        windows = int(self.trace_seconds / c.window_seconds)
        phases = rng.uniform(0, c.window_seconds, c.n_patients)
        t = (np.arange(windows)[None, :] * c.window_seconds
             + phases[:, None])
        return np.sort(t.ravel())

    def __call__(self, b: np.ndarray,
                 placement: Optional[Placement] = None) -> float:
        """A caller holding the ACTIVE placement (e.g. a post-failover,
        deliberately unbalanced interim plan) must pass it: a fresh LPT
        plan here would understate T_s exactly when the controller's
        risk prediction matters most."""
        b = np.asarray(b).astype(bool)
        if self.ensemble_memory(b) > (self.config.device_mem_bytes
                                      * self.config.n_devices):
            return self.infeasible_latency
        Ts = self.serving_latency(b, placement=placement)
        mu = self.throughput(b)
        lam = self.config.n_patients / self.config.window_seconds
        if lam >= mu:
            return self.infeasible_latency       # unstable queue
        Tq = queueing_bound(self.query_arrivals(), mu, Ts)
        return min(Ts + Tq, self.infeasible_latency)
