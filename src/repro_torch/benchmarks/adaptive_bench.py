"""Adaptive-vs-static serving under patient churn: the loops of the
control plane's acceptance harness (the port of
``benchmarks/adaptive_bench.py``, without its ``bench_adaptive`` and
the ``BENCH_adaptive.json`` it writes).

A DES load spike — the census tripling mid-run by default — is served
two ways:

* ``static``   — the selector composed for the initial load, frozen
                 forever (the pre-control-plane behaviour);
* ``adaptive`` — the full loop: per-epoch telemetry (arrivals +
                 latencies replayed into ``SloTelemetry``) -> controller
                 decision (shed / recompose / climb) -> warm-started
                 ``recompose`` at the OBSERVED arrival rate -> selector
                 swap for the next epoch.

``run_tiered_sim`` is the per-acuity-tier loop over the same DES, and
``wallclock_hot_swap`` serves REAL queries through the batch-aware
server while a ``HotSwapper`` swaps selectors mid-stream (zero dropped
queries), on ``device`` (default ``cuda:0``).  The DES loops are
numpy and run on the host.  ``synthetic_testbed`` keeps a run fast and
deterministic; ``python -m repro_torch.examples.serve_icu --adaptive``
drives the same harness with the trained zoo and measured member
costs.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.control.controller import (AdaptiveController,
                                            ControllerConfig,
                                            TieredController,
                                            TieredControllerConfig)
from repro_torch.control.swap import SelectorLadder
from repro_torch.control.telemetry import SloTelemetry, TieredTelemetry
from repro_torch.core.bagging import roc_auc
from repro_torch.core.composer import ComposerParams, compose, recompose
from repro_torch.core.profiles import ModelProfile, ModelZoo, SystemConfig
from repro_torch.device import DeviceLike
from repro_torch.serving.latency import LatencyProfiler
from repro_torch.serving.placement import lpt_placement
from repro_torch.serving.simulator import SimConfig, simulate


class _DesLadder(SelectorLadder):
    """Ladder whose activation is a no-op: the DES reads
    ``active_selector`` when it builds the next epoch's cost list."""

    def _activate(self, selector: np.ndarray) -> None:
        pass


def synthetic_testbed(n: int = 10, n_val: int = 400, seed: int = 0,
                      cost_lo: float = 0.04, cost_hi: float = 0.22
                      ) -> Tuple[ModelZoo, np.ndarray, Callable]:
    """A zoo where accuracy genuinely trades against latency: richer
    (slower) members are individually stronger, and independent score
    noise means bagging more members helps."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, n_val)
    quality = np.linspace(0.5, 1.8, n) + rng.normal(0, 0.1, n)
    scores = np.stack([
        1.0 / (1.0 + np.exp(-(q * (2 * y - 1)
                              + rng.normal(0, 2.0, n_val))))
        for q in quality])
    costs = np.linspace(cost_lo, cost_hi, n)
    labels = (y == 1).astype(int)
    profiles = [ModelProfile(
        name=f"m{i}", depth=2 + i, width=16, macs=costs[i] * 1e9,
        memory_bytes=1e6, modality=0, input_len=100,
        val_auc=roc_auc(labels, scores[i])) for i in range(n)]
    zoo = ModelZoo(profiles, val_scores=scores, val_labels=labels)

    def f_a(b) -> float:
        sel = scores[np.asarray(b, bool)]
        return roc_auc(labels, sel.mean(axis=0)) if len(sel) else 0.5
    return zoo, costs, f_a


def _ladder_from(res, costs: np.ndarray) -> List[np.ndarray]:
    """Cheapest -> richest degradation ladder around a composition:
    the cheapest single member, the best previously profiled selector
    at <= half the incumbent's cost, and the incumbent itself."""
    costs = np.asarray(costs)

    def cost_of(b):
        return float(costs[np.asarray(b, bool)].sum())

    cheap = np.zeros(len(costs), np.int8)
    cheap[int(np.argmin(costs))] = 1
    levels = [cheap]
    half = cost_of(res.b_star) / 2
    mid = [(a, b) for b, a in zip(res.B, res.Y_acc)
           if 0 < cost_of(b) <= half and not np.array_equal(b, cheap)]
    if mid:
        levels.append(np.asarray(
            max(mid, key=lambda t: t[0])[1], np.int8))
    if not any(np.array_equal(l, res.b_star) for l in levels):
        levels.append(res.b_star.astype(np.int8))
    return levels


def run_adaptive_sim(zoo: ModelZoo, costs: Sequence[float], f_a: Callable,
                     slo: float, schedule: Sequence[Tuple[int, int]],
                     adaptive: bool = True, epoch_seconds: float = 40.0,
                     window_seconds: float = 10.0, n_devices: int = 2,
                     seed: int = 0,
                     compose_params: ComposerParams = None,
                     recompose_params: ComposerParams = None,
                     verbose: bool = False,
                     telemetry_exact: bool = False) -> Dict:
    """Epoch-driven closed loop over the DES.  ``schedule`` is a list of
    (n_epochs, census) phases; the initial composition always targets
    the FIRST phase's census (that is the point: the static selector is
    right for the load it was composed for)."""
    costs = np.asarray(costs, np.float64)
    epochs = [c for n_ep, c in schedule for _ in range(n_ep)]

    def f_l_for(n_patients: int) -> LatencyProfiler:
        return LatencyProfiler(
            zoo, SystemConfig(n_devices=n_devices, n_patients=n_patients,
                              window_seconds=window_seconds),
            cost_fn=lambda i: costs[i], seed=seed)

    res0 = compose(len(zoo), f_a, f_l_for(epochs[0]), slo,
                   compose_params or ComposerParams(N=6, M=80, K=4,
                                                    N0=10, seed=seed))
    swapper = _DesLadder(res0.b_star)
    swapper.set_ladder(_ladder_from(res0, costs))
    telemetry = SloTelemetry(slo_seconds=slo,
                             window_seconds=epoch_seconds,
                             clock=lambda: 0.0,
                             exact=telemetry_exact)
    state = {"warm": res0}

    def recompose_fn(snap):
        n_est = max(1, int(round(snap.arrival_rate * window_seconds)))
        r = recompose(f_a, f_l_for(n_est), slo, warm_start=state["warm"],
                      params=recompose_params
                      or ComposerParams(N=4, M=80, K=4, N0=8, seed=seed))
        state["warm"] = r
        swapper.set_ladder(_ladder_from(r, costs))
        return r.b_star

    def profile_fn():
        c = costs[swapper.active_selector.astype(bool)]
        if not len(c):
            return float("inf"), 0.0
        # Ts is the slowest device's total work under the LPT plan —
        # the same per-device-makespan model serving_latency uses — not
        # the single heaviest member
        pl = lpt_placement(list(c), n_devices)
        return n_devices / float(c.sum()), pl.makespan, pl.imbalance

    ctl = AdaptiveController(
        telemetry, swapper, recompose_fn=recompose_fn,
        config=ControllerConfig(slo_seconds=slo, cooldown_seconds=0.0,
                                min_samples=10),
        service_profile_fn=profile_fn, sync=True)

    records: List[Dict] = []
    carry = np.asarray([])                # unfinished-query backlog
    for e, census in enumerate(epochs):
        sel = swapper.active_selector.copy()
        c_sel = list(costs[sel.astype(bool)])
        r = simulate(c_sel, SimConfig(
            n_patients=census, n_devices=n_devices,
            window_seconds=window_seconds,
            duration_seconds=epoch_seconds, seed=seed + 17 * e,
            carry_backlog=True), backlog=carry)
        t0 = e * epoch_seconds
        if adaptive:                          # static arm has no reader
            for q in r.queries:
                if q.t_window >= 0:    # backlog arrivals were recorded
                    telemetry.record_arrival(t0 + q.t_window)
                telemetry.record_served(
                    q.latency, t0 + min(q.t_done, epoch_seconds))
            for age in r.backlog:      # born here, served next epoch
                # age > epoch_seconds means the query was carried IN
                # (born in an earlier epoch, arrival already recorded)
                if age <= epoch_seconds:
                    telemetry.record_arrival(t0 + epoch_seconds - age)
        lat = r.latencies()
        rec = {"epoch": e, "t0_s": t0, "census": census,
               "selector": np.flatnonzero(sel).tolist(),
               "n_members": int(sel.sum()),
               "accuracy": float(f_a(sel)),
               "served": len(r.queries),
               "backlog_in": len(carry),
               "backlog_out": len(r.backlog),
               # births this epoch: everything retired or carried out,
               # minus what was carried in — the conservation identity
               "born": len(r.queries) + len(r.backlog) - len(carry),
               "p50_s": r.p(50), "p99_s": r.p(99),
               "violation_rate": float(np.mean(lat > slo))
               if len(lat) else 0.0}
        carry = r.backlog
        if adaptive:
            rec["decision"] = ctl.step(now=(e + 1) * epoch_seconds).value
        records.append(rec)
        if verbose:
            print(f"  [{'adpt' if adaptive else 'stat'}] epoch {e} "
                  f"census {census:3d} members {rec['n_members']:2d} "
                  f"acc {rec['accuracy']:.3f} p99 {rec['p99_s']:7.3f}s "
                  f"viol {rec['violation_rate']:.2f} "
                  f"backlog {rec['backlog_out']:3d}"
                  + (f" -> {rec.get('decision', '')}" if adaptive else ""))

    served = sum(r["served"] for r in records)
    viol = sum(r["violation_rate"] * r["served"] for r in records)
    spike_start = schedule[0][0]
    return {"epochs": records,
            "violation_rate": viol / max(served, 1),
            "p99_final_spike_s":
                records[schedule[0][0] + schedule[1][0] - 1]["p99_s"]
                if len(schedule) > 1 else records[-1]["p99_s"],
            "mean_accuracy": float(np.mean(
                [r["accuracy"] for r in records])),
            "spike_start_epoch": spike_start,
            "initial_selector": np.flatnonzero(res0.b_star).tolist(),
            "actions": [(t, d.value) for t, d in ctl.log],
            "n_recomposes": ctl.n_recomposes,
            "served_total": served,
            "born_total": sum(r["born"] for r in records),
            "final_backlog": len(carry)}


DEFAULT_TIER_FRACS = {"stable": 0.60, "elevated": 0.25,
                      "critical": 0.15}


def run_tiered_sim(zoo: ModelZoo, costs: Sequence[float], f_a: Callable,
                   slo: float, schedule: Sequence[Tuple[int, int]],
                   tier_fracs: Dict[str, float] = None,
                   escalate_hazard: float = 0.02,
                   epoch_seconds: float = 40.0,
                   window_seconds: float = 10.0, n_devices: int = 2,
                   seed: int = 0, rho_max: float = 0.8,
                   compose_params: ComposerParams = None,
                   verbose: bool = False,
                   telemetry_exact: bool = False) -> Dict:
    """The per-acuity-tier closed loop over the DES: every tier starts
    on the RICH composed ensemble; under the census spike the
    priority-aware controller sheds stable-tier rungs first (and floors
    them in one actuation when the predicted device budget demands it)
    while the critical tier holds the rich ensemble — the headline
    claim is critical-tier p99/accuracy at rich-ensemble levels while
    only low-acuity rungs degrade.  Per-tier conservation fields
    (born = served + backlog_out - backlog_in, per tier, per epoch)
    sum to the fleet totals."""
    costs = np.asarray(costs, np.float64)
    fracs = dict(tier_fracs or DEFAULT_TIER_FRACS)
    tiers = tuple(fracs)
    epochs = [c for n_ep, c in schedule for _ in range(n_ep)]

    f_l0 = LatencyProfiler(
        zoo, SystemConfig(n_devices=n_devices, n_patients=epochs[0],
                          window_seconds=window_seconds),
        cost_fn=lambda i: costs[i], seed=seed)
    res0 = compose(len(zoo), f_a, f_l0, slo,
                   compose_params or ComposerParams(N=6, M=80, K=4,
                                                    N0=10, seed=seed))
    family = _ladder_from(res0, costs)
    lanes = {t: _DesLadder(res0.b_star) for t in tiers}
    for lane in lanes.values():
        lane.set_ladder(family)
    telemetry = TieredTelemetry(
        tier_of=lambda p: tiers[0], tiers=tiers, slo_seconds=slo,
        window_seconds=epoch_seconds, clock=lambda: 0.0,
        exact=telemetry_exact)
    ctl = TieredController(
        telemetry, lanes, tier_order=tiers,
        config=TieredControllerConfig(slo_seconds=slo,
                                      cooldown_seconds=0.0,
                                      min_samples=10, rho_max=rho_max),
        cost_fn=lambda sel: float(costs[np.asarray(sel, bool)].sum()),
        n_devices=n_devices)

    records: List[Dict] = []
    carry_ages, carry_tiers = np.asarray([]), []
    for e, census in enumerate(epochs):
        tier_costs = {
            t: list(costs[lanes[t].active_selector.astype(bool)])
            for t in tiers}
        r = simulate(tier_costs, SimConfig(
            n_patients=census, n_devices=n_devices,
            window_seconds=window_seconds,
            duration_seconds=epoch_seconds, seed=seed + 17 * e,
            carry_backlog=True, tiers=fracs,
            escalate_hazard=escalate_hazard),
            backlog=carry_ages, backlog_tiers=carry_tiers)
        t0 = e * epoch_seconds
        for q in r.queries:
            if q.t_window >= 0:    # backlog arrivals were recorded
                telemetry.record_arrival(t0 + q.t_window, tier=q.tier)
            telemetry.record_served(
                q.latency, t0 + min(q.t_done, epoch_seconds),
                tier=q.tier)
        for age, tr in zip(r.backlog, r.backlog_tiers):
            if age <= epoch_seconds:   # born here, served next epoch
                telemetry.record_arrival(t0 + epoch_seconds - age,
                                         tier=tr)
        per: Dict[str, Dict] = {}
        for t in tiers:
            qs = [q for q in r.queries if q.tier == t]
            lat = np.asarray([q.latency for q in qs])
            bl_in = sum(1 for x in carry_tiers if x == t)
            bl_out = sum(1 for x in r.backlog_tiers if x == t)
            sel_t = lanes[t].active_selector
            per[t] = {
                "rung": lanes[t].ladder_pos,
                "n_members": int(sel_t.sum()),
                "accuracy": float(f_a(sel_t)),
                "served": len(qs),
                "backlog_in": bl_in, "backlog_out": bl_out,
                "born": len(qs) + bl_out - bl_in,
                "p99_s": float(np.percentile(lat, 99))
                if len(lat) else 0.0,
                "violation_rate": float(np.mean(lat > slo))
                if len(lat) else 0.0}
        lat_all = r.latencies()
        rec = {"epoch": e, "t0_s": t0, "census": census,
               "served": len(r.queries),
               "born": len(r.queries) + len(r.backlog)
               - len(carry_tiers),
               "p50_s": r.p(50), "p99_s": r.p(99),
               "violation_rate": float(np.mean(lat_all > slo))
               if len(lat_all) else 0.0,
               "escalations": sum(1 for x in r.tier_log if x[2]),
               "tiers": per}
        carry_ages, carry_tiers = r.backlog, list(r.backlog_tiers)
        actions = ctl.step(now=(e + 1) * epoch_seconds)
        rec["decisions"] = [f"{d.value}:{t}" for d, t in actions]
        records.append(rec)
        if verbose:
            rungs = "/".join(str(per[t]["rung"]) for t in tiers)
            print(f"  [tier] epoch {e} census {census:3d} "
                  f"rungs {rungs} p99 {rec['p99_s']:7.3f}s "
                  f"viol {rec['violation_rate']:.2f} "
                  f"crit-viol {per[tiers[-1]]['violation_rate']:.2f}"
                  + (f" -> {','.join(rec['decisions'])}"
                     if rec["decisions"] else ""))

    per_tier: Dict[str, Dict] = {}
    for t in tiers:
        served = sum(r["tiers"][t]["served"] for r in records)
        viol = sum(r["tiers"][t]["violation_rate"]
                   * r["tiers"][t]["served"] for r in records)
        per_tier[t] = {
            "served": served,
            "born": sum(r["tiers"][t]["born"] for r in records),
            "final_backlog": sum(1 for x in carry_tiers if x == t),
            "violation_rate": viol / max(served, 1),
            "mean_accuracy": float(np.mean(
                [r["tiers"][t]["accuracy"] for r in records])),
            "final_rung": records[-1]["tiers"][t]["rung"],
            "min_rung": min(r["tiers"][t]["rung"] for r in records)}
    served_total = sum(r["served"] for r in records)
    return {"tier_fracs": fracs, "escalate_hazard": escalate_hazard,
            "rho_max": rho_max, "slo_s": slo,
            "epochs": records, "per_tier": per_tier,
            "served_total": served_total,
            "born_total": sum(r["born"] for r in records),
            "final_backlog": len(carry_tiers),
            # the conservation identity the acceptance tracks: per-tier
            # served sums to the fleet total, and per-tier born balances
            # served + final backlog
            "per_tier_served_sum": sum(
                v["served"] for v in per_tier.values()),
            "initial_selector": np.flatnonzero(res0.b_star).tolist(),
            "ladder_sizes": [int(s.sum()) for s in family],
            "actions": [(t, tier, d.value) for t, tier, d in ctl.log]}


def wallclock_hot_swap(n_queries: int = 48, n_swaps: int = 3,
                       input_len: int = 250, pool: Sequence = None,
                       sel_a: np.ndarray = None, sel_b: np.ndarray = None,
                       window_fn: Callable = None, n_workers: int = 2,
                       verbose: bool = True,
                       device: DeviceLike = None) -> Dict:
    """REAL fused serving through the batch-aware server while the
    control plane hot-swaps selectors mid-stream: every submitted query
    must be served (zero dropped), across ``n_swaps`` swaps.  Defaults
    to a randomly-initialised reduced zoo split into even/odd selectors;
    pass ``pool``/``sel_a``/``sel_b``/``window_fn`` to run it on trained
    members (``repro_torch.examples.serve_icu --adaptive``).  The
    swapper's lane and its services live on ``device`` (default
    ``cuda:0``).

    Beside the reference's keys, ``"staged"`` lists each service the
    swapper staged (``{"selector", "flushes", "warmup_flushes",
    "service"}``): the flushes it served in this run and the pow2
    warm-up flushes staging ran, whose sum is every fused flush of the
    call."""
    import torch

    from repro_torch.control.swap import HotSwapper
    from repro_torch.device import lanes, resolve_device
    from repro_torch.serving.server import EnsembleServer

    dev = resolve_device(device)
    if pool is None:
        from repro_torch.configs.ecg_zoo import zoo_specs
        from repro_torch.models.ecg_resnext import init_ecg
        from repro_torch.serving.pipeline import ZooMember
        specs = zoo_specs(reduced=True, input_len=input_len)
        pool = [ZooMember(s, init_ecg(s, torch.Generator().manual_seed(i),
                                      dev))
                for i, s in enumerate(specs)]
    n = len(pool)
    if sel_a is None:
        sel_a = np.asarray([i % 2 == 0 for i in range(n)], np.int8)
    if sel_b is None:
        sel_b = np.asarray([i % 2 == 1 for i in range(n)], np.int8)
    if window_fn is None:
        window_fn = lambda rng, i: {
            "ecg": rng.standard_normal((3, input_len))
            .astype(np.float32)}
    warm = (1, 2, 4, 8)
    swapper = HotSwapper(pool, sel_a, warmup_batch_sizes=warm,
                         devices=lanes(1, dev))
    # register both selectors as the ladder so toggling between them
    # stays pre-staged (off-ladder selectors are evicted after a swap)
    swapper.set_ladder([sel_b, sel_a], prestage=True)
    srv = EnsembleServer(batch_handler=swapper.facade.predict_batch,
                         n_workers=n_workers, max_batch=8,
                         max_wait_ms=2.0).start()
    rng = np.random.default_rng(0)
    stride = max(1, n_queries // (n_swaps + 1))
    submitted = 0
    for i in range(n_queries):
        if i and i % stride == 0 and swapper.facade.swap_count < n_swaps:
            swapper.swap_to(sel_b if (i // stride) % 2 else sel_a)
        submitted += bool(srv.submit(i, window_fn(rng, i)))
    stats = srv.stop()
    out = {"submitted": submitted, "served": stats.served,
           "dropped": submitted - stats.served,
           "swaps": swapper.facade.swap_count,
           "p95_ms": stats.p(95) * 1e3,
           "staged": []}
    for sel in (sel_a, sel_b):
        svc = swapper.stage(sel)               # cached: no new staging
        if all(st["service"] is not svc for st in out["staged"]):
            out["staged"].append({
                "selector": np.flatnonzero(sel).tolist(),
                "flushes": svc.dispatch_count // max(svc.n_buckets, 1),
                "warmup_flushes": len(warm), "service": svc})
    if verbose:
        print(f"  wall-clock hot-swap: {out['served']}/{out['submitted']}"
              f" served across {out['swaps']} swaps "
              f"({out['dropped']} dropped), p95 {out['p95_ms']:.1f} ms")
    return out
