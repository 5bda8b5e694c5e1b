"""The adaptive controller: telemetry -> decision -> actuation (the
port of ``repro/control/controller.py``).

One control iteration (``step``) reads a consistent telemetry snapshot
and picks one of five actions:

* ``SHED``      — SLO is being violated NOW (violation rate above the
                  high-water mark, or observed p99 over the SLO): step
                  down the degradation ladder immediately (a pre-staged
                  pointer flip), and kick off a background recompose to
                  find the best ensemble for the new load;
* ``REPLACE``   — the live device placement is lopsided (bucket-load
                  imbalance over ``imbalance_high``) while the ensemble
                  itself is fine: re-derive the LPT plan from freshly
                  measured bucket costs and hot-swap the SAME selector
                  onto the new shards (``HotSwapper.re_place``) — far
                  cheaper than a recompose, so it is tried first;
* ``RECOMPOSE`` — predicted SLO risk (online network-calculus
                  T_s + T_q crossing the SLO) or arrival-rate drift
                  beyond the trigger factor: re-run the composer
                  warm-started from the incumbent, then hot-swap (a
                  recompose also re-derives the placement — selector
                  AND placement are the actuated state);
* ``CLIMB``     — healthy with headroom (violations under the
                  low-water mark and p99 under ``headroom_frac`` of the
                  SLO): step back up the ladder;
* ``HOLD``      — otherwise, or within the post-action cooldown.

Recomposition runs in a daemon thread (``sync=False``) so the serving
hot path never blocks on the search; the DES bench and unit tests use
``sync=True`` for determinism.  ``recompose_fn(snapshot)`` is injected:
it returns the new selector (or None to keep the incumbent) and may
also rebuild the ladder around it.

``TieredController`` lifts the same signals to per-acuity-tier
actuation: the fleet shares one device pool, so overload/health is read
fleet-wide, but the ACTION lands on one tier's ladder — stable beds
shed first and climb last, and the critical tier holds the rich
ensemble until the predicted capacity bound says even flooring every
lower tier cannot restore feasibility.  A cross-tier device budget
(``rho_max``) keeps one tier's climb from eating another's headroom.
"""
from __future__ import annotations

import dataclasses
import enum
import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.control.swap import SelectorLadder, rungs_monotone
from repro_torch.control.telemetry import SloTelemetry, TelemetrySnapshot
from repro_torch.serving.placement import placement_signature

log = logging.getLogger(__name__)


class Decision(enum.Enum):
    HOLD = "hold"
    SHED = "shed"
    CLIMB = "climb"
    RECOMPOSE = "recompose"
    REPLACE = "replace"


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    slo_seconds: float = 1.0
    violation_high: float = 0.10   # violation rate that forces a shed
    violation_low: float = 0.01    # below this (plus headroom) => climb
    headroom_frac: float = 0.5     # p99 <= frac * SLO counts as headroom
    drift_factor: float = 1.5      # arrival-rate drift trigger (x or /x)
    # the online T_q bound is worst-case-burst conservative; require the
    # predicted T_s + T_q to exceed this multiple of the SLO before
    # treating it as risk, so a persistently tight bound cannot thrash
    # the composer while observed latency is healthy
    predicted_factor: float = 1.2
    # device-load imbalance (max/mean bucket load of the live placement)
    # above this triggers a RE-PLACE: the makespan is reducible without
    # touching the ensemble, so it pre-empts the costlier recompose
    imbalance_high: float = 1.25
    cooldown_seconds: float = 10.0
    min_samples: int = 20          # served samples needed to act


class AdaptiveController:
    def __init__(self, telemetry: SloTelemetry, swapper: SelectorLadder,
                 recompose_fn: Optional[
                     Callable[[TelemetrySnapshot],
                              Optional[np.ndarray]]] = None,
                 config: Optional[ControllerConfig] = None,
                 service_profile_fn: Optional[
                     Callable[[], Tuple[float, float]]] = None,
                 sync: bool = False,
                 clock: Callable[[], float] = time.monotonic,
                 aux_ladder=None):
        """``service_profile_fn`` returns (mu, T_s) — optionally
        (mu, T_s, placement_imbalance) — of the ACTIVE ensemble so
        snapshots carry the online T_q bound and the live device-load
        balance.

        ``aux_ladder`` is an optional SECOND, cheaper degradation
        ladder (e.g. ``serving.slots.TickLadder`` — tick rate): SHED
        walks it down before touching the member ladder, CLIMB
        restores members first and the aux ladder last (LIFO undo), so
        freshness degrades before accuracy and recovers after it."""
        self.telemetry = telemetry
        self.swapper = swapper
        self.aux_ladder = aux_ladder
        self.recompose_fn = recompose_fn
        # placement is actuatable only when the swapper exposes the
        # RE-PLACE actuator (HotSwapper does; plain ladders do not)
        self._can_replace = callable(getattr(swapper, "re_place", None))
        # signature of a plan a RE-PLACE failed to improve: while the
        # active placement still matches it, the imbalance is inherent
        # (LPT cannot do better), so REPLACE must stand aside instead
        # of re-measuring every step and starving recompose/climb.
        # The brand also records the imbalance it was issued at: live
        # finish-time imbalance GROWING past that level re-arms REPLACE
        # (drifting shard costs can make a once-unimprovable plan
        # improvable)
        self._replace_noop_sig: Optional[bytes] = None
        self._replace_noop_imb: Optional[float] = None
        if config is None:
            config = ControllerConfig(slo_seconds=telemetry.slo)
        elif abs(config.slo_seconds - telemetry.slo) > 1e-12:
            # violation_rate is computed by telemetry against ITS slo;
            # decide() compares p99 against the config's — they must be
            # the same threshold or the two signals contradict
            raise ValueError(
                f"config.slo_seconds={config.slo_seconds} != "
                f"telemetry.slo={telemetry.slo}")
        self.config = config
        self.service_profile_fn = service_profile_fn
        self.sync = sync
        self.clock = clock
        self.log: List[Tuple[float, Decision]] = []
        self.baseline_rate: Optional[float] = None  # rate at last compose
        self.n_recomposes = 0
        self._last_action_t = -float("inf")
        self._recomposing = threading.Event()
        self._recompose_thread: Optional[threading.Thread] = None
        self._replacing = threading.Event()
        self._replace_thread: Optional[threading.Thread] = None
        self._monitor: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.leaked: List[str] = []    # stragglers from the last stop()

    def _active_placement_sig(self) -> Optional[bytes]:
        return placement_signature(
            getattr(self.swapper, "active_placement", None))

    def _replace_branded(self, imbalance: float) -> bool:
        """True while REPLACE must stand aside: the active plan still
        matches the last no-op brand AND the measured imbalance has not
        grown past the level the brand was issued at.  'LPT could not
        do better' is a statement about the costs seen at brand time,
        not a permanent property of the plan — under drift-fed
        re-planning, growth means new evidence."""
        if self._active_placement_sig() != self._replace_noop_sig:
            return False
        return (self._replace_noop_imb is None
                or imbalance <= self._replace_noop_imb + 1e-9)

    # ---------------------------------------------------------- policy
    def decide(self, snap: TelemetrySnapshot) -> Decision:
        """Pure policy (no side effects) — unit-testable in isolation."""
        c = self.config
        if snap.n_served < c.min_samples:
            return Decision.HOLD
        if (snap.violation_rate >= c.violation_high
                or snap.p99 > c.slo_seconds or snap.n_shed > 0):
            return Decision.SHED if self._can_shed_any() \
                else Decision.RECOMPOSE
        if self._can_replace \
                and np.isfinite(snap.placement_imbalance) \
                and snap.placement_imbalance > c.imbalance_high \
                and not self._replace_branded(snap.placement_imbalance):
            return Decision.REPLACE        # rebalance before re-search
        if np.isfinite(snap.predicted_latency) \
                and snap.predicted_latency > c.predicted_factor \
                * c.slo_seconds:
            return Decision.RECOMPOSE          # predicted risk, act early
        if self.baseline_rate and snap.arrival_rate > 0:
            ratio = snap.arrival_rate / self.baseline_rate
            if ratio >= c.drift_factor or ratio <= 1.0 / c.drift_factor:
                return Decision.RECOMPOSE      # load drifted: re-search
        if (snap.violation_rate <= c.violation_low
                and snap.p99 <= c.headroom_frac * c.slo_seconds
                and self._can_climb_any()):
            return Decision.CLIMB
        return Decision.HOLD

    def _can_shed_any(self) -> bool:
        aux = self.aux_ladder
        return self.swapper.can_shed() \
            or (aux is not None and aux.can_shed())

    def _can_climb_any(self) -> bool:
        aux = self.aux_ladder
        return self.swapper.can_climb() \
            or (aux is not None and aux.can_climb())

    def _shed_once(self) -> bool:
        """Aux ladder (freshness) sheds before the member ladder
        (accuracy)."""
        aux = self.aux_ladder
        if aux is not None and aux.can_shed() and aux.shed():
            return True
        return self.swapper.shed()

    def _climb_once(self) -> bool:
        """Members climb back before the aux ladder — LIFO undo of
        ``_shed_once``."""
        if self.swapper.can_climb() and self.swapper.climb():
            return True
        aux = self.aux_ladder
        return aux is not None and aux.climb()

    # ------------------------------------------------------------- act
    def snapshot(self, now: Optional[float] = None) -> TelemetrySnapshot:
        mu = ts = imbalance = None
        if self.service_profile_fn is not None:
            profile = self.service_profile_fn()
            mu, ts = profile[0], profile[1]
            if len(profile) > 2:           # (mu, Ts, imbalance) profile
                imbalance = profile[2]
        # evidence must postdate the last actuation: the violation burst
        # that justified a shed stays in the sliding window for up to
        # window_seconds and must not re-trigger a shed per cooldown,
        # cascading the ladder to the floor
        since = self._last_action_t \
            if np.isfinite(self._last_action_t) else None
        return self.telemetry.snapshot(mu=mu, ts=ts or 0.0, now=now,
                                       since=since, imbalance=imbalance)

    def step(self, now: Optional[float] = None) -> Decision:
        """One control iteration: snapshot, decide, act."""
        now = self.clock() if now is None else now
        if now - self._last_action_t < self.config.cooldown_seconds:
            return Decision.HOLD
        snap = self.snapshot(now)
        if self.baseline_rate is None and snap.arrival_rate > 0:
            self.baseline_rate = snap.arrival_rate
        decision = self.decide(snap)
        acted = False
        if decision is Decision.SHED:
            acted = self._shed_once()
            # find the right ensemble for the new load in the background
            acted = self._launch_recompose(snap) or acted
        elif decision is Decision.CLIMB:
            acted = self._climb_once()
        elif decision is Decision.RECOMPOSE:
            acted = self._launch_recompose(snap)
        elif decision is Decision.REPLACE:
            acted = self._launch_replace(snap)
        if not acted:
            # nothing actually changed (rung race, recompose already in
            # flight): don't log a phantom action or start a cooldown
            # that would delay the real corrective step
            return Decision.HOLD
        self._last_action_t = now
        self.log.append((now, decision))
        return decision

    def decision_counts(self) -> Dict[str, int]:
        """Actions taken so far, keyed by decision name (the exporter's
        ``controller_decisions_total`` source)."""
        out: Dict[str, int] = {}
        for _t, d in list(self.log):
            out[d.value] = out.get(d.value, 0) + 1
        return out

    def _launch_replace(self, snap: TelemetrySnapshot) -> bool:
        """RE-PLACE: live drift costs (or fresh measurement) -> fresh
        LPT plan -> hot-swap the same selector onto the new shards.
        Like recompose, the expensive measure+stage runs in a daemon
        thread (``sync=False``) so the monitor loop stays free to SHED
        mid-rebalance; ``sync=True`` actuates inline and returns
        whether the plan actually changed (a no-op must not start a
        cooldown).

        A plan re_place could not improve is remembered by signature —
        plus the imbalance it was tried at — so REPLACE is not
        re-tried (re-measuring every step would starve recompose/
        climb) until the placement changes some other way or the
        measured imbalance grows past the branded level; a signature
        that moved underneath (re_place lost a race to a selector
        swap) means the never-tried new placement must not inherit the
        no-op brand."""
        if self._replacing.is_set():
            return False
        self._replacing.set()
        sig_before = self._active_placement_sig()
        imb_at_decision = snap.placement_imbalance

        def run() -> bool:
            try:
                acted = self.swapper.re_place()
                noop = (not acted
                        and self._active_placement_sig() == sig_before)
                self._replace_noop_sig = sig_before if noop else None
                self._replace_noop_imb = \
                    imb_at_decision if noop else None
                return acted
            finally:
                self._replacing.clear()

        if self.sync:
            return run()
        self._replace_thread = threading.Thread(
            target=run, daemon=True, name="repro-ctl-replace")
        self._replace_thread.start()
        return True

    def _launch_recompose(self, snap: TelemetrySnapshot) -> bool:
        """Returns True iff a recompose was actually started."""
        if self.recompose_fn is None or self._recomposing.is_set():
            return False
        self._recomposing.set()
        if self.sync:
            try:
                self._recompose(snap)
            finally:
                self._recomposing.clear()
            return True

        def run():
            try:
                self._recompose(snap)
            finally:
                self._recomposing.clear()
        self._recompose_thread = threading.Thread(
            target=run, daemon=True, name="repro-ctl-recompose")
        self._recompose_thread.start()
        return True

    def _recompose(self, snap: TelemetrySnapshot) -> None:
        selector = self.recompose_fn(snap)
        self.n_recomposes += 1
        self.baseline_rate = snap.arrival_rate or self.baseline_rate
        sharded = self._can_replace and getattr(self.swapper,
                                                "sharded", False)
        if selector is not None and not np.array_equal(
                np.asarray(selector, np.int8),
                self.swapper.active_selector):
            if sharded:
                # a recompose re-derives the LPT plan too: freshen the
                # new selector's placement so the swap lands on a plan
                # built from current measured costs, not a stale cache
                self.swapper.placement_for(
                    np.asarray(selector, np.int8), fresh=True)
            self.swapper.swap_to(selector)
        elif sharded:
            # incumbent kept: load still changed enough to recompose,
            # so rebalance the shards under the same selector
            self.swapper.re_place()

    def join_recompose(self, timeout: float = 60.0) -> bool:
        """Wait for the background recompose to finish.  Returns True
        iff no recompose thread is (still) running — a timed-out join is
        reported, never silently swallowed."""
        t = self._recompose_thread
        if t is None:
            return True
        t.join(timeout)
        if t.is_alive():
            log.warning("join_recompose: %s still running after %.1fs",
                        t.name, timeout)
            return False
        return True

    # --------------------------------------------------- monitor loop
    def start(self, period_seconds: float = 1.0) -> "AdaptiveController":
        """Run ``step()`` on a background monitor thread every
        ``period_seconds`` — the live control loop.  Works against any
        telemetry feed; wired to a real ``EnsembleServer`` via
        ``control.faults.wire_controller`` (the server taps telemetry,
        this loop actuates shed/climb/recompose/re-place on it)."""
        def loop():
            while not self._stop.wait(period_seconds):
                self.step()
        self._monitor = threading.Thread(target=loop, daemon=True,
                                         name="repro-ctl-monitor")
        self._monitor.start()
        return self

    def stop(self, timeout: float = 5.0) -> bool:
        """Stop the monitor loop and wait for every background thread
        (monitor, recompose, replace).  Returns True iff they all
        actually exited; stragglers are listed by name in
        ``self.leaked`` and logged — a chaos harness treats a non-empty
        list as a leaked-thread failure."""
        self._stop.set()
        leaked: List[str] = []
        if self._monitor is not None:
            self._monitor.join(timeout=timeout)
            if self._monitor.is_alive():
                leaked.append(self._monitor.name)
        if not self.join_recompose(timeout=timeout):
            leaked.append("repro-ctl-recompose")
        t = self._replace_thread
        if t is not None:
            t.join(timeout=timeout)
            if t.is_alive():
                leaked.append(t.name)
        self.leaked = leaked
        if leaked:
            log.warning("controller stop(): threads still alive: %s",
                        leaked)
        return not leaked


@dataclasses.dataclass(frozen=True)
class TieredControllerConfig(ControllerConfig):
    # cross-tier device budget: predicted utilization
    # rho = sum_t lambda_t * c_t / n_devices above this is treated as
    # overload (shed pre-emptively) and no climb may push rho past it —
    # the guard that keeps a stable-tier climb from eating the critical
    # tier's headroom
    rho_max: float = 0.85
    # shed at most this many rungs per control step when the PREDICTED
    # budget says one rung is not enough (e.g. floor the stable tier in
    # one actuation during a census spike); observed-only overload
    # (no cost model) always sheds a single rung
    max_sheds_per_step: int = 4


class TieredController:
    """Priority-aware per-tier shed/climb over a fixed ladder family.

    One control step reads the FLEET snapshot (all tiers share the
    device pool, so violations and queueing are fleet phenomena) plus
    per-tier arrival rates, and actuates ONE tier's ladder:

    * overload (observed violations / p99 / sheds, or predicted budget
      ``rho > rho_max``) — shed the LOWEST-priority tier that still
      can; the top (critical) tier sheds only when every lower tier is
      at its floor AND the predicted bound leaves no alternative
      (even lower tiers floored, ``rho >= 1``: the backlog would grow
      without bound, so T_s + T_q crosses any SLO) — or queries are
      already being dropped (``n_shed > 0``);
    * health (violations low, p99 under headroom) — climb the
      HIGHEST-priority tier first, gated by the budget (post-climb
      ``rho <= rho_max``) and by shed-order monotonicity (a tier never
      climbs past the rung of a higher-acuity tier);
    * otherwise hold.

    ``swappers`` maps tier -> ``SelectorLadder`` (a ``TieredEnsemble``'s
    swappers, or no-op DES ladders in a bench; the reference calls
    them ``lanes``); ``tier_order`` is
    shed-first -> shed-last.  ``cost_fn(selector)`` returns device-
    seconds per query for a selector — with it the controller predicts
    rho; without it only observed signals act.  The shed-order invariant
    (monotone rungs along ``tier_order``) is re-established on every
    step and preserved by every action this controller takes.
    """

    def __init__(self, telemetry, swappers,
                 tier_order: Optional[Sequence[str]] = None,
                 config: Optional[TieredControllerConfig] = None,
                 cost_fn: Optional[
                     Callable[[np.ndarray], float]] = None,
                 n_devices: int = 1,
                 clock: Callable[[], float] = time.monotonic):
        self.telemetry = telemetry
        self.swappers = dict(swappers)
        order = tuple(tier_order) if tier_order is not None \
            else tuple(getattr(telemetry, "tiers", ()))
        if not order:
            order = tuple(self.swappers)
        if set(order) != set(self.swappers):
            raise ValueError(f"tier_order {order} != swappers "
                             f"{tuple(self.swappers)}")
        self.order = order
        tel_slo = getattr(telemetry, "slo", None)
        if config is None:
            config = TieredControllerConfig(
                slo_seconds=tel_slo if tel_slo is not None else 1.0)
        elif tel_slo is not None \
                and abs(config.slo_seconds - tel_slo) > 1e-12:
            # violation_rate is computed by telemetry against ITS slo;
            # decide() compares p99 against the config's — mixed
            # thresholds would make the two overload signals contradict
            raise ValueError(
                f"config.slo_seconds={config.slo_seconds} != "
                f"telemetry.slo={tel_slo}")
        self.config = config
        self.cost_fn = cost_fn
        self.n_devices = max(1, n_devices)
        self.clock = clock
        self.log: List[Tuple[float, str, Decision]] = []
        self._last_action_t = -float("inf")

    # ---------------------------------------------------------- reading
    def rungs(self) -> dict:
        return {t: self.swappers[t].ladder_pos for t in self.order}

    def monotone(self) -> bool:
        return rungs_monotone(self.swappers, self.order)

    def _rho(self, rates, floor_below: Optional[str] = None) -> float:
        """Predicted device utilization.  ``floor_below=t`` prices every
        tier BELOW t at its ladder-floor cost — the 'no alternative'
        probe: would flooring all lower tiers restore feasibility?"""
        if self.cost_fn is None:
            return float("nan")
        work = 0.0
        below = set()
        if floor_below is not None:
            below = set(self.order[:self.order.index(floor_below)])
        for t in self.order:
            sw = self.swappers[t]
            if t in below and sw.ladder:
                sel = sw.ladder[0]
            else:
                sel = sw.active_selector
            work += rates.get(t, 0.0) * float(self.cost_fn(sel))
        return work / self.n_devices

    def _climb_ok(self, tier: str, rates) -> bool:
        """Budget + monotonicity gate for climbing ``tier`` one rung."""
        sw = self.swappers[tier]
        if not sw.can_climb():
            return False
        new_pos = sw.ladder_pos + 1
        for higher in self.order[self.order.index(tier) + 1:]:
            if new_pos > self.swappers[higher].ladder_pos:
                return False          # would out-rank a higher tier
        if self.cost_fn is not None:
            rungs = sw.ladder
            delta = rates.get(tier, 0.0) * (
                float(self.cost_fn(rungs[new_pos]))
                - float(self.cost_fn(sw.active_selector)))
            if self._rho(rates) + delta / self.n_devices \
                    > self.config.rho_max:
                return False          # climb would eat shared headroom
        return True

    # ----------------------------------------------------------- policy
    def decide(self, fleet: TelemetrySnapshot,
               rates: dict) -> Tuple[Decision, Optional[str]]:
        """Pure policy: (decision, tier) for the current evidence."""
        c = self.config
        if fleet.n_served < c.min_samples:
            return Decision.HOLD, None
        rho = self._rho(rates)
        observed = (fleet.violation_rate >= c.violation_high
                    or fleet.p99 > c.slo_seconds or fleet.n_shed > 0)
        predicted = np.isfinite(rho) and rho > c.rho_max
        if observed or predicted:
            for t in self.order[:-1]:          # stable beds shed first
                if self.swappers[t].can_shed():
                    return Decision.SHED, t
            top = self.order[-1]
            if self.swappers[top].can_shed() and self._no_alternative(
                    fleet, rates):
                return Decision.SHED, top
            return Decision.HOLD, None
        if (fleet.violation_rate <= c.violation_low
                and fleet.p99 <= c.headroom_frac * c.slo_seconds):
            for t in reversed(self.order):     # critical climbs first
                if self._climb_ok(t, rates):
                    return Decision.CLIMB, t
        return Decision.HOLD, None

    def _no_alternative(self, fleet: TelemetrySnapshot,
                        rates: dict) -> bool:
        """May the top tier shed?  Only when the predicted bound says
        flooring every lower tier still cannot restore feasibility
        (rho >= 1 with lower tiers priced at their floors — queueing
        would diverge, so predicted T_s + T_q crosses any SLO), or
        queries are already being dropped."""
        if fleet.n_shed > 0:
            return True
        rho_floor = self._rho(rates, floor_below=self.order[-1])
        if np.isfinite(rho_floor):
            return rho_floor >= 1.0
        # no cost model: observed overload with every lower tier at its
        # floor (decide() only reaches here in that state) must still
        # be actionable
        return (fleet.violation_rate >= self.config.violation_high
                or fleet.p99 > self.config.slo_seconds)

    # -------------------------------------------------------------- act
    def step(self, now: Optional[float] = None
             ) -> List[Tuple[Decision, str]]:
        """One control iteration; returns the (decision, tier) actions
        taken (empty == hold).  When the predicted budget is the
        overload signal, shedding repeats (priority order, up to
        ``max_sheds_per_step``) until rho fits — one census spike can
        floor the stable tier in a single actuation instead of bleeding
        a rung per step."""
        now = self.clock() if now is None else now
        if now - self._last_action_t < self.config.cooldown_seconds:
            return []
        since = self._last_action_t \
            if np.isfinite(self._last_action_t) else None
        fleet = self.telemetry.snapshot(now=now, since=since)
        rates = {t: self.telemetry.tier_snapshot(
            t, now=now, since=since).arrival_rate for t in self.order}
        actions: List[Tuple[Decision, str]] = []
        for _ in range(max(1, self.config.max_sheds_per_step)):
            decision, tier = self.decide(fleet, rates)
            if decision is Decision.HOLD or tier is None:
                break
            acted = self.swappers[tier].shed() \
                if decision is Decision.SHED else self.swappers[tier].climb()
            if not acted:
                break
            self.log.append((now, tier, decision))
            actions.append((decision, tier))
            if decision is Decision.CLIMB:
                break                  # climbs are always one at a time
            rho = self._rho(rates)
            if not np.isfinite(rho):
                break                  # observed-only: single shed
            if rho <= self.config.rho_max:
                break                  # budget restored: stop shedding
        if actions:
            self._last_action_t = now
        return actions

    def decision_counts(self) -> Dict[str, int]:
        """Actions taken so far, keyed by ``tier/decision`` (the
        exporter's ``controller_decisions_total`` source)."""
        out: Dict[str, int] = {}
        for _t, tier, d in list(self.log):
            key = f"{tier}/{d.value}"
            out[key] = out.get(key, 0) + 1
        return out
