"""Discrete-event simulation of the HOLMES serving pipeline (§4.1.2):
the port of ``repro/serving/simulator.py``, which keeps its
``numpy.random.Generator`` draws in the same order, so the same seed
gives the same run.

Replaces the paper's client-node/HTTP/RPC testbed with a deterministic,
seedable event simulation of the SAME pipeline: per-patient multi-modal
streams -> stateful aggregators -> observation-window queries -> model
queue -> device pool running the ensemble -> bagging combine.

Used for (a) Fig. 9 online-vs-offline, (b) Fig. 10 scalability sweeps,
(c) the measured-mode latency profiler, and (d) validating the network-
calculus T_q bound against empirical queueing delays.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.queues import TimestampedQueue

SAMPLE, WINDOW, DEVICE_FREE, FLUSH, CENSUS = range(5)


@dataclasses.dataclass
class SimConfig:
    n_patients: int = 64
    n_devices: int = 2
    window_seconds: float = 30.0
    duration_seconds: float = 120.0
    ingest_hz: float = 250.0          # per-patient waveform rate
    chunk_seconds: float = 0.2        # HTTP flush granularity
    batch_period: float = 0.0         # >0 => offline batch mode (Fig. 9)
    dispatch_overhead: float = 0.0005
    seed: int = 0
    # churn mode: piecewise-constant TARGET census [(t, n_active), ...].
    # Overrides n_patients; admissions/discharges happen at each step
    # (deterministic under seed: phases drawn in event order, discharges
    # LIFO).  None => the original static-cohort behaviour, untouched.
    census: Optional[Sequence[Tuple[float, int]]] = None
    # scales admission phase jitter: 1.0 = phases uniform over a window
    # (desynchronized beds), 0.0 = a step admission fires all its new
    # patients' windows at the same instant (thundering-herd burst)
    churn_phase_jitter: float = 1.0
    # epoch mode: cut the run at duration_seconds instead of draining —
    # queries that never started by the cutoff are returned as
    # ``SimResult.backlog`` (ages) for the NEXT epoch's ``simulate``
    # call to ingest at t=0, so sustained overload accumulates across
    # epoch boundaries instead of resetting.  False keeps the original
    # drain-to-empty behaviour, untouched.
    carry_backlog: bool = False
    # acuity tiers: admission-fraction per tier, keys ordered lowest ->
    # highest acuity (e.g. {"stable": .6, "elevated": .25,
    # "critical": .15}).  When set, ``model_costs`` must be a mapping
    # tier -> per-member cost list: each query is stamped with its
    # patient's CURRENT tier at window close and served with THAT
    # tier's ensemble (the DES twin of per-tier selector routing).
    # None => the original untiered behaviour, bit-identical.
    tiers: Optional[Dict[str, float]] = None
    # per-window hazard that a sub-top-tier patient escalates ONE tier
    # at a window close (mid-stay acuity escalation, e.g. a stable bed
    # deteriorating); drawn in event order, deterministic under seed
    escalate_hazard: float = 0.0


@dataclasses.dataclass
class QueryRecord:
    patient: int
    t_window: float                   # when the window closed (query born)
    t_start: float = 0.0              # first model began executing
    t_done: float = 0.0              # last model finished
    n_models: int = 0
    tier: str = ""                    # acuity tier at birth (tiered mode)

    @property
    def latency(self) -> float:
        return self.t_done - self.t_window

    @property
    def queue_delay(self) -> float:
        return self.t_start - self.t_window


@dataclasses.dataclass
class SimResult:
    queries: List[QueryRecord]
    arrivals: np.ndarray              # query birth times
    ingest_events: int
    device_busy: float
    duration: float
    queue_stats: Dict[str, object]
    # churn mode only: patient -> (t_admit, t_discharge, phase); the
    # discharge time is +inf for patients active at the end of the run
    patients: Dict[int, Tuple[float, float, float]] = \
        dataclasses.field(default_factory=dict)
    churn_log: List[Tuple[float, str, int]] = \
        dataclasses.field(default_factory=list)
    # carry_backlog mode: ages (seconds since birth, measured at the
    # cutoff) of queries that never started service this epoch — feed
    # them to the next epoch's ``simulate(..., backlog=)``
    backlog: np.ndarray = dataclasses.field(
        default_factory=lambda: np.asarray([]))
    # tiered mode: the carried queries' tiers, aligned with ``backlog``
    # (a carried query keeps the tier it was born with), and the acuity
    # trail — (t, patient, old_tier, new_tier), old == "" at admission
    backlog_tiers: List[str] = dataclasses.field(default_factory=list)
    tier_log: List[Tuple[float, int, str, str]] = \
        dataclasses.field(default_factory=list)

    def latencies(self) -> np.ndarray:
        return np.asarray([q.latency for q in self.queries])

    def queue_delays(self) -> np.ndarray:
        return np.asarray([q.queue_delay for q in self.queries])

    def p(self, pct: float) -> float:
        lat = self.latencies()
        return float(np.percentile(lat, pct)) if len(lat) else 0.0

    @property
    def utilization(self) -> float:
        return self.device_busy / max(self.duration, 1e-9)


def simulate(model_costs, cfg: SimConfig,
             backlog: Sequence[float] = (),
             backlog_tiers: Sequence[str] = ()) -> SimResult:
    """model_costs: seconds/query for each SELECTED ensemble member —
    or, with ``cfg.tiers``, a mapping tier -> cost list (each query is
    served with its birth-tier's ensemble).
    ``backlog``: ages of queries carried in from a previous epoch
    (``SimResult.backlog``); they enter the model queue at t=0 with
    negative birth times, so their end-to-end latency keeps
    accumulating across the epoch edge and is never double-counted —
    the carrying epoch returns them unserved, the serving epoch
    retires them exactly once.  ``backlog_tiers`` aligns tiers with
    those ages in tiered mode."""
    if cfg.carry_backlog and cfg.batch_period > 0:
        # batch mode schedules its final FLUSH past duration_seconds,
        # so held queries would be served beyond the epoch edge instead
        # of carried — the combination has no coherent epoch semantics
        raise ValueError("carry_backlog is incompatible with "
                         "batch_period > 0")
    rng = np.random.default_rng(cfg.seed)
    tiered = cfg.tiers is not None
    if tiered:
        tier_names = list(cfg.tiers)
        fracs = np.asarray([cfg.tiers[t] for t in tier_names],
                           np.float64)
        if fracs.sum() <= 0:
            raise ValueError("tier fractions must sum to > 0")
        fracs = fracs / fracs.sum()
        costs_by_tier = {t: list(model_costs[t]) for t in tier_names}
        if len(backlog) and len(backlog_tiers) != len(backlog):
            raise ValueError("tiered backlog needs one tier per age")
        costs = None
    else:
        if cfg.escalate_hazard:
            raise ValueError("escalate_hazard requires cfg.tiers")
        costs = list(model_costs)
    tier_now: Dict[int, str] = {}
    tier_log: List[Tuple[float, int, str, str]] = []

    def assign_tier(now: float, p: int) -> None:
        t = tier_names[int(rng.choice(len(tier_names), p=fracs))]
        tier_now[p] = t
        tier_log.append((now, p, "", t))

    def maybe_escalate(now: float, p: int) -> None:
        """Mid-stay acuity escalation, drawn at window close BEFORE the
        query is stamped (the deteriorating bed's next prediction is
        already served at the higher tier)."""
        if not cfg.escalate_hazard:
            return
        cur = tier_now[p]
        i = tier_names.index(cur)
        if i + 1 >= len(tier_names):
            return
        if rng.uniform() < cfg.escalate_hazard:
            tier_now[p] = tier_names[i + 1]
            tier_log.append((now, p, cur, tier_names[i + 1]))

    events: List[Tuple[float, int, int, tuple]] = []
    counter = itertools.count()

    def push(t: float, kind: int, payload: tuple = ()):
        heapq.heappush(events, (t, next(counter), kind, payload))

    # -------------------------------------------------- patient cohort
    churn = cfg.census is not None
    active: set = set()
    admit_t: Dict[int, float] = {}
    discharge_t: Dict[int, float] = {}
    phase_of: Dict[int, float] = {}
    churn_log: List[Tuple[float, str, int]] = []
    pid_counter = itertools.count()

    def admit(now: float, k: int):
        for _ in range(k):
            p = next(pid_counter)
            ph = float(rng.uniform(0, cfg.window_seconds)) \
                * cfg.churn_phase_jitter
            phase_of[p], admit_t[p] = ph, now
            active.add(p)
            churn_log.append((now, "admit", p))
            if tiered:
                assign_tier(now, p)
            t1 = now + ph + cfg.window_seconds
            if t1 <= cfg.duration_seconds:
                push(t1, WINDOW, (p,))

    def discharge(now: float, k: int):
        # LIFO (most recent admissions leave first): deterministic
        for p in sorted(active, reverse=True)[:k]:
            active.discard(p)
            discharge_t[p] = now
            churn_log.append((now, "discharge", p))

    if churn:
        # census steps drive admissions/discharges; windows are
        # scheduled incrementally per active patient
        for t_c, n_target in cfg.census:
            push(t_c, CENSUS, (int(n_target),))
    else:
        # static cohort: schedule all window closures up front
        phases = rng.uniform(0, cfg.window_seconds, cfg.n_patients)
        if tiered:                     # draws AFTER phases: the untiered
            for p in range(cfg.n_patients):   # stream stays bit-identical
                assign_tier(0.0, p)
        for p in range(cfg.n_patients):
            t = phases[p] + cfg.window_seconds
            while t <= cfg.duration_seconds:
                push(t, WINDOW, (p,))
                t += cfg.window_seconds
    # batch mode: queries are held and flushed every batch_period
    if cfg.batch_period > 0:
        t = cfg.batch_period
        while t <= cfg.duration_seconds + cfg.batch_period:
            push(t, FLUSH, ())
            t += cfg.batch_period

    ingest_events = int(cfg.duration_seconds / cfg.chunk_seconds
                        * cfg.n_patients)

    model_q = TimestampedQueue("models")
    held: List[QueryRecord] = []
    queries: List[QueryRecord] = []
    free_devices = cfg.n_devices
    device_busy = 0.0

    def enqueue_query(rec: QueryRecord, now: float):
        # tiered: the query is served by its BIRTH tier's ensemble — the
        # conservation invariant "never answered by the wrong tier's
        # selector" is structural here
        c_list = costs_by_tier[rec.tier] if tiered else costs
        rec.n_models = len(c_list)
        rec._remaining = len(c_list)          # type: ignore[attr-defined]
        rec.t_start = -1.0
        queries.append(rec)
        for c in c_list:
            model_q.push(now, (rec, c))

    def try_dispatch(now: float):
        nonlocal free_devices, device_busy
        while free_devices > 0 and len(model_q):
            task = model_q.pop(now)
            rec, c = task
            if rec.t_start < 0:
                rec.t_start = now
            free_devices -= 1
            device_busy += c
            push(now + c + cfg.dispatch_overhead, DEVICE_FREE, (rec,))

    # backlog carried in from the previous epoch: already-born queries
    # join the model queue at t=0, ahead of this epoch's first window
    # (a carried query keeps its birth tier)
    for k, age in enumerate(backlog):
        enqueue_query(QueryRecord(
            patient=-(k + 1), t_window=-float(age),
            tier=backlog_tiers[k] if tiered else ""), 0.0)
    if len(backlog):
        try_dispatch(0.0)

    closed = False                     # carry_backlog epoch cutoff hit

    while events:
        now, _, kind, payload = heapq.heappop(events)
        if cfg.carry_backlog and not closed \
                and now > cfg.duration_seconds:
            # epoch edge: queries already in service run to completion
            # (their queued tasks stay), never-started queries carry
            # over whole — no partial work is redone or double-served
            closed = True
            model_q.retain(lambda task: task[0].t_start >= 0)
        if kind == CENSUS:
            target = payload[0]
            if target > len(active):
                admit(now, target - len(active))
            elif target < len(active):
                discharge(now, len(active) - target)
        elif kind == WINDOW:
            p = payload[0]
            if churn:
                if p not in active:
                    continue              # discharged: window dropped
                if now + cfg.window_seconds <= cfg.duration_seconds:
                    push(now + cfg.window_seconds, WINDOW, (p,))
            if tiered:
                maybe_escalate(now, p)    # before stamping the query
            rec = QueryRecord(patient=p, t_window=now,
                              tier=tier_now.get(p, "") if tiered else "")
            if cfg.batch_period > 0:
                held.append(rec)
            else:
                enqueue_query(rec, now)
                try_dispatch(now)
        elif kind == FLUSH:
            for rec in held:
                enqueue_query(rec, now)
            held.clear()
            try_dispatch(now)
        elif kind == DEVICE_FREE:
            rec = payload[0]
            rec._remaining -= 1               # type: ignore[attr-defined]
            if rec._remaining == 0:
                rec.t_done = now
            free_devices += 1
            try_dispatch(now)

    if churn:
        ingest_events = int(sum(
            (min(discharge_t.get(p, cfg.duration_seconds),
                 cfg.duration_seconds) - t_a) / cfg.chunk_seconds
            for p, t_a in admit_t.items()))
    done = [q for q in queries if q.t_done > 0]
    # oldest first, so the next epoch's FIFO serves in birth order
    carried = sorted(((cfg.duration_seconds - q.t_window, q.tier)
                      for q in queries if q.t_done <= 0),
                     key=lambda at: -at[0]) \
        if cfg.carry_backlog else []
    return SimResult(
        queries=done,
        arrivals=np.asarray(sorted(q.t_window for q in queries)),
        ingest_events=ingest_events,
        device_busy=device_busy,
        duration=cfg.duration_seconds,
        queue_stats={"models": model_q.waits()},
        patients={p: (t_a, discharge_t.get(p, float("inf")), phase_of[p])
                  for p, t_a in admit_t.items()},
        churn_log=churn_log,
        backlog=np.asarray([a for a, _ in carried]),
        backlog_tiers=[t for _, t in carried],
        tier_log=tier_log)
