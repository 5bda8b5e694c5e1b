"""Live SLO telemetry for the serving hot path (the control plane's
sensor): the port of ``repro/control/telemetry.py``.

``SloTelemetry`` is the tap the data plane feeds — pass it to
``EnsembleServer(telemetry=...)`` (every ingest is an arrival, every
retired query a latency sample, every full-queue rejection a shed) or
drive it explicitly when replaying a DES trace.  Over a sliding window
it derives:

* p50/p99 latency and the SLO violation rate;
* an arrival-rate estimate (queries/s over the window);
* the ONLINE empirical arrival curve and the network-calculus T_q
  bound — the same alpha/beta machinery ``serving/latency.py`` uses
  offline (§3.4, Fig. 5), now fed by the observed trace so the
  controller can predict queueing risk before violations materialize.

Two interchangeable engines back the same API:

* the default is a **mergeable windowed sketch**
  (``obs.sketch.WindowedSketch``): a ring of sub-window buckets, each
  holding exact event counters plus a log-spaced latency histogram,
  so memory is a CONSTANT block regardless of trace length — the
  week-long-soak / multi-host prerequisite.  Counts, violation rate
  and arrival rate stay EXACT (violations are classified at record
  time); window expiry and ``since=`` cuts resolve at bucket
  granularity (error <= one bucket width); p50/p99 carry the
  histogram's relative-error bound (``obs.sketch.REL_ERR_BOUND``,
  ~5.8%); the T_q bound is computed exactly on the bucket-grouped
  trace, over-shooting the raw-trace bound by at most one bucket
  width.  Same-shape sketches MERGE by aligned sum —
  ``SloTelemetry.merge`` — which is how ``TieredTelemetry`` now
  derives its fleet view and how multi-host telemetry will compose.

* ``exact=True`` keeps raw timestamps (head-compacted sorted lists) —
  the O(window-events) oracle the equivalence suite compares against,
  with ``since=`` cuts resolved by bisect instead of the old O(n)
  filtering under the lock.

All mutations and reads are lock-guarded; ``snapshot()`` is the
consistent view the controller consumes.  The clock is injectable so
the DES and unit tests can drive virtual time.

``TieredTelemetry`` adds the per-acuity-tier dimension: one slice per
tier, routed by the patient id every query already carries
(``tier_of``) or by an explicit ``tier=``.  The fleet view is a
DERIVED merge of the slices — there is no duplicate fleet feed to
drift out of sync with its parts.
"""
from __future__ import annotations

import bisect
import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs import sketch as _sk
from repro_torch.obs.sketch import WindowedSketch
from repro_torch.serving.latency import arrival_curve, queueing_bound

DEFAULT_N_BUCKETS = 128
_MIN_BUCKETS, _MAX_BUCKETS = 64, 1024


def auto_n_buckets(window_seconds: float, slo_seconds: float) -> int:
    """Sub-window bucket count whose width stays <= slo/16: every
    sketch coarsening (window expiry, ``since`` cuts, T_q grouping) is
    bounded by ONE bucket width, so sizing buckets against the SLO
    keeps that error far inside the controller's decision margins
    (e.g. the 0.2*slo headroom of the predicted-latency trigger)
    regardless of how long the window is.  Clamped to [64, 1024]
    buckets — worst case ~1 MB of counters, still O(1) in trace
    length."""
    if slo_seconds <= 0 or window_seconds <= 0:
        return DEFAULT_N_BUCKETS
    want = 16.0 * window_seconds / slo_seconds
    n = _MIN_BUCKETS
    while n < want and n < _MAX_BUCKETS:
        n *= 2
    return n


@dataclasses.dataclass(frozen=True)
class TelemetrySnapshot:
    """One consistent reading of the sliding window."""
    t: float
    window_seconds: float
    n_arrivals: int
    n_served: int
    n_shed: int
    arrival_rate: float            # queries/s over the effective window
    p50: float
    p99: float
    violation_rate: float          # frac of served with latency > SLO
    ts: float = float("nan")       # active selector's T_s (if provided)
    tq_bound: float = float("nan")  # online network-calculus T_q bound
    # max/mean bucket load of the ACTIVE device placement (1.0 ==
    # balanced; nan when unsharded / no profile): the RE-PLACE signal
    placement_imbalance: float = float("nan")
    # NaN-scored retirements (poisoned / stale / stall-killed queries)
    # in the window: the chaos-drill health signal — served but carrying
    # no usable score
    n_failed: int = 0

    @property
    def predicted_latency(self) -> float:
        """T-hat = T_s + T_q from the ONLINE arrival curve (nan when no
        service profile was supplied to ``snapshot``)."""
        return self.ts + self.tq_bound


@dataclasses.dataclass
class _WindowSummary:
    n_arrivals: int
    n_served: int
    n_shed: int
    n_failed: int
    p50: float
    p99: float
    violation_rate: float
    tq_bound: float


class _EventLog:
    """Sorted timestamp log with a head offset: near-sorted feeds
    insert at (or close to) the tail, pruning advances the head by
    bisect, and the backing list is compacted only when the dead head
    outgrows the live half — O(log n) cuts, amortized O(1) prune."""

    __slots__ = ("ts", "vals", "h")

    def __init__(self, with_vals: bool = False):
        self.ts: List[float] = []
        self.vals: Optional[List[float]] = [] if with_vals else None
        self.h = 0

    def add(self, t: float, val: Optional[float] = None) -> None:
        if not self.ts or t >= self.ts[-1]:
            self.ts.append(t)
            if self.vals is not None:
                self.vals.append(val)
            return
        i = bisect.bisect_right(self.ts, t, lo=self.h)
        self.ts.insert(i, t)
        if self.vals is not None:
            self.vals.insert(i, val)

    def prune(self, cut: float) -> None:
        self.h = bisect.bisect_right(self.ts, cut, lo=self.h)
        if self.h > 32 and self.h * 2 > len(self.ts):
            del self.ts[:self.h]
            if self.vals is not None:
                del self.vals[:self.h]
            self.h = 0

    def cut_index(self, since: float) -> int:
        return bisect.bisect_right(self.ts, since, lo=self.h)

    def __len__(self) -> int:
        return len(self.ts) - self.h

    def times(self, since: Optional[float] = None) -> List[float]:
        lo = self.h if since is None else self.cut_index(since)
        return self.ts[lo:]

    def values(self, since: Optional[float] = None) -> List[float]:
        lo = self.h if since is None else self.cut_index(since)
        return self.vals[lo:]


class _ExactEngine:
    """Raw-timestamp oracle (the pre-sketch behaviour, with bisect
    ``since`` cuts).  Memory is O(window events)."""

    exact = True

    def __init__(self, window: float):
        self.window = window
        self.arrivals = _EventLog()
        self.served = _EventLog(with_vals=True)
        self.shed = _EventLog()
        self.failed = _EventLog()
        self.t0: Optional[float] = None
        self.hwm = -float("inf")

    def _in_window(self, t: float) -> bool:
        # an event already older than the window behind the high-water
        # mark is rejected at RECORD time: keeping it would dodge the
        # head prune and skew counts/rates for up to a full window
        return t > self.hwm - self.window

    def _note(self, t: float) -> None:
        if self.t0 is None:
            self.t0 = t

    def prune(self, now: float) -> None:
        # prune against the high-water mark, not the raw event time: a
        # slightly out-of-order feed (threaded taps, DES replay) must
        # never let the cut regress — memory stays O(window) behind
        # the NEWEST event
        self.hwm = now = max(self.hwm, now)
        cut = now - self.window
        for log in (self.arrivals, self.served, self.shed, self.failed):
            log.prune(cut)

    def record(self, kind: int, t: float,
               latency: Optional[float] = None,
               violated: bool = False) -> None:
        self._note(t)
        if self._in_window(t):
            if kind == _sk.SERVED:
                self.served.add(t, float(latency))
            elif kind == _sk.ARRIVALS:
                self.arrivals.add(t)
            elif kind == _sk.SHED:
                self.shed.add(t)
            else:
                self.failed.add(t)
        self.prune(t)

    # ------------------------------------------------------------- read
    def arrival_times(self, now: float,
                      since: Optional[float] = None) -> np.ndarray:
        self.prune(now)
        return np.asarray(self.arrivals.times(since), np.float64)

    def latency_values(self, now: float,
                       since: Optional[float] = None) -> np.ndarray:
        self.prune(now)
        return np.asarray(self.served.values(since), np.float64)

    def tq(self, mu: float, T0: float, now: float,
           since: Optional[float] = None) -> float:
        return queueing_bound(self.arrival_times(now, since), mu, T0)

    def summary(self, now: float, since: Optional[float],
                slo: float, mu: Optional[float]) -> _WindowSummary:
        self.prune(now)
        arr = np.asarray(self.arrivals.times(since), np.float64)
        lat = np.asarray(self.served.values(since), np.float64)
        n_shed = len(self.shed.times(since)) if since is not None \
            else len(self.shed)
        n_failed = len(self.failed.times(since)) if since is not None \
            else len(self.failed)
        p50 = float(np.percentile(lat, 50)) if len(lat) else 0.0
        p99 = float(np.percentile(lat, 99)) if len(lat) else 0.0
        viol = float(np.mean(lat > slo)) if len(lat) else 0.0
        tq = float("nan")
        if mu is not None:
            tq = queueing_bound(arr, mu, 0.0)
        return _WindowSummary(len(arr), len(lat), n_shed, n_failed,
                              p50, p99, viol, tq)

    def latency_histogram(self, now: float) -> Optional[np.ndarray]:
        return None

    def absorb(self, other: "_ExactEngine") -> None:
        hwm = max(self.hwm, other.hwm)
        for mine, theirs in ((self.arrivals, other.arrivals),
                             (self.shed, other.shed),
                             (self.failed, other.failed)):
            for t in theirs.times():
                mine.add(t)
        for t, v in zip(other.served.times(), other.served.values()):
            self.served.add(t, v)
        if other.t0 is not None:
            self.t0 = other.t0 if self.t0 is None \
                else min(self.t0, other.t0)
        self.prune(hwm)


class _SketchEngine:
    """Windowed-sketch sensor: O(1) memory, mergeable."""

    exact = False

    def __init__(self, window: float, n_buckets: int):
        self.sk = WindowedSketch(window, n_buckets=n_buckets)

    @property
    def t0(self) -> Optional[float]:
        return self.sk.t0

    @property
    def hwm(self) -> float:
        return self.sk.hwm

    def prune(self, now: float) -> None:
        pass            # expiry is resolved at read time by bucket cuts

    def record(self, kind: int, t: float,
               latency: Optional[float] = None,
               violated: bool = False) -> None:
        self.sk.add(kind, t, latency=latency, violated=violated)

    def arrival_times(self, now: float,
                      since: Optional[float] = None) -> np.ndarray:
        return self.sk.arrival_times(now, since)

    def latency_values(self, now: float,
                       since: Optional[float] = None) -> np.ndarray:
        return self.sk.latency_values(now, since)

    def tq(self, mu: float, T0: float, now: float,
           since: Optional[float] = None) -> float:
        return self.sk.queueing_bound(mu, T0, now, since)

    def summary(self, now: float, since: Optional[float],
                slo: float, mu: Optional[float]) -> _WindowSummary:
        tot = self.sk.totals(now, since)
        n_served = int(tot[_sk.SERVED])
        hist = self.sk.histogram(now, since)
        p50 = _sk.quantile_from_counts(hist, 50) if n_served else 0.0
        p99 = _sk.quantile_from_counts(hist, 99) if n_served else 0.0
        viol = float(tot[_sk.VIOLATIONS]) / n_served if n_served else 0.0
        tq = float("nan")
        if mu is not None:
            tq = self.sk.queueing_bound(mu, 0.0, now, since)
        return _WindowSummary(int(tot[_sk.ARRIVALS]), n_served,
                              int(tot[_sk.SHED]), int(tot[_sk.FAILED]),
                              p50, p99, viol, tq)

    def latency_histogram(self, now: float) -> Optional[np.ndarray]:
        return self.sk.histogram(now)

    def absorb(self, other: "_SketchEngine") -> None:
        self.sk.absorb(other.sk)


class SloTelemetry:
    def __init__(self, slo_seconds: float = 1.0,
                 window_seconds: float = 60.0,
                 clock: Callable[[], float] = time.monotonic,
                 exact: bool = False,
                 n_buckets: Optional[int] = None):
        self.slo = slo_seconds
        self.window = window_seconds
        self.clock = clock
        self.exact = bool(exact)
        self.n_buckets = int(n_buckets) if n_buckets is not None \
            else auto_n_buckets(window_seconds, slo_seconds)
        n_buckets = self.n_buckets
        self._lock = threading.Lock()
        self._eng = _ExactEngine(window_seconds) if exact \
            else _SketchEngine(window_seconds, n_buckets)

    # oracle-introspection views (exact engine only): the raw event
    # logs the pre-sketch tests poke at
    @property
    def _arrivals(self) -> List[float]:
        return self._require_exact().arrivals.times()

    @property
    def _served(self) -> List[Tuple[float, float]]:
        eng = self._require_exact()
        return list(zip(eng.served.times(), eng.served.values()))

    @property
    def _shed(self) -> List[float]:
        return self._require_exact().shed.times()

    def _require_exact(self) -> _ExactEngine:
        if not self.exact:
            raise AttributeError(
                "raw event logs exist only under exact=True (the "
                "sketch engine keeps bucket counters, not timestamps)")
        return self._eng

    @property
    def _t0(self) -> Optional[float]:
        return self._eng.t0

    @property
    def _hwm(self) -> float:
        return self._eng.hwm

    # ------------------------------------------------------------ feed
    def record_arrival(self, t: Optional[float] = None,
                       patient: Optional[int] = None) -> None:
        """``patient`` is accepted (and ignored) so the server tap can
        pass query ids uniformly; ``TieredTelemetry`` routes on it."""
        t = self.clock() if t is None else t
        with self._lock:
            self._eng.record(_sk.ARRIVALS, t)

    def record_served(self, latency: float,
                      t: Optional[float] = None,
                      patient: Optional[int] = None) -> None:
        t = self.clock() if t is None else t
        with self._lock:
            # violations are classified HERE, against the SLO, so the
            # sketch's violation rate is exact (never histogram-derived)
            self._eng.record(_sk.SERVED, t, latency=float(latency),
                             violated=float(latency) > self.slo)

    def record_shed(self, t: Optional[float] = None,
                    patient: Optional[int] = None) -> None:
        t = self.clock() if t is None else t
        with self._lock:
            self._eng.record(_sk.SHED, t)

    def record_failure(self, t: Optional[float] = None,
                       patient: Optional[int] = None) -> None:
        """A query retired with a NaN score (server NaN-isolation or a
        watchdog-killed co-batch): served for conservation purposes, but
        no usable score was delivered."""
        t = self.clock() if t is None else t
        with self._lock:
            self._eng.record(_sk.FAILED, t)

    # ------------------------------------------------------------ read
    def arrivals(self, now: Optional[float] = None) -> np.ndarray:
        """Arrival timestamps in the window (sketch mode: coarsened to
        bucket starts)."""
        now = self.clock() if now is None else now
        with self._lock:
            return self._eng.arrival_times(now)

    def latencies(self, now: Optional[float] = None) -> np.ndarray:
        """Served latencies in the window (sketch mode: reconstructed
        at histogram-bin representative values)."""
        now = self.clock() if now is None else now
        with self._lock:
            return self._eng.latency_values(now)

    def arrival_rate(self, now: Optional[float] = None) -> float:
        """Arrivals/s over the effective window (shorter than
        ``window_seconds`` until that much history exists)."""
        now = self.clock() if now is None else now
        with self._lock:
            n = len(self._eng.arrival_times(now))
            t0 = self._eng.t0
            span = self.window if t0 is None \
                else min(self.window, max(now - t0, 1e-9))
            return n / span

    def arrival_curve(self, dts: np.ndarray,
                      now: Optional[float] = None) -> np.ndarray:
        """The ONLINE empirical arrival curve alpha(dt) over the
        sliding window — the live counterpart of the profiler's
        synthetic trace."""
        return arrival_curve(self.arrivals(now), dts)

    def queueing_bound(self, mu: float, T0: float,
                       now: Optional[float] = None) -> float:
        """Online network-calculus T_q bound against the rate-latency
        service curve beta(t) = mu * (t - T0)+ of the ACTIVE ensemble."""
        now = self.clock() if now is None else now
        with self._lock:
            return self._eng.tq(mu, T0, now)

    def latency_histogram(self, now: Optional[float] = None
                          ) -> Optional[np.ndarray]:
        """Merged latency bin counts over the window (sketch mode
        only; None under ``exact=True``).  Bin edges are
        ``obs.sketch.EDGES`` — the Prometheus-exposition source."""
        now = self.clock() if now is None else now
        with self._lock:
            return self._eng.latency_histogram(now)

    def snapshot(self, mu: Optional[float] = None, ts: float = 0.0,
                 now: Optional[float] = None,
                 since: Optional[float] = None,
                 imbalance: Optional[float] = None) -> TelemetrySnapshot:
        """``since`` restricts the reading to events AFTER that time —
        the controller passes its last actuation time so decisions rest
        on post-action evidence only (a violation burst that triggered
        a shed must not re-trigger it for the rest of the window).
        Exact mode resolves the cut by bisect; sketch mode keeps whole
        buckets starting strictly after ``since``."""
        now = self.clock() if now is None else now
        with self._lock:
            s = self._eng.summary(now, since, self.slo, mu)
            t0 = self._eng.t0
        start = now if t0 is None else t0
        if since is not None:
            start = max(start, since)
        span = self.window if t0 is None \
            else min(self.window, max(now - start, 1e-9))
        return TelemetrySnapshot(
            t=now, window_seconds=self.window,
            n_arrivals=s.n_arrivals, n_served=s.n_served,
            n_shed=s.n_shed,
            arrival_rate=s.n_arrivals / span,
            p50=s.p50, p99=s.p99, violation_rate=s.violation_rate,
            ts=float(ts) if mu is not None else float("nan"),
            tq_bound=s.tq_bound,
            placement_imbalance=float(imbalance)
            if imbalance is not None else float("nan"),
            n_failed=s.n_failed)

    # ----------------------------------------------------------- merge
    @classmethod
    def merge(cls, parts: Sequence["SloTelemetry"],
              clock: Optional[Callable[[], float]] = None
              ) -> "SloTelemetry":
        """One telemetry whose window holds every part's events — the
        fleet view over tier slices today, the cross-host reduction
        tomorrow.  Parts must agree on (slo, window, engine); sketch
        parts merge in O(n_buckets), exact parts by re-sorting their
        (window-bounded) event logs."""
        parts = list(parts)
        if not parts:
            raise ValueError("nothing to merge")
        first = parts[0]
        for p in parts[1:]:
            if (p.slo != first.slo or p.window != first.window
                    or p.exact != first.exact
                    or p.n_buckets != first.n_buckets):
                raise ValueError(
                    "merge requires identical (slo_seconds, "
                    "window_seconds, exact, n_buckets) across parts")
        out = cls(first.slo, first.window,
                  clock=clock if clock is not None else first.clock,
                  exact=first.exact, n_buckets=first.n_buckets)
        for p in parts:
            with p._lock:
                out._eng.absorb(p._eng)
        return out


class TieredTelemetry:
    """Per-acuity-tier telemetry: one ``SloTelemetry`` slice per tier,
    fed through the same server-tap interface.

    Routing: an explicit ``tier=`` wins (DES replay stamps each query's
    tier at birth); otherwise ``tier_of(patient)`` maps the patient id
    the query carries; unknown/unmappable patients land in
    ``default_tier``.  A patient whose acuity escalates mid-stay starts
    feeding its NEW slice from that moment — its history stays where it
    was observed.

    ``snapshot`` is the fleet view (what overload/health decisions key
    on, since all tiers share the device pool): a DERIVED merge of the
    tier slices (``SloTelemetry.merge``), not a second feed — the
    slices are the single source of truth and the fleet can never
    drift from their sum.  ``tier_snapshot`` is one slice (per-tier
    p99/violations/arrival rate — the priority-aware controller's
    evidence for which tier absorbs a shed).
    """

    def __init__(self, tier_of: Callable[[int], str],
                 tiers: Sequence[str],
                 slo_seconds: float = 1.0,
                 window_seconds: float = 60.0,
                 default_tier: Optional[str] = None,
                 clock: Callable[[], float] = time.monotonic,
                 exact: bool = False,
                 n_buckets: Optional[int] = None):
        if not tiers:
            raise ValueError("tiers must be non-empty")
        self.tiers = tuple(tiers)
        self.tier_of = tier_of
        self.default_tier = default_tier if default_tier is not None \
            else self.tiers[0]
        if self.default_tier not in self.tiers:
            raise ValueError(f"default_tier {self.default_tier!r} not in "
                             f"{self.tiers}")
        self.slo = slo_seconds
        self.window = window_seconds
        self.clock = clock
        self.exact = bool(exact)
        self.n_buckets = int(n_buckets) if n_buckets is not None \
            else auto_n_buckets(window_seconds, slo_seconds)
        n_buckets = self.n_buckets
        self.slices: Dict[str, SloTelemetry] = {
            t: SloTelemetry(slo_seconds, window_seconds, clock,
                            exact=exact, n_buckets=n_buckets)
            for t in self.tiers}

    def _slice(self, patient: Optional[int],
               tier: Optional[str]) -> SloTelemetry:
        if tier is None and patient is not None:
            try:
                tier = self.tier_of(patient)
            except Exception:
                tier = None
        if tier not in self.slices:
            tier = self.default_tier
        return self.slices[tier]

    # ------------------------------------------------------- server tap
    def record_arrival(self, t: Optional[float] = None,
                       patient: Optional[int] = None,
                       tier: Optional[str] = None) -> None:
        t = self.clock() if t is None else t
        self._slice(patient, tier).record_arrival(t)

    def record_served(self, latency: float, t: Optional[float] = None,
                      patient: Optional[int] = None,
                      tier: Optional[str] = None) -> None:
        t = self.clock() if t is None else t
        self._slice(patient, tier).record_served(latency, t)

    def record_shed(self, t: Optional[float] = None,
                    patient: Optional[int] = None,
                    tier: Optional[str] = None) -> None:
        t = self.clock() if t is None else t
        self._slice(patient, tier).record_shed(t)

    def record_failure(self, t: Optional[float] = None,
                       patient: Optional[int] = None,
                       tier: Optional[str] = None) -> None:
        t = self.clock() if t is None else t
        self._slice(patient, tier).record_failure(t)

    # ------------------------------------------------------------ read
    def tier(self, name: str) -> SloTelemetry:
        return self.slices[name]

    @property
    def fleet(self) -> SloTelemetry:
        """The fleet-wide sensor, merged fresh from the tier slices."""
        return SloTelemetry.merge(list(self.slices.values()),
                                  clock=self.clock)

    def snapshot(self, **kwargs) -> TelemetrySnapshot:
        """Fleet-wide reading (same signature as
        ``SloTelemetry.snapshot``): merge the slices, then read."""
        return self.fleet.snapshot(**kwargs)

    def tier_snapshot(self, name: str, **kwargs) -> TelemetrySnapshot:
        return self.slices[name].snapshot(**kwargs)
