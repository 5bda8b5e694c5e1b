"""Mergeable windowed telemetry sketch: O(1) memory per sensor.

Two primitives back the observability plane:

* ``LogHistogram`` — a fixed set of log-spaced latency bins shared by
  every histogram in the process.  Quantiles come back as the
  geometric midpoint of the hit bin, so the relative error is bounded
  by ``REL_ERR_BOUND`` (= sqrt(growth) - 1, ~5.8%) regardless of how
  many samples were folded in.  Two histograms merge by elementwise
  sum — the property that makes per-tier (and, next, per-host)
  telemetry composable.

* ``WindowedSketch`` — a ring of ``n_buckets`` sub-window buckets
  aligned to the ABSOLUTE time grid (bucket k covers
  ``[k*bucket_width, (k+1)*bucket_width)``), each holding exact event
  counters (arrivals / served / shed / failed / SLO violations /
  latency sum) plus one log histogram of served latencies.  Recording
  advances the ring against the newest bucket seen and zeroes
  overtaken slots, so memory is a CONSTANT ``n_buckets x n_bins``
  block no matter how long the trace runs — the deque window it
  replaces was O(window events).

Exactness contract: counts, violation rate and arrival rate are EXACT
for events inside the retained grid range (violations are classified
against the SLO at record time and stored as counters, never
re-derived from the histogram).  Only three things are coarsened, each
by at most ONE bucket width: window expiry, ``since=`` cuts (resolved
to whole buckets strictly after ``since``), and the network-calculus
T_q bound (each bucket's arrivals are grouped at their in-bucket MEAN
time, reconstructed from a per-bucket timestamp-sum counter, so the
bucketed bound tracks the raw-trace bound within +-``bucket_width``).
p50/p99 inherit the histogram's relative-error bound.  Because grids are absolute, two sketches with the same
(window, n_buckets) merge by aligned elementwise sum.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np

# ------------------------------------------------------ histogram bins
# log-spaced latency bins covering 100 us .. 100 s; everything in the
# serving stack (sub-ms flushes to watchdog-deadline stalls) lands in
# the core range, with explicit under/overflow bins for the rest
LAT_LO = 1e-4
LAT_HI = 100.0
GROWTH = 1.12
N_CORE = int(math.ceil(math.log(LAT_HI / LAT_LO) / math.log(GROWTH)))
# bin 0 = underflow [0, LAT_LO); bins 1..N_CORE = core; last = overflow
N_BINS = N_CORE + 2
EDGES = LAT_LO * GROWTH ** np.arange(N_CORE + 1)
# representative value per bin: geometric midpoint (worst-case
# relative error sqrt(GROWTH) - 1 for any value inside the bin)
REPS = np.empty(N_BINS)
REPS[0] = LAT_LO / 2.0
REPS[1:-1] = EDGES[:-1] * math.sqrt(GROWTH)
REPS[-1] = LAT_HI
REL_ERR_BOUND = math.sqrt(GROWTH) - 1.0


def bin_index(value: float) -> int:
    """Histogram bin for a latency value (negative values clamp to the
    underflow bin — a skewed clock must never throw off the sensor)."""
    if value < LAT_LO:
        return 0
    return int(np.searchsorted(EDGES, value, side="right"))


def quantile_from_counts(counts: np.ndarray, pct: float) -> float:
    """``np.percentile``-flavoured read of a bin-count vector: the
    representative value of the bin holding the rank-``pct`` sample."""
    total = float(counts.sum())
    if total <= 0:
        return 0.0
    rank = pct / 100.0 * (total - 1.0)
    cum = np.cumsum(counts)
    idx = int(np.searchsorted(cum, rank, side="right"))
    return float(REPS[min(idx, N_BINS - 1)])


# ------------------------------------------------------- counter layout
# ARR_T_SUM accumulates the raw arrival timestamps per bucket, so reads
# can reconstruct each bucket's arrivals at their in-bucket MEAN time —
# the two-sided (error << bucket width) grouping the T_q bound uses
# instead of the always-late bucket start
ARRIVALS, SERVED, SHED, FAILED, VIOLATIONS, LAT_SUM, ARR_T_SUM = range(7)
N_COUNTERS = 7


class WindowedSketch:
    """Ring of sub-window buckets on the absolute time grid.  All
    methods are unsynchronised — the owning telemetry object holds the
    lock."""

    __slots__ = ("window", "n_buckets", "bucket_width", "counts",
                 "hist", "k_hwm", "hwm", "t0")

    def __init__(self, window_seconds: float, n_buckets: int = 128):
        if n_buckets < 2:
            raise ValueError("n_buckets must be >= 2")
        self.window = float(window_seconds)
        self.n_buckets = int(n_buckets)
        self.bucket_width = self.window / self.n_buckets
        self.counts = np.zeros((self.n_buckets, N_COUNTERS))
        self.hist = np.zeros((self.n_buckets, N_BINS))
        self.k_hwm: Optional[int] = None   # newest bucket index seen
        self.hwm = -float("inf")           # newest raw event time seen
        self.t0: Optional[float] = None    # first event time ever seen

    # ------------------------------------------------------------ write
    def _bucket_of(self, t: float) -> int:
        return int(math.floor(t / self.bucket_width))

    def _slot(self, t: float) -> Optional[int]:
        """Ring slot for an event at ``t``; advances/zeroes the ring
        when ``t`` opens a newer bucket, returns None when the event is
        already a full window behind the newest bucket (the sketch
        analogue of the deque's record-time reject)."""
        k = self._bucket_of(t)
        if self.k_hwm is None:
            self.k_hwm = k
        elif k > self.k_hwm:
            gap = k - self.k_hwm
            if gap >= self.n_buckets:
                self.counts[:] = 0.0
                self.hist[:] = 0.0
            else:
                idx = np.arange(self.k_hwm + 1, k + 1) % self.n_buckets
                self.counts[idx] = 0.0
                self.hist[idx] = 0.0
            self.k_hwm = k
        elif k <= self.k_hwm - self.n_buckets:
            return None
        if self.t0 is None:
            self.t0 = t
        self.hwm = max(self.hwm, t)
        return k % self.n_buckets

    def add(self, kind: int, t: float, latency: Optional[float] = None,
            violated: bool = False) -> bool:
        """Record one event; returns False when it was too old to keep."""
        slot = self._slot(t)
        if slot is None:
            return False
        self.counts[slot, kind] += 1.0
        if kind == ARRIVALS:
            self.counts[slot, ARR_T_SUM] += t
        if kind == SERVED and latency is not None:
            self.counts[slot, LAT_SUM] += float(latency)
            if violated:
                self.counts[slot, VIOLATIONS] += 1.0
            self.hist[slot, bin_index(float(latency))] += 1.0
        return True

    # ------------------------------------------------------------- read
    def _live(self, now: float, since: Optional[float] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
        """(bucket indices, ring slots) retained at ``now``, optionally
        cut to buckets starting strictly after ``since``.  Both cuts
        resolve at bucket granularity (error <= one bucket width)."""
        empty = (np.empty(0, np.int64), np.empty(0, np.int64))
        if self.k_hwm is None:
            return empty
        k_hi = max(self._bucket_of(now), self.k_hwm)
        k_lo = k_hi - self.n_buckets + 1
        # data older than the ring was zeroed on advance
        k_lo = max(k_lo, self.k_hwm - self.n_buckets + 1)
        if since is not None:
            k_lo = max(k_lo, self._bucket_of(since) + 1)
        if k_lo > self.k_hwm:
            return empty
        ks = np.arange(k_lo, self.k_hwm + 1)
        return ks, ks % self.n_buckets

    def totals(self, now: float, since: Optional[float] = None
               ) -> np.ndarray:
        """Summed counter vector over the live range."""
        _, slots = self._live(now, since)
        if not len(slots):
            return np.zeros(N_COUNTERS)
        return self.counts[slots].sum(axis=0)

    def histogram(self, now: float, since: Optional[float] = None
                  ) -> np.ndarray:
        """Merged latency bin counts over the live range."""
        _, slots = self._live(now, since)
        if not len(slots):
            return np.zeros(N_BINS)
        return self.hist[slots].sum(axis=0)

    def quantile(self, pct: float, now: float,
                 since: Optional[float] = None) -> float:
        return quantile_from_counts(self.histogram(now, since), pct)

    def _bucket_arrivals(self, now: float, since: Optional[float]
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """(mean arrival time, count) per OCCUPIED live bucket.  Means
        are strictly increasing across buckets (each lies inside its
        own bucket), so the grouped trace is sorted."""
        ks, slots = self._live(now, since)
        if not len(slots):
            return np.empty(0), np.empty(0)
        n = self.counts[slots, ARRIVALS]
        occ = n > 0
        if not occ.any():
            return np.empty(0), np.empty(0)
        means = self.counts[slots, ARR_T_SUM][occ] / n[occ]
        return means, n[occ]

    def arrival_times(self, now: float,
                      since: Optional[float] = None) -> np.ndarray:
        """Coarsened reconstruction of the arrival trace: each bucket's
        arrivals placed at their in-bucket MEAN time (the same
        grouping the bucketed T_q bound uses)."""
        means, n = self._bucket_arrivals(now, since)
        return np.repeat(means, n.astype(np.int64))

    def latency_values(self, now: float,
                       since: Optional[float] = None) -> np.ndarray:
        """Approximate latency samples reconstructed from the merged
        histogram (each sample at its bin's representative value)."""
        h = self.histogram(now, since).astype(np.int64)
        return np.repeat(REPS, h)

    def queueing_bound(self, mu: float, T0: float, now: float,
                       since: Optional[float] = None) -> float:
        """Exact network-calculus T_q bound on the COARSENED trace
        (each bucket's arrivals grouped at their in-bucket mean time),
        computed straight from the bucket counters in O(n_buckets^2).

        On the grouped trace the sup over burst sizes is attained on a
        contiguous full-bucket range [i, j]: any window covering a
        partial group has the same span as the full range but fewer
        arrivals, so it is dominated.  Grouping moves each arrival by
        less than one bucket width, so the bound tracks the raw-trace
        bound within +- bucket_width (mean grouping keeps the error
        two-sided and small, where start-of-bucket grouping would bias
        it a full bucket width high)."""
        means, n = self._bucket_arrivals(now, since)
        if not len(n):
            return 0.0
        if mu <= 0:
            return float("inf")
        cum = np.concatenate([[0.0], np.cumsum(n)])
        best = 1.0 / mu
        for i in range(len(means)):
            cand = (cum[i + 1:] - cum[i]) / mu - (means[i:] - means[i])
            best = max(best, float(cand.max()))
        return float(T0 + max(best, 0.0))

    # ------------------------------------------------------------ merge
    def absorb(self, other: "WindowedSketch") -> None:
        """Fold ``other`` into self (aligned elementwise sum).  Both
        grids are absolute, so buckets align by index; whatever falls
        behind the merged ring's span is dropped, exactly as if the
        events had been fed to one sketch."""
        if (other.window != self.window
                or other.n_buckets != self.n_buckets):
            raise ValueError("can only merge sketches with identical "
                             "(window_seconds, n_buckets)")
        if other.k_hwm is None:
            return
        if self.k_hwm is None or other.k_hwm > self.k_hwm:
            # advance our ring (zeroing overtaken slots) via _slot on
            # the other's newest bucket MIDPOINT (robust to float
            # rounding at the bucket boundary)
            self._slot((other.k_hwm + 0.5) * self.bucket_width)
        self.hwm = max(self.hwm, other.hwm)
        if other.t0 is not None:
            self.t0 = other.t0 if self.t0 is None \
                else min(self.t0, other.t0)
        k_lo = max(other.k_hwm - other.n_buckets + 1,
                   self.k_hwm - self.n_buckets + 1)
        if k_lo > other.k_hwm:
            return
        ks = np.arange(k_lo, other.k_hwm + 1)
        src = ks % other.n_buckets
        dst = ks % self.n_buckets
        self.counts[dst] += other.counts[src]
        self.hist[dst] += other.hist[src]

    @classmethod
    def merged(cls, parts: Sequence["WindowedSketch"]
               ) -> "WindowedSketch":
        parts = list(parts)
        if not parts:
            raise ValueError("nothing to merge")
        out = cls(parts[0].window, parts[0].n_buckets)
        for p in parts:
            out.absorb(p)
        return out
