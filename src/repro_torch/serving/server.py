"""Wall-clock serving server: the HTTP-ingest stand-in of Fig. 4 as a
threaded request loop — bounded ingest queue, N device-worker threads
draining per-model tasks, SLO accounting.

Workers are batch-aware: given a ``batch_handler`` (e.g.
``EnsembleService.predict_batch``) they coalesce queries from many
patients through a shared ``MicroBatcher`` (bounded by ``max_batch`` /
``max_wait_ms``) and retire each flush with ONE fused ensemble call.
With only a scalar ``handler`` they process queries one at a time as
before.

The ``windows`` payload is OPAQUE to the server: a host window dict,
or — under device-resident ingest — a
``serving.aggregator.DeviceWindowRef`` (three host integers per
modality; the flush gathers the samples on device).  Queue bounds,
shedding, telemetry taps and tier routing are identical either way,
so switching the ingest side to the device rings changes nothing
above ``submit``.

Tiered serving: with ``tier_of`` (patient id -> acuity tier, e.g.
``control.tiers.TierRegistry.tier_of``) the batcher becomes tier-KEYED
— cross-patient coalescing still happens, but only WITHIN a tier — and
every flush is handed to ``batch_handler(windows, tier)`` (e.g.
``control.tiers.TieredEnsemble.predict_batch``), so each query is
served by exactly its tier's (selector, placement) service.  The
telemetry tap always carries the patient id, so per-tier SLO slices
(``control.telemetry.TieredTelemetry``) come for free.

Continuous slot serving: ``engine="slots"`` (with a
``serving.slots.SlotEngine``) subsumes the micro-batcher on the hot
path entirely — ``submit`` folds each closed window into the bed's
persistent slot, a dedicated ticker thread scores ALL occupied slots
every tick, and workers retire each query with a version-gated host
int read (zero launches, zero transfers per query).  Queue bounds,
shedding, stats, telemetry taps and span tracing are identical to the
flush engine; staleness becomes a tick-age guard
(``slot_wait_timeout``) instead of the flush deadline.

Fault tolerance:

* the ingest queue is a ``ShedQueue`` bounding UNFINISHED work (queued
  + coalescing + in-flight) at ``max_queue`` — the micro-batcher lanes
  can no longer grow without limit under backpressure;
* with ``tier_priority`` (tier -> numeric priority), overrun admission
  is priority-aware: a higher-priority query evicts the oldest
  lowest-priority queued one (stable tier sheds first), and a critical
  query is never bumped by a lesser one.  Every rejection — incoming or
  evicted — is counted in ``ServerStats`` (``shed`` plus the per-tier
  ``rejected`` map) and tapped to telemetry; nothing is silently lost;
* with ``deadline_seconds`` a watchdog thread bounds how long any
  co-batch may be in-flight: a stalled worker's batch is retired NaN
  (the existing failure score — downstream treats it exactly like a
  poisoned query), the worker is marked abandoned and a replacement is
  spawned.  When the stalled handler eventually returns, the abandoned
  worker discards its late scores and exits, so every query is retired
  exactly once and ``drain()`` conservation holds through stalls.

The DES simulator (simulator.py) is the deterministic twin used by the
latency profiler and benchmarks; this server is the "really runs" path
the examples exercise (real inference on the device, real clocks).
"""
from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.obs import sketch as _sketch
from repro_torch.obs import spans as _spans
from repro_torch.serving.queues import (NO_LANE, KeyedMicroBatcher,
                                        MicroBatcher, ShedQueue)

log = logging.getLogger(__name__)


class Task:
    """One submitted query in flight through the server.  Replaces the
    old ``(patient, windows, t_window)`` tuple so the span stamps the
    tracer needs ride the object itself instead of a side table.  All
    fields except the first three are stamped lazily on the trace
    path; ``__slots__`` keeps the per-query footprint tuple-sized.
    ``version`` is the slot engine's close version under
    ``engine="slots"`` (which tick must land before the read)."""

    __slots__ = ("patient", "windows", "t_window", "tier",
                 "t_dequeue", "t_flush", "batch_n", "stages", "version")

    def __init__(self, patient: int, windows: Dict, t_window: float,
                 tier: object = None):
        self.patient = patient
        self.windows = windows
        self.t_window = t_window
        self.tier = tier
        self.t_dequeue = t_window
        self.t_flush = t_window
        self.batch_n = 1
        self.stages: Optional[Dict[str, float]] = None
        self.version = 0


class ServerStats:
    """Thread-safe serving counters.  Worker threads ``record()``
    retired queries concurrently with readers: every mutation holds the
    internal lock, and ``p()``/``snapshot()`` read the latency
    histogram under it, so percentile reads are snapshot-consistent
    instead of racing ongoing updates.

    Latencies live in the obs plane's log-spaced histogram
    (``obs.sketch``: fixed ``N_BINS`` bins, growth 1.12), NOT a list:
    an hours-long soak retires millions of queries, and the pre-fix
    unbounded ``latencies`` list grew O(n) memory while ``p()`` paid an
    O(n log n) copy-and-sort per read.  Now memory is O(1), ``record``
    is O(log bins) and ``p()`` is O(bins), with quantiles within the
    sketch's ~5.8% relative-error bound (``sketch.REL_ERR_BOUND``).
    The ``served``/``failed``/``shed``/``stalls`` counters and the
    latency SUM stay exact — only quantiles are approximate.

    ``served`` counts every retired query including failures; ``failed``
    is the NaN-scored subset (poisoned / stale / stall-killed), so
    ``served - failed`` is the number of REAL scores delivered.
    ``shed`` counts every rejected query, with the per-tier breakdown in
    ``rejected`` (key None for untiered submits); ``stalls`` counts
    watchdog-killed co-batches."""

    def __init__(self):
        self._lock = threading.Lock()
        self.served = 0
        self.slo_violations = 0
        self.shed = 0
        self.failed = 0
        self.stalls = 0
        self.rejected: Dict[object, int] = {}
        self._lat_counts = np.zeros(_sketch.N_BINS, np.int64)
        self._lat_sum = 0.0
        self._lat_max = 0.0

    def record(self, latency: float, violated: bool,
               failed: bool = False) -> None:
        with self._lock:
            self.served += 1
            self._lat_counts[_sketch.bin_index(latency)] += 1
            self._lat_sum += latency
            if latency > self._lat_max:
                self._lat_max = latency
            if violated:
                self.slo_violations += 1
            if failed:
                self.failed += 1

    def record_shed(self, tier: object = None) -> None:
        with self._lock:
            self.shed += 1
            self.rejected[tier] = self.rejected.get(tier, 0) + 1

    def record_stall(self) -> None:
        with self._lock:
            self.stalls += 1

    @property
    def violation_rate(self) -> float:
        with self._lock:
            return self.slo_violations / self.served if self.served else 0.0

    @property
    def n_latencies(self) -> int:
        """Exact number of recorded latency samples (== ``served``)."""
        with self._lock:
            return int(self._lat_counts.sum())

    @property
    def mean_latency(self) -> float:
        """Exact mean served latency (the sum is kept exactly; only
        quantiles go through the histogram)."""
        with self._lock:
            n = int(self._lat_counts.sum())
            return self._lat_sum / n if n else 0.0

    @property
    def max_latency(self) -> float:
        with self._lock:
            return self._lat_max

    def snapshot(self) -> np.ndarray:
        """Consistent copy of the latency histogram bin counts
        (``obs.sketch`` bin layout — mergeable across servers by
        elementwise sum)."""
        with self._lock:
            return self._lat_counts.copy()

    def p(self, pct: float) -> float:
        counts = self.snapshot()
        return _sketch.quantile_from_counts(counts, pct)


class EnsembleServer:
    """Serves ensemble queries with a pool of worker threads (the
    stateless-actor pool; one thread ~ one device in the CPU demo).

    handler(query) -> score runs the ensemble per query;
    batch_handler(queries) -> scores runs one fused flush for a
    micro-batch (takes precedence when given).  Queries are
    (patient_id, windows dict) tuples submitted by the ingest side.
    """

    def __init__(self, handler: Optional[Callable[[Dict], float]] = None,
                 n_workers: int = 2, slo_seconds: float = 1.0,
                 max_queue: int = 1024,
                 batch_handler: Optional[
                     Callable[[Sequence[Dict]], List[float]]] = None,
                 max_batch: int = 8, max_wait_ms: float = 2.0,
                 telemetry=None,
                 tier_of: Optional[Callable[[int], object]] = None,
                 tier_priority: Optional[Dict[object, float]] = None,
                 deadline_seconds: Optional[float] = None,
                 watchdog_interval: float = 0.02,
                 tracer: Optional["_spans.SpanRecorder"] = None,
                 engine: str = "flush",
                 slot_engine=None,
                 tick_interval: float = 0.02,
                 slot_wait_timeout: Optional[float] = None,
                 ticker_deadline_seconds: Optional[float] = None):
        if engine not in ("flush", "slots"):
            raise ValueError(f"unknown engine {engine!r}")
        if engine == "slots":
            # continuous slot serving: no per-query handler at all — a
            # dedicated ticker scores every occupied slot each tick and
            # workers just version-gate a host read per query, so the
            # micro-batcher is subsumed entirely on the hot path
            if slot_engine is None:
                raise ValueError('engine="slots" needs a slot_engine '
                                 "(serving.slots.SlotEngine)")
            if handler is not None or batch_handler is not None:
                raise ValueError('engine="slots" replaces the handlers; '
                                 "pass neither")
            if tier_of is not None or tier_priority is not None:
                raise ValueError('engine="slots" is untiered (one slot '
                                 "plane per census); drop tier_of")
        else:
            assert handler is not None or batch_handler is not None
            if slot_engine is not None:
                raise ValueError('slot_engine needs engine="slots"')
        self.engine = engine
        self.slot_engine = slot_engine
        self._slot_wait = (slot_wait_timeout
                           if slot_wait_timeout is not None
                           else max(1.0, 10.0 * tick_interval))
        self.ticker = None
        self.ticker_watchdog = None
        if engine == "slots":
            from repro_torch.serving.slots import SlotTicker, TickerWatchdog
            self.ticker = SlotTicker(slot_engine, interval=tick_interval)
            if ticker_deadline_seconds is not None:
                # heartbeat watchdog: a dead or stalled ticker is
                # respawned; readers ride the gap on the tick-age
                # guard / wait timeout (NaN-or-stale, never wrong)
                self.ticker_watchdog = TickerWatchdog(
                    self.ticker, deadline_seconds=ticker_deadline_seconds)
        elif ticker_deadline_seconds is not None:
            raise ValueError('ticker_deadline_seconds needs '
                             'engine="slots"')
        self.handler = handler
        self.batch_handler = batch_handler
        self.slo = slo_seconds
        self.q = ShedQueue(maxsize=max_queue)
        # tiered mode: per-tier coalescing lanes; batch_handler then
        # takes (windows, tier) so a flush is served by ITS tier only
        if tier_of is not None and batch_handler is None:
            raise ValueError("tier_of requires a batch_handler (the "
                             "scalar handler path has no tier routing)")
        if tier_priority is not None and tier_of is None:
            raise ValueError("tier_priority requires tier_of (priorities "
                             "are keyed by acuity tier)")
        self.tier_of = tier_of
        self.tier_priority = tier_priority
        self.batcher = (
            KeyedMicroBatcher(max_batch=max_batch, max_wait_ms=max_wait_ms)
            if self.tier_of is not None
            else MicroBatcher(max_batch=max_batch, max_wait_ms=max_wait_ms))
        self.stats = ServerStats()
        # control-plane tap (duck-typed control.telemetry.SloTelemetry):
        # every ingest is an arrival, every retired query a latency sample
        self.telemetry = telemetry
        # span tracer (obs.spans.SpanRecorder): when set, every retired
        # query emits a lifecycle SpanRecord with stage attribution
        self.tracer = tracer
        self.deadline = deadline_seconds
        self._wd_interval = watchdog_interval
        self._wd_lock = threading.Lock()
        # watchdog bookkeeping is keyed by a per-worker EPOCH TOKEN
        # (the monotonic spawn counter, stamped into a thread-local at
        # worker start), NOT ``threading.get_ident()``: the OS reuses
        # idents after a thread exits, so a replacement worker could
        # inherit its stalled predecessor's ``_abandoned`` entry and
        # silently discard a healthy co-batch's scores — breaking the
        # "every query retires exactly once" contract.  Epoch tokens
        # are never reused within a server's lifetime.
        self._inflight: Dict[int, tuple] = {}    # token -> (t0, tasks)
        self._abandoned: set = set()             # tokens killed by watchdog
        self._worker_token = threading.local()
        self._stop = threading.Event()
        self._results: "queue.Queue" = queue.Queue()
        self._spawned = 0
        self._workers = [self._make_worker() for _ in range(n_workers)]
        self._watchdog = (
            threading.Thread(target=self._watch, daemon=True,
                             name="repro-watchdog")
            if self.deadline is not None else None)
        self.leaked: List[str] = []

    def _make_worker(self) -> threading.Thread:
        self._spawned += 1
        return threading.Thread(target=self._run, args=(self._spawned,),
                                daemon=True,
                                name=f"repro-worker-{self._spawned}")

    def _token(self) -> int:
        """The calling worker's epoch token (its spawn ordinal).  A
        non-worker caller (tests poking ``heartbeat`` from the main
        thread) gets a sentinel that is never in the watchdog maps."""
        return getattr(self._worker_token, "token", -1)

    def start(self) -> "EnsembleServer":
        for w in self._workers:
            w.start()
        if self._watchdog is not None:
            self._watchdog.start()
        if self.ticker is not None:
            self.ticker.start()
        if self.ticker_watchdog is not None:
            self.ticker_watchdog.start()
        return self

    def _tier_and_priority(self, patient: int):
        tier = None
        if self.tier_of is not None:
            try:
                tier = self.tier_of(patient)
            except Exception:
                tier = None
        prio = 0.0
        if self.tier_priority is not None:
            prio = float(self.tier_priority.get(tier, 0.0))
        return tier, prio

    def submit(self, patient: int, windows: Dict,
               t_window: Optional[float] = None) -> bool:
        """Non-blocking ingest; returns False if the queue is full
        (overload shedding rather than unbounded latency).  With
        ``tier_priority`` set, admission under overrun is priority-aware:
        the newcomer may evict a strictly lower-priority queued query
        (which is then counted shed) instead of being rejected itself."""
        t_window = t_window if t_window is not None else time.monotonic()
        tier, prio = self._tier_and_priority(patient)
        task = Task(patient, windows, t_window, tier)
        if self.engine == "slots":
            # fold the closed window into the bed's slot BEFORE
            # admission control: even if the read request is shed, the
            # slot state must stay fresh (monitoring never regresses)
            task.version = self.slot_engine.update(windows)
        try:
            if self.tier_priority is not None:
                ok, victim = self.q.put_evicting(task, priority=prio,
                                                 tag=tier)
                if not ok:
                    raise queue.Full
                if victim is not None:
                    vtask, vtier = victim
                    self.stats.record_shed(vtier)
                    if self.telemetry is not None:
                        self.telemetry.record_shed(t_window,
                                                   patient=vtask.patient)
            else:
                self.q.put_nowait(task, priority=prio, tag=tier)
            if self.telemetry is not None:
                self.telemetry.record_arrival(t_window, patient=patient)
            return True
        except queue.Full:
            self.stats.record_shed(tier)
            if self.telemetry is not None:
                self.telemetry.record_shed(t_window, patient=patient)
            return False

    # ------------------------------------------------------------ workers
    def _retire(self, tasks: Sequence, scores: Sequence[float],
                cause: Optional[str] = None) -> None:
        now = time.monotonic()
        for task, score in zip(tasks, scores):
            lat = now - task.t_window
            failed = score != score           # NaN-safe for float/np
            self.stats.record(lat, lat > self.slo, failed=failed)
            if self.telemetry is not None:
                self.telemetry.record_served(lat, now,
                                             patient=task.patient)
                if failed:
                    tap = getattr(self.telemetry, "record_failure", None)
                    if tap is not None:
                        tap(now, patient=task.patient)
            if self.tracer is not None:
                st = task.stages or {}
                self.tracer.record(_spans.SpanRecord(
                    patient=task.patient, tier=task.tier,
                    status=cause or ("failed" if failed else "ok"),
                    t_submit=task.t_window, t_dequeue=task.t_dequeue,
                    t_flush=task.t_flush, t_retire=now,
                    batch_n=task.batch_n,
                    marshal_s=st.get("marshal", 0.0),
                    dispatch_s=st.get("dispatch", 0.0),
                    gather_s=st.get("gather", 0.0)))
            self._results.put((task.patient, score, lat, task.windows))
        for _ in tasks:
            self.q.task_done()

    # ----------------------------------------------------------- watchdog
    def _begin_inflight(self, tasks: Sequence) -> None:
        if self.deadline is None:
            return
        with self._wd_lock:
            self._inflight[self._token()] = (time.monotonic(),
                                             list(tasks))

    def heartbeat(self) -> bool:
        """Refresh the calling worker's in-flight deadline.  For
        handlers legitimately WAITING — a device-loss retry loop riding
        out a failover restage — so the watchdog keeps catching silent
        hangs without NaN-failing a co-batch that is alive and making
        progress.  A genuinely stalled worker never calls this, which
        is exactly the distinction the watchdog needs.  Returns False
        when the watchdog already abandoned the co-batch (the caller's
        scores will be discarded; it may stop retrying)."""
        if self.deadline is None:
            return True
        me = self._token()
        with self._wd_lock:
            if me in self._inflight:
                _, tasks = self._inflight[me]
                self._inflight[me] = (time.monotonic(), tasks)
                return True
            return me not in self._abandoned

    def _end_inflight(self) -> bool:
        """Clear this worker's in-flight record.  Returns False when the
        watchdog already gave up on the co-batch (retired it NaN and
        respawned a replacement): the late scores must be DISCARDED and
        the worker must exit, so each query retires exactly once."""
        if self.deadline is None:
            return True
        me = self._token()
        with self._wd_lock:
            self._inflight.pop(me, None)
            if me in self._abandoned:
                self._abandoned.discard(me)
                return False
        return True

    def _watch(self) -> None:
        """Deadline enforcement: a co-batch in-flight longer than
        ``deadline_seconds`` is failed safely (NaN scores — the same
        path a poisoned flush takes) and its worker replaced.  Never
        blocks on the stalled handler itself."""
        while not self._stop.wait(self._wd_interval):
            now = time.monotonic()
            overdue = []
            with self._wd_lock:
                for token, (t0, tasks) in list(self._inflight.items()):
                    if now - t0 > self.deadline:
                        del self._inflight[token]
                        self._abandoned.add(token)
                        overdue.append(tasks)
            for tasks in overdue:
                self.stats.record_stall()
                log.warning("watchdog: co-batch of %d overran deadline "
                            "%.3fs; failing NaN and respawning worker",
                            len(tasks), self.deadline)
                self._retire(tasks, [float("nan")] * len(tasks),
                             cause="watchdog")
                w = self._make_worker()
                self._workers.append(w)
                w.start()

    def _call_batch(self, windows: List[Dict], tier=None) -> List[float]:
        if self.tier_of is None:
            return list(self.batch_handler(windows))
        return list(self.batch_handler(windows, tier))

    def _safe_batch_scores(self, windows: List[Dict],
                           tier=None) -> List[float]:
        """A failing flush must not kill the worker or drop its healthy
        co-batched queries: retry singly, scoring only the bad ones NaN."""
        try:
            return self._call_batch(windows, tier)
        except Exception:
            out = []
            for w in windows:
                try:
                    out.extend(self._call_batch([w], tier))
                except Exception:
                    out.append(float("nan"))
            return out

    def _run_batched(self) -> None:
        # short poll only while a batch is coalescing (to honor
        # max_wait); block at the long timeout when idle
        coalesce_poll = min(0.05, self.batcher.max_wait / 2 or 0.05)
        tiered = self.tier_of is not None
        tracing = self.tracer is not None
        while not self._stop.is_set():
            timeout = 0.05 if not len(self.batcher) else coalesce_poll
            try:
                task = self.q.get(timeout=timeout)
                if tracing:
                    task.t_dequeue = time.monotonic()
                if tiered:
                    # the tier is sampled at ROUTING time: a mid-queue
                    # escalation moves the patient's NEXT queries.  A
                    # failing tier_of must not kill the worker or
                    # strand the popped query — route to the default
                    # lane (None: TierRouter/TieredEnsemble fall back)
                    try:
                        key = self.tier_of(task.patient)
                    except Exception:
                        key = None
                    task.tier = key
                    self.batcher.push(key, task)
                else:
                    self.batcher.push(task)
            except queue.Empty:
                pass
            if tiered:
                tier = self.batcher.ready()
                if tier is NO_LANE:
                    continue
                tasks = self.batcher.pop_batch(tier)
            else:
                tier = None
                if not self.batcher.ready():
                    continue
                tasks = self.batcher.pop_batch()
            if not tasks:
                continue
            windows = [t.windows for t in tasks]
            if tracing:
                # the stamps/sink are per co-batch: every rider shares
                # the flush time and the handler's stage attribution
                t_flush = time.monotonic()
                for t in tasks:
                    t.t_flush = t_flush
                    t.batch_n = len(tasks)
                self._begin_inflight(tasks)
                with _spans.collect() as acc:
                    scores = self._safe_batch_scores(windows, tier)
                for t in tasks:
                    t.stages = acc
            else:
                self._begin_inflight(tasks)
                scores = self._safe_batch_scores(windows, tier)
            if not self._end_inflight():
                return                  # watchdog replaced this worker
            self._retire(tasks, scores)

    def _run_slots(self) -> None:
        """Slot-engine worker: no handler, no batcher, no dispatch —
        wait for the tick covering the task's close version, then one
        host int read.  The wait is bounded by ``slot_wait_timeout``
        (default 10 tick intervals, at least 1 s): a stopped ticker or
        a slot gone stale retires the query NaN instead of blocking
        forever — the tick-age guard in server form."""
        eng = self.slot_engine
        while not self._stop.is_set():
            try:
                task = self.q.get(timeout=0.05)
            except queue.Empty:
                continue
            task.t_dequeue = time.monotonic()
            ok = eng.wait_scored(task.patient, task.version,
                                 timeout=self._slot_wait)
            task.t_flush = time.monotonic()
            if ok:
                try:
                    score = eng.read(task.patient)
                except KeyError:          # discharged after scoring
                    score = float("nan")
            else:
                score = float("nan")
            self._retire([task], [score],
                         cause=None if ok else "stale")

    def _run(self, token: int = -1) -> None:
        # stamp this worker's epoch token before any watchdog-visible
        # work; everything downstream (_begin/_end_inflight, heartbeat)
        # reads it from the thread-local
        self._worker_token.token = token
        if self.engine == "slots":
            return self._run_slots()
        if self.batch_handler is not None:
            return self._run_batched()
        tracing = self.tracer is not None
        while not self._stop.is_set():
            try:
                task = self.q.get(timeout=0.05)
            except queue.Empty:
                continue
            if tracing:
                # scalar path has no coalesce stage: dequeue == flush
                task.t_dequeue = task.t_flush = time.monotonic()
                self._begin_inflight([task])
                try:
                    with _spans.collect() as acc:
                        score = self.handler(task.windows)
                except Exception:
                    score = float("nan")
                task.stages = acc
            else:
                self._begin_inflight([task])
                try:
                    score = self.handler(task.windows)
                except Exception:
                    score = float("nan")
            if not self._end_inflight():
                return                  # watchdog replaced this worker
            self._retire([task], [score])

    def results(self, max_items: int = 0) -> List:
        """Retired queries as ``(patient, score, latency, windows)``
        tuples; ``windows`` is the submitted payload (its ``extra`` side
        channel lets harnesses correlate results back to query ids)."""
        out = []
        while not self._results.empty() and (
                not max_items or len(out) < max_items):
            out.append(self._results.get_nowait())
        return out

    def drain(self, timeout: float = 30.0) -> None:
        """Block until every submitted query has been FULLY processed
        (queue.join semantics, with a timeout).  Checking ``q.empty()``
        is not enough: a worker may have popped the last task and still
        be mid-handler (or the task may be coalescing in the batcher),
        which used to undercount ``stop()`` stats."""
        deadline = time.monotonic() + timeout
        with self.q.all_tasks_done:
            while self.q.unfinished_tasks:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self.q.all_tasks_done.wait(min(0.05, remaining))

    def stop(self, join_timeout: float = 2.0) -> ServerStats:
        """Drain, stop workers and watchdog, and report.  Threads that
        failed to exit (e.g. a handler still stalled past the join
        timeout) are listed by name in ``self.leaked`` and logged —
        never silently ignored."""
        self.drain()
        self._stop.set()
        threads = list(self._workers)
        if self._watchdog is not None:
            threads.append(self._watchdog)
        for t in threads:
            t.join(timeout=join_timeout)
        self.leaked = [t.name for t in threads if t.is_alive()]
        if self.ticker_watchdog is not None:
            # the watchdog stops FIRST so it cannot respawn a ticker
            # generation behind the ticker join below
            if not self.ticker_watchdog.stop(join_timeout):
                self.leaked.append(self.ticker_watchdog.name)
        if self.ticker is not None and not self.ticker.stop(join_timeout):
            # every generation a respawn ever left behind is accounted
            self.leaked.extend(self.ticker.alive_threads())
        if self.leaked:
            log.warning("server stop(): threads still alive: %s",
                        self.leaked)
        return self.stats
