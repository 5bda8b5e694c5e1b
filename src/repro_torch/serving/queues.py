"""Timestamped FIFO queues (the per-modality ensemble queues of Fig. 4)
with waiting-time statistics for the latency profiler, plus the
cross-patient ``MicroBatcher`` that coalesces ready windows into fused
ensemble flushes (serving.pipeline.EnsembleService.predict_batch).

``KeyedMicroBatcher`` is the tiered-serving variant: one coalescing
lane per key (acuity tier), so a flush never mixes tiers — every
micro-batch is served whole by ONE tier's (selector, placement)
service while cross-patient amortisation still happens within a tier.
"""
from __future__ import annotations

import collections
import dataclasses
import queue as _queue
import threading
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple


@dataclasses.dataclass
class QueueStats:
    n_pushed: int = 0
    n_popped: int = 0
    total_wait: float = 0.0
    max_wait: float = 0.0
    max_depth: int = 0

    @property
    def mean_wait(self) -> float:
        return self.total_wait / self.n_popped if self.n_popped else 0.0


class TimestampedQueue:
    def __init__(self, name: str = "q"):
        self.name = name
        self._q: Deque[Tuple[float, Any]] = collections.deque()
        self.stats = QueueStats()

    def push(self, t: float, item: Any) -> None:
        self._q.append((t, item))
        self.stats.n_pushed += 1
        self.stats.max_depth = max(self.stats.max_depth, len(self._q))

    def pop(self, now: float) -> Optional[Any]:
        if not self._q:
            return None
        t_in, item = self._q.popleft()
        wait = max(0.0, now - t_in)
        self.stats.n_popped += 1
        self.stats.total_wait += wait
        self.stats.max_wait = max(self.stats.max_wait, wait)
        return item

    def __len__(self) -> int:
        return len(self._q)

    def retain(self, pred: Callable[[Any], bool]) -> List[Any]:
        """Keep only items matching ``pred`` (in order); returns the
        removed items.  Wait stats are untouched — the DES uses this at
        an epoch cutoff, where the removed tasks carry over rather than
        retire."""
        kept, removed = [], []
        for t, item in self._q:
            (kept if pred(item) else removed).append((t, item))
        self._q = collections.deque(kept)
        return [item for _, item in removed]

    def waits(self) -> QueueStats:
        return self.stats


@dataclasses.dataclass
class MicroBatchStats:
    """Items and flushes through a batcher.  The largest batch and the
    summed hold time are not kept: nothing read them, and the hold sum
    cost a pass over every flush's items; a query's coalesce time is
    its span's ``coalesce_s`` (``obs.spans``)."""
    n_items: int = 0
    n_flushes: int = 0

    @property
    def mean_batch(self) -> float:
        return self.n_items / self.n_flushes if self.n_flushes else 0.0


class MicroBatcher:
    """Coalesces ready per-patient windows into one fused ensemble flush.

    The two knobs trade tail latency for dispatch amortisation:

    * ``max_batch``   — flush as soon as this many items are pending
                        (bounds per-flush device work and memory);
    * ``max_wait_ms`` — flush once the OLDEST pending item has waited
                        this long (bounds the latency a lone patient's
                        query pays for batching).

    Thread-safe: server workers push/pop concurrently.  ``pop_batch``
    returns up to ``max_batch`` items (empty list when nothing pending);
    ``ready`` says whether a flush is due.  ``clock`` is injectable so
    the DES/unit tests can drive virtual time.
    """

    def __init__(self, max_batch: int = 8, max_wait_ms: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        assert max_batch >= 1
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self.clock = clock
        self.stats = MicroBatchStats()
        self._lock = threading.Lock()
        self._q: Deque[Tuple[float, Any]] = collections.deque()

    def push(self, item: Any, t: Optional[float] = None) -> None:
        t = self.clock() if t is None else t
        with self._lock:
            self._q.append((t, item))

    def __len__(self) -> int:
        return len(self._q)

    def ready(self, now: Optional[float] = None) -> bool:
        now = self.clock() if now is None else now
        with self._lock:
            if not self._q:
                return False
            return (len(self._q) >= self.max_batch
                    or now - self._q[0][0] >= self.max_wait)

    def pop_batch(self) -> List[Any]:
        """Pops up to ``max_batch`` items (FIFO) and records stats."""
        with self._lock:
            n = min(len(self._q), self.max_batch)
            if not n:
                return []
            self.stats.n_items += n
            self.stats.n_flushes += 1
            return [self._q.popleft()[1] for _ in range(n)]

    def oldest(self) -> Optional[float]:
        """Timestamp of the oldest pending item (None when empty)."""
        with self._lock:
            return self._q[0][0] if self._q else None

    def stats_snapshot(self) -> MicroBatchStats:
        """Consistent copy of the flush stats, taken under the batcher
        lock.  ``pop_batch`` mutates several stats fields in sequence;
        reading the live ``self.stats`` object field-by-field from
        another thread can interleave with that sequence and return a
        torn aggregate (``n_items`` from after a flush, ``n_flushes``
        from before it).  Readers that combine fields — the keyed
        aggregate below, the Prometheus exporter — must go through this
        snapshot."""
        with self._lock:
            return dataclasses.replace(self.stats)


# KeyedMicroBatcher.ready()'s "no lane is due" result: a sentinel, NOT
# None — None is a legitimate lane key (the server's fallback when a
# tier_of callback fails) and must remain poppable
NO_LANE = object()


class KeyedMicroBatcher:
    """Per-key ``MicroBatcher`` lanes (one per acuity tier): coalescing
    NEVER crosses keys, so every flush is served whole by one tier's
    service.  Lanes are created on demand and share the clock and
    flush knobs; ``ready()`` returns the due key whose oldest pending
    item has waited longest (deterministic fairness: the tier closest
    to its wait bound flushes first), or ``NO_LANE``.
    """

    def __init__(self, max_batch: int = 8, max_wait_ms: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self.clock = clock
        self._lock = threading.Lock()
        self._lanes: "collections.OrderedDict[Any, MicroBatcher]" = \
            collections.OrderedDict()

    def lane(self, key: Any) -> MicroBatcher:
        with self._lock:
            lane = self._lanes.get(key)
            if lane is None:
                lane = MicroBatcher(max_batch=self.max_batch,
                                    max_wait_ms=self.max_wait * 1000.0,
                                    clock=self.clock)
                self._lanes[key] = lane
            return lane

    def push(self, key: Any, item: Any,
             t: Optional[float] = None) -> None:
        self.lane(key).push(item, t)

    def __len__(self) -> int:
        with self._lock:
            lanes = list(self._lanes.values())
        return sum(len(l) for l in lanes)

    def ready(self, now: Optional[float] = None) -> Optional[Any]:
        now = self.clock() if now is None else now
        with self._lock:
            lanes = list(self._lanes.items())
        due = []
        for k, l in lanes:
            oldest = l.oldest()       # read before ready(): a racing
            if oldest is None:        # pop may empty the lane between
                continue              # the two checks
            if l.ready(now):
                due.append((k, oldest))
        if not due:
            return NO_LANE
        return min(due, key=lambda kv: (kv[1], str(kv[0])))[0]

    def pop_batch(self, key: Any) -> List[Any]:
        return self.lane(key).pop_batch()

    @property
    def stats(self) -> MicroBatchStats:
        """Aggregate over lanes (the server's reporting surface).  Each
        lane contributes an atomic ``stats_snapshot()`` — summing the
        live per-lane objects field-by-field raced concurrent
        ``pop_batch`` updates and could publish a torn aggregate (e.g.
        ``n_flushes`` from after a flush whose ``n_items`` was read
        before it)."""
        with self._lock:
            lanes = list(self._lanes.values())
        agg = MicroBatchStats()
        for l in lanes:
            s = l.stats_snapshot()
            agg.n_items += s.n_items
            agg.n_flushes += s.n_flushes
        return agg

    def lane_stats(self) -> "Dict[Any, MicroBatchStats]":
        """Per-lane stats SNAPSHOTS (each internally consistent), not
        the live mutable objects."""
        with self._lock:
            lanes = list(self._lanes.items())
        return {k: l.stats_snapshot() for k, l in lanes}


class ShedQueue:
    """Bounded ingest queue whose bound covers UNFINISHED work, not just
    queued items.

    ``queue.Queue(maxsize=N)`` only bounds what sits in the queue proper;
    the server's workers immediately drain it into micro-batcher lanes,
    so under sustained backpressure the lanes grow without limit while
    the queue reads empty.  ``ShedQueue`` bounds ``unfinished_tasks``
    (queued + coalescing + in-flight) instead: admission is refused the
    moment total outstanding work hits ``maxsize``, which is the number
    that actually limits memory and staleness.

    API-compatible with the ``queue.Queue`` subset ``EnsembleServer``
    uses (``put_nowait``/``queue.Full``, ``get(timeout)``/
    ``queue.Empty``, ``task_done``, ``all_tasks_done``,
    ``unfinished_tasks``, ``empty``, ``qsize``), plus priority-aware
    admission: ``put_evicting(item, priority, tag)`` evicts the
    lowest-priority (then oldest) QUEUED item whose priority is strictly
    below the newcomer's — so under overrun the stable tier sheds first
    and a critical query is never bumped by a lesser one.  Eviction only
    reaches items still in the queue; work already coalescing or
    in-flight is past the admission boundary.
    """

    def __init__(self, maxsize: int = 0):
        self.maxsize = maxsize
        self._lock = threading.Lock()
        self.not_empty = threading.Condition(self._lock)
        self.all_tasks_done = threading.Condition(self._lock)
        self._q: Deque[Tuple[float, Any, Any]] = collections.deque()
        self.unfinished_tasks = 0
        # admission counters (export surface; guarded by _lock)
        self.n_admitted = 0
        self.n_evicted = 0
        self.n_rejected = 0

    def qsize(self) -> int:
        with self._lock:
            return len(self._q)

    def empty(self) -> bool:
        return self.qsize() == 0

    def put_nowait(self, item: Any, priority: float = 0.0,
                   tag: Any = None) -> None:
        with self.not_empty:
            if self.maxsize > 0 and self.unfinished_tasks >= self.maxsize:
                self.n_rejected += 1
                raise _queue.Full
            self._q.append((priority, tag, item))
            self.unfinished_tasks += 1
            self.n_admitted += 1
            self.not_empty.notify()

    def put_evicting(self, item: Any, priority: float = 0.0,
                     tag: Any = None) -> Tuple[bool, Optional[Tuple[Any, Any]]]:
        """Admit ``item``, evicting a strictly lower-priority queued item
        if full.  Returns ``(admitted, victim)`` where victim is the
        ``(evicted_item, evicted_tag)`` pair or None.  The victim's
        unfinished slot transfers to the newcomer, so conservation
        accounting (one ``task_done`` per admitted-and-served item)
        stays exact."""
        with self.not_empty:
            if self.maxsize <= 0 or self.unfinished_tasks < self.maxsize:
                self._q.append((priority, tag, item))
                self.unfinished_tasks += 1
                self.n_admitted += 1
                self.not_empty.notify()
                return True, None
            best = None                 # (index, priority): lowest, oldest
            for i, (pr, _tg, _it) in enumerate(self._q):
                if pr < priority and (best is None or pr < best[1]):
                    best = (i, pr)
            if best is None:
                self.n_rejected += 1
                return False, None
            _pr, vtag, victim = self._q[best[0]]
            del self._q[best[0]]
            self._q.append((priority, tag, item))
            self.n_admitted += 1
            self.n_evicted += 1
            # queue length and unfinished count are unchanged: the
            # victim never gets a task_done — its slot is the newcomer's
            self.not_empty.notify()
            return True, (victim, vtag)

    def get(self, timeout: Optional[float] = None) -> Any:
        with self.not_empty:
            if timeout is None:
                while not self._q:
                    self.not_empty.wait()
            else:
                deadline = time.monotonic() + timeout
                while not self._q:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise _queue.Empty
                    self.not_empty.wait(remaining)
            _pr, _tg, item = self._q.popleft()
            return item

    def task_done(self) -> None:
        with self.all_tasks_done:
            unfinished = self.unfinished_tasks - 1
            if unfinished < 0:
                raise ValueError("task_done() called too many times")
            self.unfinished_tasks = unfinished
            if unfinished == 0:
                self.all_tasks_done.notify_all()
