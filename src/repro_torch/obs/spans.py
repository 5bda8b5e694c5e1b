"""Span tracing inside the serving path: where did each query's second go?

The controller reasons about T_s + T_q; this module MEASURES that
decomposition per query, down to the stages of the flush it rode in
and the time its threads spent off the CPU.  A query's lifecycle

    submit -> queue wait -> co-batch coalesce -> flush -> retire

is one ``SpanRecord``, built from the server's own stamps (submit,
dequeue, flush, retire) and the spans of its flush:

* ``queue_s``    = dequeue - submit      (ShedQueue wait)
* ``coalesce_s`` = flush - dequeue       (micro-batch hold)
* ``service_s``  = retire - flush        (handler end-to-end), further
  attributed into ``marshal_s`` (host marshal / on-device ref-gather),
  ``dispatch_s`` (device dispatch loop) and ``gather_s`` (host gather /
  the wait for the device): the durations of the flush's ``marshal``,
  ``dispatch`` and ``gather`` spans.

The span tree
-------------
``collect(kind, ident)`` opens a sink on the calling thread with a root
span named ``kind``; ``span(name)`` opens a child of the innermost span
open on the thread.  The tree, by the names a profiler trace shows
(``holmes.<name>``):

    server.wait             a batched worker blocked on an empty queue
                            (a profiler range alone, ``annotate``)
    flush                   one co-batch (``ident`` is its flush_id)
      flush.marshal         ring gather (or host pack) and its copies
        flush.marshal.lock  acquiring ``DeviceIngest.lock``
      flush.dispatch        issuing every bucket's operations
        flush.bucket        one stacked pass (the eager loop)
        flush.replay        the flush's CUDA graph: the input copies,
                            the replay and the clone of its scores,
                            under the service's graph lock
      flush.gather          the D2H copy that waits for the card
      flush.side            the vitals gather and its readback
        flush.side.lock     acquiring ``DeviceIngest.lock``
      flush.combine         forest, regression, Eq. 5
    ingest                  one ``DeviceIngest.ingest`` call
      ingest.lock           acquiring ``DeviceIngest.lock``
    lm.prefill              one prefill of the LM path (``ident``: the
                            caller's group of sessions)
    lm.step                 one decode step of the served batch
                            (``ident``: its position ``idx``)
      lm.mamba              one run of consecutive Mamba layers (each
                            leaf of ``lm.step`` one replayed CUDA graph
                            on the card)
      lm.shared             one invocation of a shared block (Zamba2)
        lm.shared.attn      its norm, projections, attention and output
        lm.shared.mlp       its norm, MLP, adapter and linear
      lm.head               the final norm and the logits

Each span takes its start and end on ``time.monotonic`` and the
thread's CPU time at both ends (``time.thread_time_ns``), so wall minus
CPU is the time the thread did not run: blocked on a lock, waiting for
the GIL or inside a driver call that sleeps, descheduled.  While a
``torch.profiler`` records, each span also opens
``record_function("holmes.<name>")``, so the interval lands in the
trace as a user annotation (a chrome trace stamps Unix-epoch time,
``baseTimeNanoseconds`` + ``ts`` µs, so a ``time.time_ns`` taken beside
a ``time.monotonic_ns`` maps one clock onto the other).  With no
profiler recording it opens none: a ``record_function`` is a torch op,
which releases the GIL on entry and on exit, and where another thread
keeps the GIL busy (ingest beside a flush) each release can cost the
span's thread a millisecond.  ``annotate(name)`` is such a range alone,
with no span: the server's ``server.wait``.

With no sink open on the thread — the server has no tracer, the ingest
no tracer — ``span()`` costs one thread-local load and a test, and
opens no ``record_function`` even while a profiler runs.  ``count(name,
n)`` adds ``n`` to the open tree's ``counts[name]`` at the same cost
(an LM step counts ``kv_positions``, the K/V positions its attention
reads summed over sessions and invocations, ``launches``, its kernels'
launches, and ``graph_replays``, the CUDA graphs it replayed).

Failure paths are first-class: a NaN retirement carries
``status="failed"`` and a watchdog kill ``status="watchdog"``, so the
trace stream tells apart "slow but fine" from "died on device".
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time
from collections import deque
from typing import Dict, Iterator, List, Optional, Tuple

from torch.autograd import profiler as _profiler
from torch.profiler import record_function

# service-stage keys a SpanRecord carries; queue/coalesce come from the
# server's own stamps
SERVICE_STAGES = ("marshal", "dispatch", "gather")
STAGES = ("queue", "coalesce") + SERVICE_STAGES
PREFIX = "holmes."                 # the spans' names in a profiler trace
_STAGE_OF = {f"flush.{s}": s for s in SERVICE_STAGES}
KINDS = ("query", "ingest")

_tls = threading.local()
_OFF = contextlib.nullcontext()


class Span:
    """One span of a ``SpanTree``: ``name`` (without ``PREFIX``),
    ``t0``/``t1`` on ``time.monotonic`` (s), ``cpu_s`` the thread's CPU
    seconds between them, ``parent`` the index of the enclosing span in
    the tree (-1 for the root)."""

    __slots__ = ("name", "t0", "t1", "cpu_s", "parent")

    def __init__(self, name: str, parent: int):
        self.name = name
        self.parent = parent
        self.t0 = self.t1 = self.cpu_s = 0.0

    @property
    def wall_s(self) -> float:
        return self.t1 - self.t0


class SpanTree:
    """The spans of one unit of work on one thread (a flush, an ingest
    call): the root ``spans[0]`` named ``kind``, then every span in the
    order it opened.  ``ident`` is a flush's flush_id, ``stages`` the
    summed seconds of its marshal, dispatch and gather spans, ``counts``
    the counters ``count`` added while it was open."""

    __slots__ = ("kind", "ident", "spans", "stages", "counts", "_open")

    def __init__(self, kind: str, ident: int = 0):
        self.kind = kind
        self.ident = ident
        self.spans: List[Span] = []
        self.stages: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._open: List[Tuple[int, int]] = []    # (index, CPU ns at open)

    @property
    def root(self) -> Span:
        return self.spans[0]

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def _enter(self, name: str) -> None:
        s = Span(name, self._open[-1][0] if self._open else -1)
        self.spans.append(s)
        s.t0 = time.monotonic()
        self._open.append((len(self.spans) - 1, time.thread_time_ns()))

    def _exit(self) -> None:
        i, cpu0 = self._open.pop()
        cpu = time.thread_time_ns() - cpu0
        s = self.spans[i]
        s.t1 = time.monotonic()
        s.cpu_s = cpu * 1e-9
        stage = _STAGE_OF.get(s.name)
        if stage is not None:
            self.stages[stage] = self.stages.get(stage, 0.0) + s.wall_s


def _profiling() -> bool:
    """Whether a torch profiler records: its module flag, read without a
    torch op (True where this PyTorch has no such flag)."""
    return getattr(_profiler, "_is_profiler_enabled", True)


class _Open:
    """An open span: the tree's stamps, inside a profiler range while a
    profiler records."""

    __slots__ = ("tree", "name", "rf")

    def __init__(self, tree: SpanTree, name: str):
        self.tree = tree
        self.name = name

    def __enter__(self) -> "_Open":
        self.rf = annotate(self.name)
        self.rf.__enter__()
        self.tree._enter(self.name)
        return self

    def __exit__(self, *exc) -> bool:
        self.tree._exit()
        self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A child span ``name`` of the innermost span open on this thread;
    a shared no-op context when no ``collect()`` sink is open here."""
    tree = getattr(_tls, "sink", None)
    if tree is None:
        return _OFF
    return _Open(tree, name)


def count(name: str, n: int) -> None:
    """Add ``n`` to ``counts[name]`` of the tree open on this thread;
    nothing when no ``collect()`` sink is open here."""
    tree = getattr(_tls, "sink", None)
    if tree is not None:
        tree.counts[name] = tree.counts.get(name, 0) + n


def annotate(name: str):
    """The profiler range ``holmes.<name>`` alone, no span: opened only
    while a profiler records, else the shared no-op context."""
    return record_function(PREFIX + name) if _profiling() else _OFF


@contextlib.contextmanager
def held(lock, name: str) -> Iterator[None]:
    """Hold ``lock`` for the block; acquiring it is the span ``name``."""
    with span(name):
        lock.acquire()
    try:
        yield
    finally:
        lock.release()


@contextlib.contextmanager
def collect(kind: str = "flush", ident: int = 0) -> Iterator[SpanTree]:
    """Open a sink on this thread with a root span ``kind``; yields the
    ``SpanTree`` the spans opened inside accumulate into.  Reentrancy
    folds into the OUTER tree (sub-flushes attribute to the query being
    served)."""
    outer = getattr(_tls, "sink", None)
    if outer is not None:
        yield outer
        return
    tree = SpanTree(kind, ident)
    _tls.sink = tree
    try:
        with _Open(tree, kind):
            yield tree
    finally:
        _tls.sink = None


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    """One retired query's lifecycle, stamps in ``time.monotonic``
    space, stage durations in seconds.  ``rid`` is the query's request
    id (submit order), ``flush_id`` and ``flush`` the co-batch it rode
    in and that flush's span tree (None when untraced or killed by the
    watchdog); none of the three is in ``to_json``."""
    patient: int
    tier: Optional[str]
    status: str                     # "ok" | "failed" | "watchdog"
    t_submit: float
    t_dequeue: float
    t_flush: float
    t_retire: float
    batch_n: int                    # co-batch size this query rode in
    marshal_s: float
    dispatch_s: float
    gather_s: float
    rid: int = 0
    flush_id: int = 0
    flush: Optional[SpanTree] = dataclasses.field(
        default=None, compare=False, repr=False)

    @property
    def queue_s(self) -> float:
        return max(self.t_dequeue - self.t_submit, 0.0)

    @property
    def coalesce_s(self) -> float:
        return max(self.t_flush - self.t_dequeue, 0.0)

    @property
    def service_s(self) -> float:
        return max(self.t_retire - self.t_flush, 0.0)

    @property
    def e2e_s(self) -> float:
        return max(self.t_retire - self.t_submit, 0.0)

    def stage_seconds(self) -> Dict[str, float]:
        return {"queue": self.queue_s, "coalesce": self.coalesce_s,
                "marshal": self.marshal_s, "dispatch": self.dispatch_s,
                "gather": self.gather_s}

    def to_json(self) -> Dict[str, object]:
        d = {"patient": self.patient, "tier": self.tier,
             "status": self.status, "t_submit": self.t_submit,
             "t_retire": self.t_retire, "batch_n": self.batch_n,
             "e2e_s": self.e2e_s, "service_s": self.service_s}
        d.update(self.stage_seconds())
        return d


class SpanRecorder:
    """Bounded sinks for retired-query spans and ingest trees, plus
    running per-stage aggregates (a flush's tree rides on the
    ``SpanRecord`` of each query it served).  ``record()`` is called
    from the server's retire path under no lock of its own (the
    recorder carries one); everything it does is O(1).  Each kind keeps
    at most ``keep`` records; ``dropped[kind]`` counts the ones that
    fell out, so a reader can refuse a partial sample.

    ``attribution()`` answers the controller-facing question: across
    the retained horizon, what fraction of query-seconds went to each
    stage, and how much of measured end-to-end latency do the
    measured stages explain (``coverage`` — the bench gates this at
    >= 0.9, so attribution is checked against reality, not assumed).
    """

    def __init__(self, keep: int = 2048):
        self.keep = int(keep)
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=self.keep)
        self._ingests: deque = deque(maxlen=self.keep)
        self.dropped: Dict[str, int] = {k: 0 for k in KINDS}
        self.n_spans = 0
        self.n_by_status: Dict[str, int] = {}
        self._stage_sum: Dict[str, float] = {s: 0.0 for s in STAGES}
        self._e2e_sum = 0.0

    # ------------------------------------------------------------ write
    def _push(self, kind: str, dq: deque, item) -> None:
        if len(dq) == dq.maxlen:
            self.dropped[kind] += 1
        dq.append(item)

    def record(self, span: SpanRecord) -> None:
        with self._lock:
            self._push("query", self._spans, span)
            self.n_spans += 1
            self.n_by_status[span.status] = \
                self.n_by_status.get(span.status, 0) + 1
            for stage, sec in span.stage_seconds().items():
                self._stage_sum[stage] += sec
            self._e2e_sum += span.e2e_s

    def record_ingest(self, tree: SpanTree) -> None:
        with self._lock:
            self._push("ingest", self._ingests, tree)

    # ------------------------------------------------------------- read
    def spans(self) -> List[SpanRecord]:
        with self._lock:
            return list(self._spans)

    def ingests(self) -> List[SpanTree]:
        with self._lock:
            return list(self._ingests)

    def stage_seconds(self) -> Dict[str, float]:
        """Total seconds attributed to each stage, all spans ever."""
        with self._lock:
            return dict(self._stage_sum)

    def attribution(self) -> Dict[str, object]:
        """Per-stage share of total query-seconds + coverage of the
        measured end-to-end time."""
        with self._lock:
            sums = dict(self._stage_sum)
            e2e = self._e2e_sum
            n = self.n_spans
            by_status = dict(self.n_by_status)
        measured = sum(sums.values())
        return {
            "n_spans": n,
            "by_status": by_status,
            "stage_seconds": sums,
            "stage_frac": {s: (v / e2e if e2e > 0 else 0.0)
                           for s, v in sums.items()},
            "e2e_seconds": e2e,
            "mean_e2e_s": e2e / n if n else 0.0,
            "coverage": measured / e2e if e2e > 0 else 0.0,
        }

    # ------------------------------------------------------------ export
    def export_jsonl(self, path: str) -> int:
        """Dump the retained spans as JSON-lines; returns the count."""
        spans = self.spans()
        with open(path, "w") as f:
            for s in spans:
                f.write(json.dumps(s.to_json()) + "\n")
        return len(spans)
