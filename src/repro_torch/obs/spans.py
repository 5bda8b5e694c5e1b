"""Per-query span tracing: where did each query's second go?

The controller reasons about T_s + T_q; this module MEASURES that
decomposition per query instead of inferring it.  A query's lifecycle

    submit -> queue wait -> co-batch coalesce -> marshal/ref-gather
           -> device dispatch -> host gather -> retire

is captured as one ``SpanRecord`` built from three wall-clock stamps
the server takes anyway (submit, dequeue, flush, retire) plus
sub-stage timings the pipeline reports through a thread-local sink:

* ``queue_s``    = dequeue - submit      (ShedQueue wait)
* ``coalesce_s`` = flush - dequeue       (micro-batch hold)
* ``service_s``  = retire - flush        (handler end-to-end), further
  attributed into ``marshal_s`` (host marshal / on-device ref-gather),
  ``dispatch_s`` (device dispatch loop) and ``gather_s`` (host gather /
  the wait for the device) by ``note()`` calls inside the pipeline.

The sink is deliberately dumb: ``note(stage, seconds)`` adds into a
thread-local dict if (and only if) a ``collect()`` block is active on
this thread, so the pipeline's hot path pays one attribute load and a
truthiness check when tracing is off — the bench asserts the whole
plane stays within its overhead budget.

Failure paths are first-class: a NaN retirement carries
``status="failed"`` and a watchdog kill ``status="watchdog"``, so the
trace stream tells apart "slow but fine" from "died on device".
"""
from __future__ import annotations

import dataclasses
import json
import threading
from collections import deque
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional

import numpy as np

from repro_torch.obs import sketch as _sk

# service-stage keys the pipeline reports via note(); queue/coalesce
# come from the server's own stamps
SERVICE_STAGES = ("marshal", "dispatch", "gather")
STAGES = ("queue", "coalesce") + SERVICE_STAGES

_tls = threading.local()


def note(stage: str, seconds: float) -> None:
    """Attribute ``seconds`` to ``stage`` for the query/batch currently
    being collected on this thread; no-op (one dict load) otherwise."""
    acc = getattr(_tls, "acc", None)
    if acc is not None:
        acc[stage] = acc.get(stage, 0.0) + seconds


@contextmanager
def collect() -> Iterator[Dict[str, float]]:
    """Open a per-thread stage sink; yields the dict the pipeline's
    ``note()`` calls accumulate into.  Reentrancy folds into the
    OUTER sink (sub-flushes attribute to the query being served)."""
    prev = getattr(_tls, "acc", None)
    if prev is not None:
        yield prev
        return
    _tls.acc = acc = {}
    try:
        yield acc
    finally:
        _tls.acc = None


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    """One retired query's lifecycle, stamps in ``time.monotonic``
    space, stage durations in seconds."""
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
    """Bounded sink for retired-query spans + running per-stage
    aggregates.  ``record()`` is called from the server's retire path
    under no lock of its own (the recorder carries one); everything it
    does is O(1).

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
        self.n_spans = 0
        self.n_by_status: Dict[str, int] = {}
        self._stage_sum: Dict[str, float] = {s: 0.0 for s in STAGES}
        self._e2e_sum = 0.0
        self._e2e_hist = np.zeros(_sk.N_BINS)

    # ------------------------------------------------------------ write
    def record(self, span: SpanRecord) -> None:
        with self._lock:
            self._spans.append(span)
            self.n_spans += 1
            self.n_by_status[span.status] = \
                self.n_by_status.get(span.status, 0) + 1
            for stage, sec in span.stage_seconds().items():
                self._stage_sum[stage] += sec
            self._e2e_sum += span.e2e_s
            self._e2e_hist[_sk.bin_index(span.e2e_s)] += 1.0

    # ------------------------------------------------------------- read
    def spans(self) -> List[SpanRecord]:
        with self._lock:
            return list(self._spans)

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

    def e2e_quantile(self, pct: float) -> float:
        with self._lock:
            return _sk.quantile_from_counts(self._e2e_hist, pct)

    # ------------------------------------------------------------ export
    def export_jsonl(self, path: str) -> int:
        """Dump the retained spans as JSON-lines; returns the count."""
        spans = self.spans()
        with open(path, "w") as f:
            for s in spans:
                f.write(json.dumps(s.to_json()) + "\n")
        return len(spans)
