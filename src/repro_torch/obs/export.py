"""Export plane: Prometheus text exposition + JSONL trace dumps (the
port of ``repro/obs/export.py``: the same metric names, labels and
exposition format, letter for letter).

``MetricsExporter`` is a pull-style renderer over whatever serving
objects it was attached to — any subset of

* ``server``     — ``serving.server.EnsembleServer`` (stats, queue
                   depth/admission, micro-batcher aggregates);
* ``telemetry``  — ``SloTelemetry`` or ``TieredTelemetry`` (window
                   gauges; tiered telemetry exports per-tier labeled
                   series plus the merged fleet view, and the sketch's
                   latency histogram goes out as a native Prometheus
                   cumulative ``_bucket{le=...}`` series);
* ``controller`` — ``AdaptiveController``/``TieredController``
                   (decision counters);
* ``tracer``     — ``obs.spans.SpanRecorder`` (per-stage attributed
                   seconds, span counts by status);
* ``service``    — ``EnsembleService`` (dispatch/H2D counters);
* ``tiers``      — ``control.tiers.TieredEnsemble`` (per-tier rung /
                   ensemble size gauges, named ``lane_*`` as in the
                   reference).

``render()`` walks the attached objects and returns the exposition
text; ``dump(path)`` writes it; ``start_metrics_server`` serves it at
``/metrics`` from a stdlib ``http.server`` thread (no third-party
dependency).  Nothing here holds long-lived state of its own — every
scrape reads the live objects, so a scrape is always current and an
exporter can be attached/dropped freely.
"""
from __future__ import annotations

import http.server
import json
import threading
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.obs import sketch as _sk

_NAMESPACE = "holmes"


def _fmt_labels(labels: Dict[str, object]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels.items())
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v != v:
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == -float("inf"):
        return "-Inf"
    return repr(float(v))


class MetricsExporter:
    def __init__(self, server=None, telemetry=None, controller=None,
                 tracer=None, service=None, tiers=None,
                 namespace: str = _NAMESPACE):
        self.server = server
        self.telemetry = telemetry
        self.controller = controller
        self.tracer = tracer
        self.service = service
        self.tiers = tiers
        self.namespace = namespace

    # ------------------------------------------------------- rendering
    def _emit(self, lines: List[str], name: str, mtype: str, help_: str,
              samples: Iterable[Tuple[Dict[str, object], float]],
              suffix: str = "") -> None:
        full = f"{self.namespace}_{name}"
        lines.append(f"# HELP {full} {help_}")
        lines.append(f"# TYPE {full} {mtype}")
        for labels, value in samples:
            lines.append(
                f"{full}{suffix}{_fmt_labels(labels)} {_fmt_value(value)}")

    def _server_lines(self, lines: List[str]) -> None:
        s = self.server
        st = s.stats
        self._emit(lines, "served_total", "counter",
                   "Retired queries (including failures)",
                   [({}, st.served)])
        self._emit(lines, "slo_violations_total", "counter",
                   "Retired queries over the SLO", [({}, st.slo_violations)])
        self._emit(lines, "failed_total", "counter",
                   "NaN-scored retirements", [({}, st.failed)])
        self._emit(lines, "stalls_total", "counter",
                   "Watchdog-killed co-batches", [({}, st.stalls)])
        self._emit(lines, "shed_total", "counter",
                   "Rejected queries by tier",
                   [({"tier": str(t)}, n)
                    for t, n in sorted(st.rejected.items(),
                                       key=lambda kv: str(kv[0]))]
                   or [({}, st.shed)])
        q = s.q
        self._emit(lines, "queue_depth", "gauge",
                   "Queued ingest items", [({}, q.qsize())])
        self._emit(lines, "queue_unfinished", "gauge",
                   "Outstanding work (queued + coalescing + in-flight)",
                   [({}, q.unfinished_tasks)])
        self._emit(lines, "queue_admitted_total", "counter",
                   "Admissions into the shed queue", [({}, q.n_admitted)])
        self._emit(lines, "queue_evicted_total", "counter",
                   "Priority evictions under overrun", [({}, q.n_evicted)])
        self._emit(lines, "queue_rejected_total", "counter",
                   "Refused admissions", [({}, q.n_rejected)])
        b = s.batcher.stats
        self._emit(lines, "batch_flushes_total", "counter",
                   "Micro-batch flushes", [({}, b.n_flushes)])
        self._emit(lines, "batch_items_total", "counter",
                   "Queries through the micro-batcher", [({}, b.n_items)])
        self._emit(lines, "batch_mean_size", "gauge",
                   "Mean co-batch size", [({}, b.mean_batch)])

    def _telemetry_lines(self, lines: List[str]) -> None:
        tel = self.telemetry
        slices = getattr(tel, "slices", None)
        views = ([("fleet", tel.fleet)] + sorted(slices.items())) \
            if slices is not None else [("fleet", tel)]
        gauges = []
        for name, view in views:
            snap = view.snapshot()
            labels = {"tier": name}
            gauges.append((labels, snap))
        for key, help_ in (
                ("arrival_rate", "Arrivals/s over the sliding window"),
                ("violation_rate", "SLO violation fraction (window)"),
                ("p50", "Median served latency (window, seconds)"),
                ("p99", "p99 served latency (window, seconds)")):
            self._emit(lines, f"window_{key}", "gauge", help_,
                       [(labels, getattr(snap, key))
                        for labels, snap in gauges])
        self._emit(lines, "window_served", "gauge",
                   "Served queries in the window",
                   [(labels, snap.n_served) for labels, snap in gauges])
        self._emit(lines, "window_shed", "gauge",
                   "Shed queries in the window",
                   [(labels, snap.n_shed) for labels, snap in gauges])
        self._emit(lines, "window_failed", "gauge",
                   "NaN retirements in the window",
                   [(labels, snap.n_failed) for labels, snap in gauges])
        # sketch-native latency histogram (fleet view), as a Prometheus
        # cumulative bucket series
        fleet = views[0][1]
        hist = None
        tap = getattr(fleet, "latency_histogram", None)
        if tap is not None:
            hist = tap()
        if hist is not None:
            cum = np.cumsum(hist)
            samples = [({"le": f"{edge:.6g}"}, cum[i])
                       for i, edge in enumerate(_sk.EDGES)]
            samples.append(({"le": "+Inf"}, cum[-1]))
            full = f"{self.namespace}_latency_seconds"
            lines.append(f"# HELP {full} Served latency (window)")
            lines.append(f"# TYPE {full} histogram")
            for labels, value in samples:
                lines.append(
                    f"{full}_bucket{_fmt_labels(labels)} "
                    f"{_fmt_value(value)}")
            lines.append(f"{full}_count {_fmt_value(cum[-1])}")

    def _controller_lines(self, lines: List[str]) -> None:
        counts = self.controller.decision_counts()
        self._emit(lines, "controller_decisions_total", "counter",
                   "Actions taken by the adaptive controller",
                   [({"decision": k}, v)
                    for k, v in sorted(counts.items())])

    def _tracer_lines(self, lines: List[str]) -> None:
        att = self.tracer.attribution()
        self._emit(lines, "spans_total", "counter",
                   "Retired-query spans by status",
                   [({"status": k}, v)
                    for k, v in sorted(att["by_status"].items())])
        self._emit(lines, "span_stage_seconds_total", "counter",
                   "Query-seconds attributed to each lifecycle stage",
                   [({"stage": k}, v)
                    for k, v in sorted(att["stage_seconds"].items())])
        self._emit(lines, "span_coverage", "gauge",
                   "Fraction of e2e latency explained by measured stages",
                   [({}, att["coverage"])])

    def _service_lines(self, lines: List[str]) -> None:
        svc = self.service
        self._emit(lines, "dispatches_total", "counter",
                   "Device dispatches issued",
                   [({}, getattr(svc, "dispatch_count", 0))])
        self._emit(lines, "h2d_bytes_total", "counter",
                   "Host-to-device bytes shipped by marshaling",
                   [({}, getattr(svc, "h2d_bytes", 0))])
        self._emit(lines, "marshal_seconds_total", "counter",
                   "Seconds spent marshaling flushes",
                   [({}, getattr(svc, "marshal_seconds", 0.0))])

    def _tiers_lines(self, lines: List[str]) -> None:
        metrics = self.tiers.swapper_metrics()
        self._emit(lines, "lane_rung", "gauge",
                   "Ladder rung per tier lane",
                   [({"tier": t}, m["rung"])
                    for t, m in sorted(metrics.items())])
        self._emit(lines, "lane_members", "gauge",
                   "Active ensemble size per tier lane",
                   [({"tier": t}, m["n_members"])
                    for t, m in sorted(metrics.items())])

    def render(self) -> str:
        lines: List[str] = []
        if self.server is not None:
            self._server_lines(lines)
        if self.telemetry is not None:
            self._telemetry_lines(lines)
        if self.controller is not None:
            self._controller_lines(lines)
        if self.tracer is not None:
            self._tracer_lines(lines)
        if self.service is not None:
            self._service_lines(lines)
        if self.tiers is not None:
            self._tiers_lines(lines)
        return "\n".join(lines) + "\n"

    # ---------------------------------------------------------- outputs
    def dump(self, path: str) -> str:
        text = self.render()
        with open(path, "w") as f:
            f.write(text)
        return text

    def summary(self) -> Dict[str, object]:
        """Machine-readable digest for benches (the BENCH_obs source)."""
        out: Dict[str, object] = {}
        if self.tracer is not None:
            out["attribution"] = self.tracer.attribution()
        if self.server is not None:
            st = self.server.stats
            out["server"] = {"served": st.served, "shed": st.shed,
                             "failed": st.failed, "stalls": st.stalls}
        if self.controller is not None:
            out["decisions"] = self.controller.decision_counts()
        return out


class _MetricsHandler(http.server.BaseHTTPRequestHandler):
    exporter: Optional[MetricsExporter] = None

    def do_GET(self):                                 # noqa: N802
        if self.path.rstrip("/") not in ("", "/metrics"):
            self.send_response(404)
            self.end_headers()
            return
        body = self.server.exporter.render().encode()
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):                     # quiet scrapes
        pass


def start_metrics_server(exporter: MetricsExporter, port: int = 0,
                         host: str = "127.0.0.1"):
    """Serve ``exporter.render()`` at ``/metrics`` on a daemon thread;
    returns the ``HTTPServer`` (``server_port`` has the bound port,
    call ``.shutdown()`` to stop)."""
    httpd = http.server.ThreadingHTTPServer((host, port), _MetricsHandler)
    httpd.exporter = exporter
    thread = threading.Thread(target=httpd.serve_forever, daemon=True,
                              name="repro-metrics")
    thread.start()
    return httpd


def write_spans_jsonl(tracer, path: str) -> int:
    """JSONL trace export (one span per line); returns the span count."""
    return tracer.export_jsonl(path)
