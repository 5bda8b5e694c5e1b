"""Observability plane: O(1) mergeable telemetry sketches, per-query
span tracing, and the Prometheus/JSONL export surface."""
from repro_torch.obs.sketch import (EDGES, N_BINS, REL_ERR_BOUND,
                                    WindowedSketch, quantile_from_counts)
from repro_torch.obs.spans import (SERVICE_STAGES, STAGES, SpanRecord,
                                   SpanRecorder, SpanTree, collect, span)
from repro_torch.obs.export import MetricsExporter, start_metrics_server

__all__ = [
    "EDGES", "N_BINS", "REL_ERR_BOUND", "WindowedSketch",
    "quantile_from_counts",
    "SERVICE_STAGES", "STAGES", "SpanRecord", "SpanRecorder", "SpanTree",
    "collect", "span",
    "MetricsExporter", "start_metrics_server",
]
