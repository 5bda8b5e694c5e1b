"""Observability plane: O(1) mergeable telemetry sketches and per-query
span tracing (the Prometheus/JSONL export surface is not ported yet)."""
from repro_torch.obs.sketch import (EDGES, N_BINS, REL_ERR_BOUND,
                                    WindowedSketch, quantile_from_counts)
from repro_torch.obs.spans import (SERVICE_STAGES, STAGES, SpanRecord,
                                   SpanRecorder, collect, note)

__all__ = [
    "EDGES", "N_BINS", "REL_ERR_BOUND", "WindowedSketch",
    "quantile_from_counts",
    "SERVICE_STAGES", "STAGES", "SpanRecord", "SpanRecorder",
    "collect", "note",
]
