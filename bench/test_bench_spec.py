"""``BENCHMARK.json`` against the harness: every metric has its reader,
every cell its metrics, and a cell whose latency holds no bound reads
its per-layer copies in a traced run."""
import time

import numpy as np
import pytest
import torch

from bench.conftest import tiny
from bench.harness import runner
from bench.harness.cells import BENCH, ROOT, load_cell, load_json

SPEC = load_json(ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_every_metric_has_its_reader(kind):
    for m in SPEC[kind]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]


@pytest.mark.parametrize("workload", CELLS)
def test_every_cell_reports_what_its_layers_move(workload):
    cell = load_cell(workload)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e, (m["name"], m["moves"])
    # a per-layer copy of an end-to-end metric (``<name>.rate``) is read
    # only where that metric is not end to end
    for m in cell.per_layer:
        if "." in m["name"]:
            assert m["name"].split(".")[0] not in e2e, m["name"]


def test_unbound_latency_cell_reads_its_copies():
    cell = tiny(load_cell("zoo60-steady"))
    out = runner.run(cell, 2 ** 31 + 11, 1.0, True, torch.device("cpu"),
                     time.monotonic())
    assert out["correct"], out["checks"]
    m = out["metrics"]
    for name in ("score_p50_ms.rate", "score_p95_ms.rate",
                 "ingest_host_us.rate", "queue_wait_ms.rate",
                 "flush_batch_mean.rate", "flush_dispatch_ms.rate",
                 "flush_mfu.rate"):
        assert name in m and np.isfinite(m[name][0]) and m[name][0] > 0
    assert m["score_p50_ms.rate"][0] == pytest.approx(out["score_p50_ms"])
    assert not any("." not in k for k in m)
    plain = runner.run(cell, 2 ** 31 + 11, 1.0, False, torch.device("cpu"),
                       time.monotonic())
    assert set(plain["metrics"]) == {"scores_per_s", "setup_s"}
