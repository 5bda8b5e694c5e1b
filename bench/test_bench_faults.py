"""A whole run of the harness on the CPU (the look for a card skipped),
sound and with the timed path broken underneath: ``correct`` must come
out true for the sound run and false for each fault a serving cell can
have.  (A cell of one card has no exchange between chips to leave out.)
"""
import time

import numpy as np
import pytest
import torch

from bench.harness import runner


def _unchanged(monkeypatch):
    """A ring write that leaves the ring as it was."""
    from repro_torch.serving import aggregator
    monkeypatch.setattr(aggregator, "ingest_chunk",
                        lambda state, patient, samples: state)


def _half_members(monkeypatch):
    """The Eq. 5 mean taken over half of the zoo's members."""
    from repro_torch.serving.pipeline import EnsembleService
    flush = EnsembleService._flush

    def half(self, dev_wins, P):
        mat = flush(self, dev_wins, P)
        return mat[:max(1, len(mat) // 2)]
    monkeypatch.setattr(EnsembleService, "_flush", half)


def _altered(monkeypatch):
    """One member's probability nudged by 1e-3 where the bucket pass
    produces it."""
    from repro_torch.serving import pipeline
    scores = pipeline._bucket_scores

    def nudged(b, xs, impl):
        y = scores(b, xs, impl).clone()
        y[0, 0] += 1e-3
        return y
    monkeypatch.setattr(pipeline, "_bucket_scores", nudged)


FAULTS = {"sound": None, "state_unchanged": _unchanged,
          "half_the_members": _half_members, "answer_altered": _altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_correct_only_when_sound(tiny_cell, monkeypatch, fault):
    if FAULTS[fault] is not None:
        FAULTS[fault](monkeypatch)
    out = runner.run(tiny_cell, 2 ** 31 + 77, 1.0, False,
                     torch.device("cpu"), time.monotonic())
    assert out["attempted"] == tiny_cell.n_beds
    assert out["correct"] is (fault == "sound"), out["checks"]
    if fault == "sound":
        assert out["failed"] == 0
        assert set(out["metrics"]) == {"score_p50_ms", "scores_per_s",
                                       "setup_s"}
        assert out["checks"]["max_abs_err"]["value"] < 1e-6


def test_traced_run_reads_the_span_metrics(tiny_cell):
    out = runner.run(tiny_cell, 5, 1.0, True, torch.device("cpu"),
                     time.monotonic())
    assert out["correct"]
    m = out["metrics"]
    for name in ("score_p95_ms", "ingest_host_us", "queue_wait_ms",
                 "flush_batch_mean", "flush_dispatch_ms", "flush_mfu"):
        assert name in m and np.isfinite(m[name][0]) and m[name][0] > 0
    # the device's metrics read a CUDA trace: none on the CPU
    assert "device_idle_share" not in m and "busy_s" not in out


def test_latency_is_stamped_by_the_harness(tiny_cell, monkeypatch):
    """The server's own latency is moved by 100 s: the run's latencies,
    taken on the harness's clock, do not move with it."""
    from repro_torch.serving.server import EnsembleServer
    submit = EnsembleServer.submit

    def early(self, patient, windows, t_window=None):
        return submit(self, patient, windows, t_window=t_window - 100.0)
    monkeypatch.setattr(EnsembleServer, "submit", early)
    out = runner.run(tiny_cell, 2 ** 31 + 78, 1.0, False,
                     torch.device("cpu"), time.monotonic())
    assert out["correct"] and out["failed"] == 0
    assert max(out["latency_ms"]) < 10e3
    assert abs(out["load"]["server_latency_gap_ms"] - 100e3) < 1.0
