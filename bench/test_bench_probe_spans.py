"""The unregistered span probe (``bench/probe_spans.py``): its readings on
a synthetic trace and synthetic ingest trees with answers counted by
hand, and the probe's traced run and witness on a tiny cell on the
CPU."""
import pytest
import torch

from bench import probe_spans as probe
from bench.conftest import tiny
from bench.harness.cells import load_cell
from repro_torch.obs.spans import Span, SpanTree


def _ev(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _slice(*extra):
    """A 10-ms slice: worker A's dispatch [1000, 3000] µs and worker B's
    [2000, 4000] overlap; device ops 200 µs and 100 µs inside, one that
    runs 100 µs into the ranges' end and one after them."""
    return [_ev("slice_start", 0.0, 1.0, "cpu_op"),
            _ev(probe.DISPATCH, 1000.0, 2000.0),
            _ev(probe.DISPATCH, 2000.0, 2000.0),
            _ev("k1", 1500.0, 200.0, "kernel"),
            _ev("k2", 2500.0, 100.0, "gpu_memcpy"),
            _ev("k3", 3900.0, 300.0, "kernel"),
            _ev("k4", 5000.0, 500.0, "kernel"),
            _ev("slice_end", 9999.0, 1.0, "cpu_op"), *extra]


def test_dispatch_idle_share_of_two_workers_by_hand():
    # union of the ranges 3000 µs; device busy inside it 200 + 100 + 100
    assert probe.dispatch_idle_share(_slice()) == pytest.approx(
        100.0 * (1.0 - 400.0 / 3000.0))


def test_range_the_slice_cuts_is_left_out():
    # a dispatch range from the slice's first µs, busy throughout
    cut = [_ev(probe.DISPATCH, 0.0, 900.0), _ev("k0", 0.0, 900.0, "kernel")]
    assert probe.dispatch_idle_share(_slice(*cut)) == \
        probe.dispatch_idle_share(_slice())


@pytest.mark.parametrize("events", [[], [_ev("k", 0.0, 10.0, "kernel")]],
                         ids=["empty", "no_range"])
def test_no_whole_range_reads_nothing(events):
    assert probe.dispatch_idle_share(events) is None


def _ingest(t0, wall, cpu, lock):
    tree = SpanTree("ingest")
    for name, parent, a, b, c in (("ingest", -1, t0, t0 + wall, cpu),
                                  ("ingest.lock", 0, t0, t0 + lock, 0.0)):
        s = Span(name, parent)
        s.t0, s.t1, s.cpu_s = a, b, c
        tree.spans.append(s)
    return tree


def test_ingest_readings_by_hand():
    trees = [_ingest(1.0, 900e-6, 700e-6, 40e-6),
             _ingest(2.0, 500e-6, 400e-6, 20e-6),
             _ingest(9.0, 1.0, 0.0, 1.0)]            # after the window
    got = probe.ingest_readings(trees, 1.0, 5.0, dropped=0)
    assert got["n"] == 2
    assert got["wall_us"] == pytest.approx(700.0)
    assert got["cpu_us"] == pytest.approx(550.0)
    assert got["ingest_offcpu_us"] == pytest.approx(150.0)
    assert got["ingest_lock_wait_us"] == pytest.approx(30.0)


@pytest.mark.parametrize("dropped,lo", [(1, 1.0), (0, 10.0)],
                         ids=["dropped", "none_in_window"])
def test_partial_or_empty_ingest_sample_reads_nothing(dropped, lo):
    trees = [_ingest(1.0, 900e-6, 700e-6, 40e-6)]
    assert probe.ingest_readings(trees, lo, lo + 4.0, dropped) is None


def test_probe_runs_a_tiny_cell_on_the_cpu():
    cell = tiny(load_cell("zoo12-steady"))
    dev = torch.device("cpu")
    run = probe.traced_run(cell, 2 ** 31 + 9, 1.0, dev)
    assert run["correct"]
    assert run["ingest"]["n"] > 0
    assert run["ingest"]["ingest_offcpu_us"] >= 0.0
    assert run["dispatch"]["n"] > 0
    assert run["dispatch_idle_share"] is None        # no device trace
    w = probe.witness(cell, 2 ** 31 + 9, 2, dev)
    for name in ("alone", "beside_ingest", "beside_cpu_ingest",
                 "beside_flushes"):
        assert w[name]["dispatch"]["n"] == 2
        assert 0.0 <= w[name]["dispatch"]["offcpu_share"] <= 100.0
        assert (w[name]["beside_per_s"] > 0.0) == (name != "alone")
