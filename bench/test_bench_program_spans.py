"""The readers of the program's flush span trees (``dispatch_offcpu_share``,
``flush_side_ms`` and their ``.rate`` copies) on synthetic spans with
answers counted by hand, and in a traced run of a tiny cell."""
import time
from types import SimpleNamespace as NS

import numpy as np
import pytest
import torch

from bench.conftest import tiny
from bench.harness import runner
from bench.harness.cells import load_cell, reader
from repro_torch.obs.spans import Span, SpanTree

NAMES = ("dispatch_offcpu_share", "flush_side_ms")


def _span(name, parent, t0, t1, cpu_s):
    s = Span(name, parent)
    s.t0, s.t1, s.cpu_s = t0, t1, cpu_s
    return s


def _tree(t, dispatch_cpu, side=0.0, combine=0.0):
    """A flush starting at ``t``: 10 ms of marshal, 40 ms of dispatch of
    which ``dispatch_cpu`` on the CPU, then side and combine."""
    tree = SpanTree("flush")
    tree.spans = [
        _span("flush", -1, t, t + 0.1, 0.05),
        _span("flush.marshal", 0, t, t + 0.01, 0.01),
        _span("flush.dispatch", 0, t + 0.01, t + 0.05, dispatch_cpu),
        _span("flush.bucket", 2, t + 0.01, t + 0.05, 0.0),
        _span("flush.side", 0, t + 0.05, t + 0.05 + side, 0.0),
        _span("flush.combine", 0, t + 0.06, t + 0.06 + combine, 0.0)]
    return tree


def _obs(riders):
    """The window's query spans: one a (rider, its flush's tree)."""
    spans = [NS(flush=tree) for tree in riders]
    return {"spans": spans, "latency_s": [0.1] * len(spans)}


def _two_workers():
    # worker A's flush [0, 0.1) and worker B's [0.02, 0.12) overlap in
    # time; A carried two riders, B one
    a = _tree(0.0, 0.030, side=0.004, combine=0.002)
    b = _tree(0.02, 0.010, side=0.006, combine=0.004)
    return _obs([a, a, b])


def test_readings_by_hand():
    obs = _two_workers()
    # dispatch: 40 ms each; off-CPU 10 + 30 ms of 80 (A counted once)
    assert reader("dispatch_offcpu_share")(obs) == pytest.approx(50.0)
    # side + combine: (4 + 2) and (6 + 4) ms over two flushes
    assert reader("flush_side_ms")(obs) == pytest.approx(8.0)


@pytest.mark.parametrize("name", NAMES)
def test_rate_copy_reads_the_same(name):
    obs = _two_workers()
    assert reader(f"{name}.rate")(obs) == reader(name)(obs)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("gap", ["dropped", "no_tree", "no_spans"])
def test_partial_sample_reads_nothing(name, gap):
    obs = _two_workers()
    if gap == "dropped":            # a window query with no span left
        obs["latency_s"].append(0.1)
    elif gap == "no_tree":          # a program that hangs no tree on a span
        obs["spans"].append(NS())
        obs["latency_s"].append(0.1)
    else:
        obs = {"latency_s": [0.1]}
    assert reader(name)(obs) is None


@pytest.mark.parametrize("workload,suffix", [("zoo12-steady", ""),
                                             ("zoo60-steady", ".rate")])
def test_traced_run_reads_the_flush_trees(workload, suffix):
    cell = tiny(load_cell(workload))
    out = runner.run(cell, 2 ** 31 + 5, 1.0, True, torch.device("cpu"),
                     time.monotonic())
    assert out["correct"], out["checks"]
    m = out["metrics"]
    for name in NAMES:
        v = m[name + suffix][0]
        assert np.isfinite(v) and v >= 0.0
    assert 0.0 <= m["dispatch_offcpu_share" + suffix][0] <= 100.0
    assert m["flush_side_ms" + suffix][0] > 0.0
