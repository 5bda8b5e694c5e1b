"""The reader of ``flush_graph_share`` and its ``.rate`` copy: the share
of a window's flushes whose span tree holds a ``flush.replay``, on
synthetic span trees counted by hand and in a traced run of a tiny
cell, where the CPU's eager loop reads 0."""
import time
from types import SimpleNamespace as NS

import pytest
import torch

from bench.conftest import tiny
from bench.harness import runner
from bench.harness.cells import load_cell, reader
from repro_torch.obs.spans import Span, SpanTree


def _span(name, parent, t0, t1):
    s = Span(name, parent)
    s.t0, s.t1, s.cpu_s = t0, t1, 0.0
    return s


def _tree(t, replay):
    """A flush starting at ``t`` whose dispatch holds one graph replay,
    or with ``replay`` false one eager bucket pass."""
    tree = SpanTree("flush")
    tree.spans = [
        _span("flush", -1, t, t + 0.1),
        _span("flush.marshal", 0, t, t + 0.01),
        _span("flush.dispatch", 0, t + 0.01, t + 0.05),
        _span("flush.replay" if replay else "flush.bucket", 2, t + 0.01,
              t + 0.05),
        _span("flush.combine", 0, t + 0.06, t + 0.07)]
    return tree


def _obs(riders):
    """The window's query spans: one a (rider, its flush's tree)."""
    spans = [NS(flush=tree) for tree in riders]
    return {"spans": spans, "latency_s": [0.1] * len(spans)}


def _mixed():
    # a replayed flush carrying two riders and an eager one carrying one
    a, b = _tree(0.0, True), _tree(0.02, False)
    return _obs([a, a, b])


@pytest.mark.parametrize("case,want", [("eager", 0.0), ("replay", 100.0),
                                       ("mixed", 50.0)])
def test_graph_share_by_hand(case, want):
    """Trees without a ``flush.replay`` read 0, all with one 100; of a
    replayed flush with two riders and an eager one with one, each
    flush counts once."""
    a = _tree(0.0, replay=case != "eager")
    b = _tree(0.02, replay=case == "replay")
    assert reader("flush_graph_share")(_obs([a, a, b])) == want


def test_rate_copy_reads_the_same():
    obs = _mixed()
    assert reader("flush_graph_share.rate")(obs) == \
        reader("flush_graph_share")(obs) == 50.0


@pytest.mark.parametrize("gap", ["dropped", "no_tree", "no_spans"])
def test_partial_sample_reads_nothing(gap):
    obs = _mixed()
    if gap == "dropped":            # a window query with no span left
        obs["latency_s"].append(0.1)
    elif gap == "no_tree":          # a window query without a flush tree
        obs["spans"].append(NS(flush=None))
        obs["latency_s"].append(0.1)
    else:
        obs = {"latency_s": [0.1]}
    assert reader("flush_graph_share")(obs) is None


@pytest.mark.parametrize("workload,suffix", [("zoo12-steady", ""),
                                             ("zoo60-steady", ".rate")])
def test_traced_cpu_run_reads_no_replay(workload, suffix):
    cell = tiny(load_cell(workload))
    out = runner.run(cell, 2 ** 31 + 7, 1.0, True, torch.device("cpu"),
                     time.monotonic())
    assert out["correct"], out["checks"]
    assert out["metrics"]["flush_graph_share" + suffix][0] == 0.0
