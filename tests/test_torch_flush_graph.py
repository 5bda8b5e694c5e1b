"""The flush's CUDA graph (``EnsembleService`` captures one a rung at
``warmup`` and replays it at every flush of that rung).

On the CPU: a CPU service, a sharded service and a legacy-marshal
service capture nothing and take the eager loop, counted in
``eager_flushes``, with the span tree they had (one ``flush.bucket`` a
stacked pass).

On the card (``cuda``-marked, skipped without one):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_flush_graph.py

graph flushes are bitwise the eager loop's at rungs 1, 2, 4 and 8 on the
narrow rung and the full zoo, from ring refs and from host dicts; two
threads flushing different windows through one service each get their
own scores; a replay counts the eager flush's kernel launches; a
raising ``dispatch_guard`` fails the flush before any
score retires and leaves the next one sound; a service captures while
another serves.

This file imports nothing of JAX.
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs.ecg_zoo import zoo_specs
from repro_torch.control.faults import DeviceLostError
from repro_torch.device import lanes
from repro_torch.kernels import _build
from repro_torch.kernels import conv1d_stripe as kconv
from repro_torch.models.ecg_resnext import init_ecg
from repro_torch.obs import spans
from repro_torch.serving import aggregator as ta
from repro_torch.serving import pipeline as tp
from repro_torch.testing import assert_bitwise

torch.set_num_threads(1)
RUNGS = (1, 2, 4, 8)
SIZES = (1, 2, 3, 8)          # one flush a rung, 3 padded to 4
BEDS = 16


def _members(reduced, L, device="cpu"):
    specs = zoo_specs(reduced=reduced, input_len=L)
    return [tp.ZooMember(s, init_ecg(s, torch.Generator().manual_seed(i),
                                     device))
            for i, s in enumerate(specs)]


def _ingest(L, device, seed=0):
    """``BEDS`` beds of one closed window of random ECG each: the ring
    refs and the same windows as host dicts."""
    rng = np.random.default_rng(seed)
    di = ta.DeviceIngest([ta.ModalitySpec("ecg", 250.0, 3)], BEDS, L / 250.0,
                         device=device)
    refs, dicts = [], []
    for p in range(BEDS):
        ecg = rng.standard_normal((3, L)).astype(np.float32)
        di.ingest(0.0, p, "ecg", ecg)
        refs.append(di.close_window(p, L / 250.0))
        dicts.append({"ecg": ecg})
    return di, refs, dicts


def _score_matrix(svc, batch):
    """The ``[members, P]`` zoo scores of one flush, before Eq. 5."""
    got = {}
    combine = svc._combine

    def keep(score_mat, b):
        got["m"] = score_mat
        return combine(score_mat, b)
    svc._combine = keep
    try:
        svc.predict_batch(batch)
    finally:
        del svc._combine
    return got["m"]


def _dispatch_children(tree):
    i = next(k for k, s in enumerate(tree.spans)
             if s.name == "flush.dispatch")
    return [s.name for s in tree.spans if s.parent == i]


# ------------------------------------------------------------ the CPU
def _cpu_service(kind, members):
    if kind == "sharded":
        lane = lanes(2, "cpu")
        svc = tp.EnsembleService(members, device="cpu", devices=lane)
        return tp.EnsembleService(
            members, device="cpu", devices=lane,
            placement=svc.plan_placement(2, bucket_costs=[1.0] * 4))
    return tp.EnsembleService(members, device="cpu",
                              marshal="legacy" if kind == "legacy"
                              else "packed")


@pytest.mark.parametrize("kind", ["cpu", "sharded", "legacy"])
def test_cpu_sharded_and_legacy_take_the_eager_loop(kind):
    L = 250
    svc = _cpu_service(kind, _members(True, L))
    svc.warmup(batch_sizes=RUNGS)
    assert not svc._graphable and not svc._graphs
    di, refs, dicts = _ingest(L, "cpu")
    batches = [dicts[:3], dicts[3:4]]
    if kind != "legacy":
        batches.append(refs[:8])
    for batch in batches:
        with spans.collect() as tree:
            out = svc.predict_batch(batch)
        assert len(out) == len(batch) and np.all(np.isfinite(out))
        names = [s.name for s in tree.spans]
        assert "flush.replay" not in names
        if kind == "legacy":
            assert names == ["flush", "flush.marshal", "flush.gather",
                             "flush.combine"]
        else:
            assert _dispatch_children(tree) == \
                ["flush.bucket"] * svc.n_buckets
    assert (svc.eager_flushes, svc.graph_flushes) == (len(batches), 0)
    assert svc.dispatch_count == len(batches) * svc.n_buckets


def test_a_capture_tallies_its_own_launches_and_counts_none():
    """Inside ``CaptureLaunches`` a wrapper's bump goes to the tally of
    the thread that captures; another thread's launches meanwhile reach
    the counter; ``add`` is how a replay counts the tally."""
    c = _build.LaunchCount("probe")
    other = threading.Thread(target=lambda: [c.bump() for _ in range(5)])
    with _build.CaptureLaunches() as tally:
        c.bump()
        c.bump()
        other.start()
        other.join()
    assert (tally, c.value) == ({c: 2}, 5)
    c.bump()
    c.add(tally[c])
    assert c.value == 8


# ----------------------------------------------------------- the card
@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


@pytest.fixture(scope="module", params=["zoo12", "zoo60"])
def pair(request, card):
    """A service with a graph at every rung and one with none (never
    warmed, so every flush takes the eager loop), over the same members
    at 30-s windows, and one ingest of ``BEDS`` beds."""
    members = _members(request.param == "zoo12", 7500, card)
    graph = tp.EnsembleService(members, device=card)
    graph.warmup(batch_sizes=RUNGS)
    assert sorted(graph._graphs) == list(RUNGS)
    eager = tp.EnsembleService(members, device=card)
    return graph, eager, _ingest(7500, card)


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["refs", "dicts"])
@pytest.mark.parametrize("P", SIZES)
def test_graph_flush_is_bitwise_the_eager_loop(pair, source, P):
    graph, eager, (_, refs, dicts) = pair
    batch = (refs if source == "refs" else dicts)[BEDS - P:]
    g0, e0 = graph.graph_flushes, eager.eager_flushes
    got = _score_matrix(graph, batch)
    want = _score_matrix(eager, batch)
    assert got.shape == (len(graph.members), P)
    assert_bitwise(got, want, f"P={P} {source}")
    assert (graph.graph_flushes, graph.eager_flushes) == (g0 + 1, 0)
    assert (eager.eager_flushes, eager.graph_flushes) == (e0 + 1, 0)


@pytest.mark.cuda
def test_a_replay_counts_the_launches_of_an_eager_flush(pair):
    """A replayed flush adds to the kernels' launch counters what the
    eager loop's flush adds (the capture itself added nothing)."""
    graph, eager, (_, refs, _) = pair
    counted = []
    for svc in (graph, eager):
        before = kconv.launches_stacked.value
        svc.predict_batch(refs[:8])
        counted.append(kconv.launches_stacked.value - before)
    want = sum(1 + 3 * b.spec.blocks for b in graph._buckets)
    assert counted == [want, want]


@pytest.mark.cuda
def test_graph_flush_span_tree(pair):
    """One ``flush.replay`` under ``flush.dispatch``, no bucket spans;
    ``dispatch_count`` still counts a stacked pass a bucket."""
    graph, _, (_, refs, _) = pair
    n0 = graph.dispatch_count
    with spans.collect() as tree:
        graph.predict_batch(refs[:4])
    assert _dispatch_children(tree) == ["flush.replay"]
    assert [s.name for s in tree.spans if s.parent == 0] == \
        ["flush.marshal", "flush.dispatch", "flush.gather", "flush.combine"]
    assert graph.dispatch_count == n0 + graph.n_buckets


@pytest.mark.cuda
def test_two_threads_each_get_their_own_scores(pair):
    """Two threads flush different windows through one service at the
    same rung, 150 flushes each: every flush is bitwise its own
    windows' eager scores, and every one replayed the graph."""
    graph, eager, (_, refs, dicts) = pair
    batches = [refs[:4], dicts[4:8]]
    want = [eager.predict_batch(b) for b in batches]
    assert want[0] != want[1]
    g0 = graph.graph_flushes
    n, bad, errors = 150, [], []

    def work(k):
        try:
            for i in range(n):
                if graph.predict_batch(batches[k]) != want[k]:
                    bad.append((k, i))
        except Exception as e:          # noqa: BLE001 -- reported below
            errors.append(e)
    ts = [threading.Thread(target=work, args=(k,)) for k in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(600.0)
    assert not any(t.is_alive() for t in ts)
    assert not errors and not bad, (errors, bad[:5])
    assert graph.graph_flushes == g0 + 2 * n and graph.eager_flushes == 0


@pytest.mark.cuda
def test_raising_guard_fails_the_flush_and_the_next_is_sound(pair):
    graph, eager, (_, refs, _) = pair
    seen = []

    def guard(lane):
        seen.append(lane)
        if len(seen) == graph.n_buckets:
            raise DeviceLostError(None, 0)
    g0, n0 = graph.graph_flushes, graph.dispatch_count
    graph.dispatch_guard = guard
    try:
        with pytest.raises(DeviceLostError):
            graph.predict_batch(refs[:8])
        assert seen == [None] * graph.n_buckets
        assert (graph.graph_flushes, graph.dispatch_count) == (g0, n0)
        got = _score_matrix(graph, refs[:8])
    finally:
        graph.dispatch_guard = None
    assert len(seen) == 2 * graph.n_buckets
    assert_bitwise(got, _score_matrix(eager, refs[:8]), "after the fault")
    assert graph.graph_flushes == g0 + 1


@pytest.mark.cuda
def test_capture_while_another_service_serves(card):
    """A staged service warms and captures (as a hot swap stages one)
    while a live service flushes on another thread: both serve their
    eager scores bitwise."""
    members = _members(True, 7500, card)
    live = tp.EnsembleService(members, device=card)
    live.warmup(batch_sizes=(4,))
    eager = tp.EnsembleService(members, device=card)
    _, refs, _ = _ingest(7500, card, seed=3)
    want = eager.predict_batch(refs[:4])
    stop, bad, errors = threading.Event(), [], []

    def serve():
        try:
            while not stop.is_set():
                if live.predict_batch(refs[:4]) != want:
                    bad.append(1)
        except Exception as e:          # noqa: BLE001 -- reported below
            errors.append(e)
    t = threading.Thread(target=serve)
    t.start()
    try:
        staged = tp.EnsembleService(members[::2], device=card)
        staged.warmup(batch_sizes=RUNGS)
    finally:
        stop.set()
        t.join(120.0)
    assert not t.is_alive() and not errors and not bad, (errors, len(bad))
    assert live.graph_flushes > 0 and sorted(staged._graphs) == list(RUNGS)
    staged_eager = tp.EnsembleService(members[::2], device=card)
    assert_bitwise(_score_matrix(staged, refs[:8]),
                   _score_matrix(staged_eager, refs[:8]), "staged")
