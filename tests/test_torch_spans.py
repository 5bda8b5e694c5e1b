"""The port's span tree (``repro_torch.obs.spans``) on the CPU.

A traced flush through ``EnsembleServer`` -> ``predict_batch`` over
``DeviceWindowRef``s: the shape of its tree (marshal with its lock,
dispatch with one bucket span a stacked pass, gather, side with its
lock, combine, all nested in time), how much of a query's
``service_s`` the stages cover, the request and flush ids a query's
span carries, the same spans in a ``torch.profiler`` trace mapped
through a clock anchor (``time.monotonic_ns`` beside the Unix-epoch
``time.time_ns`` a chrome trace stamps), nothing recorded or opened without
a tracer, off-CPU time of a thread blocked on a lock, the recorder's
drop counts, and the stage durations a ``SpanRecord`` copies.

The card's trace clock, and the tree of a flush that replays its rung's
CUDA graph (one ``flush.replay`` under ``flush.dispatch``), are checked
by the ``cuda``-marked cases:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_spans.py

This file imports nothing of JAX.
"""
import json
import os
import tempfile
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.ecg_zoo import zoo_specs
from repro_torch.models import tabular as ttab
from repro_torch.models.ecg_resnext import init_ecg
from repro_torch.obs import spans
from repro_torch.serving import aggregator as ta
from repro_torch.serving import pipeline as tp
from repro_torch.serving import server as tserver

torch.set_num_threads(1)
WINDOW_S = 16.0
L = int(250 * WINDOW_S)     # a flush long enough (~0.1 s) that its
                            # stages dwarf the µs between them, and the
                            # few ms a loaded host may deschedule the
                            # worker there
N = 8                   # queries a run: two flushes of MAX_BATCH
MAX_BATCH = 4
STAGE_ORDER = ["flush.marshal", "flush.dispatch", "flush.gather",
               "flush.side", "flush.combine"]


@pytest.fixture(scope="module")
def service():
    specs = zoo_specs(reduced=True, input_len=L, blocks=(2,))
    members = [tp.ZooMember(s, init_ecg(s, torch.Generator().manual_seed(i)))
               for i, s in enumerate(specs)]
    rng = np.random.default_rng(0)
    y = rng.integers(0, 2, 40)
    vit = ttab.VitalsForest(7, n_trees=4).fit(
        rng.standard_normal((40, 7, int(WINDOW_S))), y)
    labs = ttab.LogisticRegression(steps=50).fit(
        rng.standard_normal((40, 8)), y)
    svc = tp.EnsembleService(members, vitals_model=vit, labs_model=labs,
                             device="cpu")
    svc.warmup(batch_sizes=(MAX_BATCH,))
    return svc


def _ingest(n, tracer=None):
    return ta.DeviceIngest([ta.ModalitySpec("ecg", 250.0, 3),
                            ta.ModalitySpec("vitals", 1.0, 7)], n, WINDOW_S,
                           device="cpu", tracer=tracer)


def _refs(di, seed=1):
    rng = np.random.default_rng(seed)
    refs = []
    for p in range(di.n_patients):
        di.ingest(0.0, p, "ecg", rng.standard_normal((3, L)).astype(
            np.float32))
        di.ingest(0.0, p, "vitals", rng.standard_normal(
            (7, int(WINDOW_S))).astype(np.float32))
        refs.append(di.close_window(p, WINDOW_S, extra={
            "labs": rng.standard_normal(8).astype(np.float32)}))
    return refs


def _serve(svc, tracer, refs):
    """Every ref submitted before one worker starts, in flushes of
    ``MAX_BATCH`` (the wait bound is never what flushes).  This thread
    sleeps until the last query retires, so it takes the GIL from the
    worker at no stage boundary."""
    srv = tserver.EnsembleServer(batch_handler=svc.predict_batch,
                                 n_workers=1, max_batch=MAX_BATCH,
                                 max_wait_ms=10_000.0, tracer=tracer)
    for p, r in enumerate(refs):
        assert srv.submit(p, r)
    srv.start()
    with srv.q.all_tasks_done:
        assert srv.q.all_tasks_done.wait_for(
            lambda: not srv.q.unfinished_tasks, timeout=60.0)
    stats = srv.stop()
    assert stats.served == len(refs) and stats.failed == 0
    assert not srv.leaked
    return srv


def _all_threads():
    """A profiler that records the server's worker threads too."""
    from torch._C._profiler import _ExperimentalConfig
    return {"experimental_config": _ExperimentalConfig(
        profile_all_threads=True)}


def _profiled(fn):
    """Run ``fn`` under a CPU profiler of every thread; the trace's
    ``holmes.*`` events and its ``baseTimeNanoseconds``."""
    with profile(activities=[ProfilerActivity.CPU],
                 **_all_threads()) as prof:
        fn()
    return _events(prof)


def _events(prof):
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    evs = [e for e in trace["traceEvents"]
           if e.get("ph") == "X" and e.get("name", "").startswith(
               spans.PREFIX)]
    return evs, int(trace.get("baseTimeNanoseconds", 0))


@pytest.fixture(scope="module")
def traced(service):
    """A traced run as the server serves: no profiler recording."""
    rec = spans.SpanRecorder()
    _serve(service, rec, _refs(_ingest(N)))
    return {"rec": rec}


@pytest.fixture(scope="module")
def profiled(service):
    """The same run under a CPU profiler of every thread."""
    rec = spans.SpanRecorder()
    refs = _refs(_ingest(N))
    out = {"anchor": _anchor()}
    out["events"], out["base"] = _profiled(
        lambda: _serve(service, rec, refs))
    out["rec"] = rec
    return out


def _flushes(rec):
    """The flush trees the retained query spans ride on, by flush_id."""
    trees = {id(r.flush): r.flush for r in rec.spans()}
    return sorted(trees.values(), key=lambda t: t.ident)


def _anchor():
    """One pair of clocks: ``time.monotonic_ns`` and the Unix-epoch ns a
    chrome trace stamps (``baseTimeNanoseconds`` + ``ts`` µs)."""
    return time.monotonic_ns(), time.time_ns()


def _trace_us(anchor, t, base_ns):
    """A ``time.monotonic`` stamp (s) as µs after a trace's base."""
    mono, unix = anchor
    return (round(t * 1e9) - mono + unix - base_ns) / 1e3


def _offcpu(s):
    return s.wall_s - s.cpu_s


def _children(tree, i):
    return [s for s in tree.spans if s.parent == i]


def _inside(child, parent):
    return parent.t0 <= child.t0 <= child.t1 <= parent.t1


def test_traced_flush_has_every_stage_nested(service, traced):
    flushes = _flushes(traced["rec"])
    assert len(flushes) == N // MAX_BATCH
    for tree in flushes:
        assert tree.root.name == "flush" and tree.root.parent == -1
        top = _children(tree, 0)
        assert [s.name for s in top] == STAGE_ORDER
        for a, b in zip(top, top[1:]):
            assert _inside(a, tree.root) and a.t1 <= b.t0
        assert _inside(top[-1], tree.root)
        by = {s.name: tree.spans.index(s) for s in top}
        for stage, lock in (("flush.marshal", "flush.marshal.lock"),
                            ("flush.side", "flush.side.lock")):
            kids = _children(tree, by[stage])
            assert [s.name for s in kids] == [lock]
            assert _inside(kids[0], tree.spans[by[stage]])
        buckets = _children(tree, by["flush.dispatch"])
        assert [s.name for s in buckets] == \
            ["flush.bucket"] * service.n_buckets
        for a, b in zip(buckets, buckets[1:]):
            assert a.t1 <= b.t0
        assert all(_inside(s, tree.spans[by["flush.dispatch"]])
                   for s in buckets)
        assert all(s.cpu_s >= 0.0 and s.t1 >= s.t0 for s in tree.spans)


def test_stages_cover_service_time(traced):
    recs = traced["rec"].spans()
    assert len(recs) == N
    for r in recs:
        covered = sum(s.wall_s for s in _children(r.flush, 0))
        assert covered >= 0.95 * r.service_s, (covered, r.service_s)


def test_query_spans_carry_rid_and_flush_id(traced):
    rec = traced["rec"]
    by_id = {t.ident: t for t in _flushes(rec)}
    assert sorted(by_id) == list(range(1, N // MAX_BATCH + 1))
    recs = sorted(rec.spans(), key=lambda r: r.rid)
    assert [r.rid for r in recs] == list(range(1, N + 1))
    assert [r.patient for r in recs] == list(range(N))    # submit order
    for r in recs:
        assert r.flush is by_id[r.flush_id]
        assert r.batch_n == MAX_BATCH
    # the co-batches in submit order: rids 1-4, then 5-8
    assert [r.flush_id for r in recs] == [1] * MAX_BATCH + [2] * MAX_BATCH
    assert "rid" not in recs[0].to_json()
    assert "flush_id" not in recs[0].to_json()


def test_profiler_holds_the_spans_on_the_anchor_clock(service, profiled):
    evs, base, rec = profiled["events"], profiled["base"], profiled["rec"]
    flushes = _flushes(rec)
    names = [e["name"] for e in evs]
    assert names.count("holmes.flush.bucket") == \
        service.n_buckets * len(flushes)
    ranges = sorted(float(e["ts"]) for e in evs if e["name"] == "holmes.flush")
    assert len(ranges) == len(flushes)
    for tree, ts in zip(sorted(flushes, key=lambda t: t.root.t0), ranges):
        assert abs(_trace_us(profiled["anchor"], tree.root.t0, base)
                   - ts) < 1000.0


def test_no_profiler_range_while_none_records(service):
    """A traced flush with no profiler recording opens no
    ``record_function`` (each one is a torch op that releases the GIL)."""
    from unittest import mock
    rec = spans.SpanRecorder()
    with mock.patch.object(spans, "record_function",
                           side_effect=AssertionError("opened")):
        _serve(service, rec, _refs(_ingest(MAX_BATCH)))
    assert len(_flushes(rec)) == 1
    assert [s.name for s in _flushes(rec)[0].spans][:2] == \
        ["flush", "flush.marshal"]


def test_no_tracer_records_and_opens_nothing(service):
    di = _ingest(N)
    names = []

    def run():
        with torch.profiler.record_function("holmes.probe"):
            names.append("probe")       # the profiler sees this thread
        _serve(service, None, _refs(di))
    evs, _ = _profiled(run)
    assert [e["name"] for e in evs] == ["holmes.probe"]
    assert getattr(spans._tls, "sink", None) is None
    assert spans.span("flush.dispatch") is spans._OFF


class _Announcing:
    """A lock that says when a caller has begun to acquire it."""

    def __init__(self, lock):
        self.lock = lock
        self.entered = threading.Event()

    def acquire(self):
        self.entered.set()
        return self.lock.acquire()

    def release(self):
        self.lock.release()


def _blocked(di, call):
    """``call()`` while another thread holds ``di.lock`` until 50 ms
    after ``call`` began to acquire it."""
    lock = di.lock
    di.lock = _Announcing(lock)
    held = threading.Event()

    def hold():
        with lock:
            held.set()
            assert di.lock.entered.wait(10.0)
            time.sleep(0.05)
    t = threading.Thread(target=hold)
    t.start()
    held.wait()
    call()
    t.join(10.0)
    assert not t.is_alive()
    di.lock = lock


@pytest.mark.parametrize("where", ["ingest", "flush"])
def test_blocked_on_a_lock_reads_off_cpu(service, where):
    rec = spans.SpanRecorder()
    di = _ingest(2, tracer=rec if where == "ingest" else None)
    refs = _refs(di)
    chunk = np.zeros((3, 25), np.float32)
    if where == "ingest":
        n0 = len(rec.ingests())
        _blocked(di, lambda: di.ingest(1.0, 0, "ecg", chunk))
        tree = rec.ingests()[n0]
        lock = tree.named("ingest.lock")
    else:
        out = {}

        def flush():
            with spans.collect("flush", 1) as out["tree"]:
                service.predict_batch(refs)
        _blocked(di, flush)
        tree = out["tree"]
        lock = tree.named("flush.marshal.lock")
    assert len(lock) == 1
    assert _offcpu(lock[0]) >= 0.04
    assert _offcpu(tree.root) >= 0.04
    assert lock[0].cpu_s < 0.02


@pytest.mark.parametrize("kind", spans.KINDS)
def test_recorder_counts_what_falls_out(kind):
    rec = spans.SpanRecorder(keep=3)
    put, get = {"query": (rec.record, rec.spans),
                "ingest": (rec.record_ingest, rec.ingests)}[kind]
    items = []
    for i in range(5):
        item = spans.SpanRecord(
            patient=i, tier=None, status="ok", t_submit=0.0,
            t_dequeue=0.0, t_flush=0.0, t_retire=1.0, batch_n=1,
            marshal_s=0.0, dispatch_s=0.0, gather_s=0.0, rid=i + 1) \
            if kind == "query" else spans.SpanTree(kind, i + 1)
        items.append(item)
        put(item)
    assert get() == items[2:]
    assert rec.dropped == {k: (2 if k == kind else 0) for k in spans.KINDS}


def test_span_record_stages_are_the_span_durations(traced):
    for r in traced["rec"].spans():
        for stage in spans.SERVICE_STAGES:
            got = getattr(r, f"{stage}_s")
            assert got > 0.0
            assert got == sum(s.wall_s for s in
                              r.flush.named(f"flush.{stage}"))


@pytest.mark.cuda
def test_card_trace_clock_matches_anchor(service):
    """On the card, under a CPU + CUDA profiler, each flush's
    ``holmes.flush`` range starts within 1 ms of its record mapped
    through the anchor."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda:0")
    svc = tp.EnsembleService(
        [tp.ZooMember(m.spec, m.params) for m in service.members],
        vitals_model=service.vitals_model, labs_model=service.labs_model,
        impl="torch", device=dev)
    svc.warmup(batch_sizes=(MAX_BATCH,))
    di = ta.DeviceIngest([ta.ModalitySpec("ecg", 250.0, 3),
                          ta.ModalitySpec("vitals", 1.0, 7)], N, WINDOW_S,
                         device=dev)
    rec = spans.SpanRecorder()
    refs = _refs(di)
    anchor = _anchor()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 **_all_threads()) as prof:
        _serve(svc, rec, refs)
    evs, base = _events(prof)
    ranges = sorted(float(e["ts"]) for e in evs if e["name"] == "holmes.flush")
    flushes = sorted(_flushes(rec), key=lambda t: t.root.t0)
    assert len(ranges) == len(flushes) == N // MAX_BATCH
    for tree, ts in zip(flushes, ranges):
        assert abs(_trace_us(anchor, tree.root.t0, base) - ts) < 1000.0


@pytest.mark.cuda
def test_card_graph_flush_has_one_replay_under_dispatch(service):
    """On the card, with the CUDA kernels, a flush at a captured rung
    replays its graph: its tree has the stages of a CPU flush, with one
    ``flush.replay`` under ``flush.dispatch`` in place of the bucket
    spans, and the profiler holds one ``holmes.flush.replay`` range a
    flush."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda:0")
    svc = tp.EnsembleService(
        [tp.ZooMember(m.spec, m.params) for m in service.members],
        vitals_model=service.vitals_model, labs_model=service.labs_model,
        device=dev)
    svc.warmup(batch_sizes=(MAX_BATCH,))
    di = ta.DeviceIngest([ta.ModalitySpec("ecg", 250.0, 3),
                          ta.ModalitySpec("vitals", 1.0, 7)], N, WINDOW_S,
                         device=dev)
    rec = spans.SpanRecorder()
    refs = _refs(di)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 **_all_threads()) as prof:
        _serve(svc, rec, refs)
    evs, _ = _events(prof)
    flushes = _flushes(rec)
    assert len(flushes) == N // MAX_BATCH == svc.graph_flushes
    assert svc.eager_flushes == 0
    assert [e["name"] for e in evs if e.get("cat") == "user_annotation"
            ].count("holmes.flush.replay") == len(flushes)
    for tree in flushes:
        top = _children(tree, 0)
        assert [s.name for s in top] == STAGE_ORDER
        by = {s.name: tree.spans.index(s) for s in top}
        kids = _children(tree, by["flush.dispatch"])
        assert [s.name for s in kids] == ["flush.replay"]
        assert _inside(kids[0], tree.spans[by["flush.dispatch"]])
        assert not tree.named("flush.bucket")


def test_concurrent_records_and_ids_stay_whole():
    """Eight threads submit and record at once, the interpreter switching
    threads every few microseconds: every request id and flush id is
    given once, each query names the tree of its own flush, and each
    kind's retained plus dropped records add up to those recorded."""
    import sys
    per, threads = 200, 8
    rec = spans.SpanRecorder(keep=500)
    srv = tserver.EnsembleServer(batch_handler=lambda b: [0.5] * len(b),
                                 n_workers=4, max_queue=per * threads,
                                 tracer=rec)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        srv.start()

        def work(k):
            for i in range(per):
                assert srv.submit(k * per + i, {})
                rec.record_ingest(spans.SpanTree("ingest"))
        ts = [threading.Thread(target=work, args=(k,))
              for k in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30.0)
        assert not any(t.is_alive() for t in ts)
        stats = srv.stop(join_timeout=5.0)
    finally:
        sys.setswitchinterval(old)
    n = per * threads
    assert stats.served == n and not srv.leaked
    assert len(rec.spans()) + rec.dropped["query"] == n
    assert len(rec.ingests()) + rec.dropped["ingest"] == n
    got = {r.rid for r in rec.spans()}
    assert len(got) == len(rec.spans()) and got <= set(range(1, n + 1))
    assert all(r.flush.ident == r.flush_id for r in rec.spans())
    ids = [t.ident for t in _flushes(rec)]
    assert len(set(ids)) == len(ids)
    assert max(ids) <= srv.batcher.stats.n_flushes
