"""The port's slot engine (``repro_torch/serving/slots.py``) against the
JAX package's, and against its own flush, on the CPU.

* one census driven through both engines (the same windows, from one
  numpy seed, into ``repro.serving.aggregator.DeviceIngest`` and the
  port's): every tick's report (``n_scored``, ``n_stale``, ``scored``,
  ``stamped``, ``versions``, ``spad``) and the engines' counters are
  IDENTICAL, the reads agree within ``repro_torch.testing``'s 1e-4 —
  over full and partial occupancy, sensor dropout and short windows,
  ring wraparound, CPU-side vitals and labs models, discharge and
  readmit, the stale-ring skip with the tick-age guard, and growth
  through ``ensure_slots`` and ``acquire_slot``;
* inside the port, at every one of those ticks: each stamped score is
  BITWISE the flush (``predict_batch``) of the same refs padded to the
  tick's rung; across rungs within 1e-4;
* reads launch nothing, a tick makes ``n_buckets`` passes, version-gated
  waits, admit idempotence, NaN before scoring, the refusals;
* ``StreamingPipeline(engine="slots")`` and ``EnsembleServer(engine=
  "slots")``;
* a seeded, single-threaded churn hammer: ``update``, ``admit``,
  ``discharge``, ``acquire_slot`` (growth past the first slots) and
  ``tick`` interleaved, closes landing mid-tick, every stamped
  ``(slot, version, spad)`` rescored bitwise offline.
"""
import threading

import numpy as np
import pytest
import torch

import jax

from repro.configs.ecg_zoo import zoo_specs
from repro.models.ecg_resnext import init_ecg
from repro.serving import aggregator as ja
from repro.serving import pipeline as jp
from repro.serving import server as jserver
from repro.serving import slots as js
from repro_torch.kernels import ops
from repro_torch.models import tabular as ttab
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import aggregator as ta
from repro_torch.serving import pipeline as tp
from repro_torch.serving import server as tserver
from repro_torch.serving import slots as ts
from repro_torch.testing import assert_bitwise, assert_close

torch.set_num_threads(1)
L = 250
COUNTERS = ("tick_count", "dispatch_count", "n_admits", "n_discharges",
            "n_stale_total", "n_grows")


@pytest.fixture(scope="module")
def zoo():
    """6 members in 2 buckets (widths 8/16, 2 blocks, 1-s windows):
    JAX members and the same weights carried into the port."""
    specs = zoo_specs(reduced=True, input_len=L, blocks=(2,))
    jm = [jp.ZooMember(s, init_ecg(jax.random.PRNGKey(i), s))
          for i, s in enumerate(specs)]
    tm = [tp.ZooMember(m.spec, params_from_numpy(
        jax.tree.map(np.asarray, m.params))) for m in jm]
    return jm, tm


@pytest.fixture(scope="module")
def side_models():
    rng = np.random.default_rng(0)
    y = rng.integers(0, 2, 40)
    vit = ttab.VitalsForest(7, n_trees=4).fit(
        rng.standard_normal((40, 7, 1)), y)
    labs = ttab.LogisticRegression(steps=50).fit(
        rng.standard_normal((40, 8)), y)
    return vit, labs


def _mods(pkg, vitals):
    mods = [pkg.ModalitySpec("ecg", 250.0, 3)]
    if vitals:
        mods.append(pkg.ModalitySpec("vitals", 1.0, 7))
    return mods


def _port_ingest(n, vitals=False, device="cpu"):
    return ta.DeviceIngest(_mods(ta, vitals), n, 1.0, device=device)


def _close(di, rng, patients, t0, n_samples=L, extra=None):
    """One ECG window per patient in mixed chunk sizes, closed;
    returns {patient: ref}."""
    refs = {}
    for p in patients:
        ecg = rng.standard_normal((3, n_samples)).astype(np.float32)
        off = 0
        for k in (100, 75, 75, 250):
            if off >= n_samples:
                break
            di.ingest(t0 + off / 250.0, p, "ecg", ecg[:, off:off + k])
            off += k
        refs[p] = di.close_window(p, t0 + 1.0, extra=dict(extra or {}))
    return refs


def _filler(di):
    """A ref that gathers an all-zero row: padding for an oracle flush
    (valid 0, end at the patient's current count, so never stale)."""
    return ta.DeviceWindowRef(
        ingest=di, patient=0, ends={m: int(di.fed[m][0]) for m in di.fed},
        valid={m: 0 for m in di.fed}, extra={})


def flush_at(svc, refs, spad):
    """``predict_batch`` over ``refs`` padded to the pow2 rung ``spad``
    (the tick's oracle: the same bucket passes at the same batch)."""
    refs = list(refs)
    n = len(refs)
    pad = [_filler(refs[0].ingest)] * (spad // 2 + 1 - n) \
        if spad > 1 and ta.pow2_rung(n) < spad else []
    out = svc.predict_batch(refs + pad)[:n]
    assert ta.pow2_rung(n + len(pad)) == spad
    return np.asarray(out)


def _reads(eng, slots):
    return np.asarray([eng.read(s) for s in slots])


class Twin:
    """One census driven through the JAX slot engine and the port's:
    the same chunks into both ingests, the same calls on both engines,
    and after each tick the reports, counters and reads compared and
    the port's stamps held bitwise to its own flush."""

    def __init__(self, zoo, n, vitals=False, side=None):
        jm, tm = zoo
        kw = dict(zip(("vitals_model", "labs_model"), side or ()))
        self.jsvc = jp.EnsembleService(jm, **kw)
        self.tsvc = tp.EnsembleService(tm, device="cpu", **kw)
        self.jdi = ja.DeviceIngest(_mods(ja, vitals), n_patients=n,
                                   window_seconds=1.0)
        self.tdi = _port_ingest(n, vitals)
        self.jeng = js.SlotEngine(self.jsvc, self.jdi)
        self.teng = ts.SlotEngine(self.tsvc, self.tdi)
        self.refs = {}                  # slot -> the port's last ref
        self.n_ticks = 0

    def ingest(self, t, p, m, x):
        self.jdi.ingest(t, p, m, x)
        self.tdi.ingest(t, p, m, x)

    def close(self, rng, patients, t0, n_samples=L, extra=None):
        """The same windows closed in both ingests and recorded by both
        engines (the same close versions)."""
        seed = int(rng.integers(1 << 31))
        jr = _close(self.jdi, np.random.default_rng(seed), patients, t0,
                    n_samples, extra)
        tr = _close(self.tdi, np.random.default_rng(seed), patients, t0,
                    n_samples, extra)
        for p in patients:
            assert self.jeng.update(jr[p]) == self.teng.update(tr[p])
            self.refs[p] = tr[p]

    def both(self, name, *args):
        """Call ``name`` on both engines: the same result (a score
        within the tolerance, NaN where NaN), or the same exception
        type."""
        out = []
        for eng in (self.jeng, self.teng):
            try:
                out.append(getattr(eng, name)(*args))
            except Exception as e:          # compared below
                out.append(type(e))
        if isinstance(out[0], float):
            assert np.isnan(out[0]) == np.isnan(out[1]), (name, args, out)
            assert_close(out[1], out[0], name)
        else:
            assert out[0] == out[1], (name, args, out)
        return out[1]

    def tick(self):
        rj, rt = self.jeng.tick(), self.teng.tick()
        self.n_ticks += 1
        for f in ("tick", "n_scored", "n_stale", "spad", "skipped"):
            assert getattr(rj, f) == getattr(rt, f), f
        for f in ("scored", "stamped", "versions"):
            assert_bitwise(np.asarray(getattr(rt, f), np.int64),
                           np.asarray(getattr(rj, f), np.int64), f)
        assert_close(rt.scores, rj.scores, "tick scores")
        self.counters()
        occ = [int(s) for s in np.flatnonzero(self.teng.occupied)]
        assert_close(self.teng.scores(), self.jeng.scores(), "reads")
        for s in occ:
            assert np.isnan(self.teng.read(s)) == \
                np.isnan(self.jeng.read(s))
        if len(rt.stamped):
            want = flush_at(self.tsvc,
                            [self.refs[int(s)] for s in rt.stamped],
                            rt.spad)
            assert_bitwise(rt.scores, want, f"tick {rt.tick} vs flush")
            assert_bitwise(_reads(self.teng, rt.stamped), want, "reads")
        return rt

    def counters(self):
        for c in COUNTERS:
            assert getattr(self.teng, c) == getattr(self.jeng, c), c


# --------------------------------------------------- the census scenarios
def sc_full(tw, rng):
    for rnd in range(2):             # the second round overwrites heads
        tw.close(rng, range(8), t0=float(rnd))
        rep = tw.tick()
        assert rep.n_scored == 8 and rep.n_stale == 0


def sc_partial(tw, rng):
    occ = [0, 2, 3, 5, 7]            # pow2_rung(5) == Spad == 8
    tw.close(rng, occ, t0=0.0)
    assert tw.tick().n_scored == 5
    for p in (1, 4, 6):
        assert tw.both("read", p) is KeyError
    s = tw.teng.scores()
    assert np.isnan(s[[1, 4, 6]]).all() and np.isfinite(s[occ]).all()


def sc_dropout_wrap(tw, rng):
    for w in range(4):               # 4 windows > a 2-window ring
        tw.close(rng, [0, 1], t0=float(w),
                 n_samples=120 if w == 3 else L)
    assert int(tw.tdi.fed["ecg"][0]) == 3 * L + 120 \
        > tw.tdi.states["ecg"].buf.shape[-1]
    assert tw.refs[0].valid["ecg"] == 120
    tw.tick()


def sc_cpu_models(tw, rng):
    labs = rng.standard_normal(8).astype(np.float32)
    for p in (0, 1):
        tw.ingest(0.0, p, "vitals",
                  rng.standard_normal((7, 1)).astype(np.float32))
    tw.close(rng, [0, 1], t0=0.0, extra={"labs": labs})
    tw.tick()


def sc_churn(tw, rng):
    tw.close(rng, range(8), t0=0.0)
    tw.tick()
    tw.both("discharge", 3)
    assert tw.both("read", 3) is KeyError
    assert tw.both("discharge", 3) is KeyError      # double free
    tw.tick()                        # survivors rescore
    tw.close(rng, [3], t0=2.0)       # a new patient takes bed 3
    assert tw.teng.n_admits == 9
    assert np.isnan(tw.both("read", 3))
    tw.tick()


def sc_stale(tw, rng):
    tw.close(rng, [0, 1], t0=0.0)
    tw.tick()
    good = tw.teng.read(0)
    for w in range(1, 4):            # slot 0's window scrolls out
        for off in range(0, L, 50):
            tw.ingest(w + off / 250.0, 0, "ecg",
                      rng.standard_normal((3, 50)).astype(np.float32))
    rep = tw.tick()
    assert rep.n_stale == 1 and rep.n_scored == 1
    assert tw.teng.read(0) == good
    assert np.isnan(tw.both("read", 0, 0))          # tick-age guard
    assert np.isfinite(tw.both("read", 1, 0))
    tw.close(rng, [0], t0=4.0)
    tw.tick()
    assert np.isfinite(tw.both("read", 0, 0))


def sc_growth(tw, rng):
    tw.close(rng, range(4), t0=0.0)
    tw.tick()
    before = _reads(tw.teng, range(4))
    assert tw.both("acquire_slot") == 4              # 4 -> 8 slots
    tw.close(rng, [4], t0=1.0)
    rep = tw.tick()
    assert rep.spad == 8 and tw.teng.n_grows == 1
    # the first four windows again, now at rung 8: within 1e-4 of rung 4
    assert_close(_reads(tw.teng, range(4)), before, "rung 8 vs rung 4")
    assert tw.both("ensure_slots", 9) == 16
    tw.both("admit", 20)                             # 16 -> 32 slots
    tw.close(rng, [0, 9, 20], t0=2.0)
    assert tw.tick().spad == 32
    assert tw.teng.n_grows == 3


SCENARIOS = {
    "full": (8, False, sc_full),
    "partial": (8, False, sc_partial),
    "dropout_wrap": (2, False, sc_dropout_wrap),
    "cpu_models": (2, True, sc_cpu_models),
    "churn": (8, False, sc_churn),
    "stale": (2, False, sc_stale),
    "growth": (4, False, sc_growth),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_slot_engine_matches_jax_and_its_own_flush(zoo, side_models, name):
    n, vitals, run = SCENARIOS[name]
    tw = Twin(zoo, n, vitals, side_models if vitals else None)
    run(tw, np.random.default_rng(sorted(SCENARIOS).index(name)))
    assert tw.n_ticks
    tw.counters()


# ------------------------------------------------------- inside the port
def _svc(zoo, **kw):
    return tp.EnsembleService(zoo[1], device="cpu", **kw)


def test_reads_launch_nothing_and_a_tick_makes_n_buckets_passes(
        zoo, monkeypatch):
    calls = []
    for name in ("conv1d", "window_gather"):
        fn = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    svc = _svc(zoo)
    di = _port_ingest(4)
    eng = ts.SlotEngine(svc, di)
    rng = np.random.default_rng(1)
    for rnd in range(2):
        for r in _close(di, rng, range(4), float(rnd)).values():
            eng.update(r)
        del calls[:]
        d0 = svc.dispatch_count
        eng.tick()
        assert eng.dispatch_count == (rnd + 1) * svc.n_buckets
        assert svc.dispatch_count == d0      # the service's own counter
        assert calls.count("window_gather") == 1
        n_convs = calls.count("conv1d")
        del calls[:]
        got = _reads(eng, range(4))
        eng.scores()
        assert calls == [] and eng.dispatch_count == \
            (rnd + 1) * svc.n_buckets
        assert np.isfinite(got).all()
    assert n_convs == sum(1 + 3 * b.spec.blocks for b in svc._buckets)
    assert eng.device_scores.shape == (4,)


def test_wait_scored_is_version_gated(zoo):
    di = _port_ingest(2)
    eng = ts.SlotEngine(_svc(zoo), di)
    refs = _close(di, np.random.default_rng(2), [0, 1], 0.0)
    v = eng.update(refs[0])
    eng.update(refs[1])
    assert not eng.wait_scored(0, v, timeout=0.0)     # no tick yet
    eng.tick()
    assert eng.wait_scored(0, v, timeout=0.0)
    assert not eng.wait_scored(0, v + 1, timeout=0.0)  # a future close
    eng.discharge(0)
    assert not eng.wait_scored(0, v, timeout=0.0)     # gone: False


def test_admit_is_idempotent_and_reads_before_scoring_are_nan(zoo):
    eng = ts.SlotEngine(_svc(zoo), _port_ingest(2))
    eng.admit(0)
    eng.admit(0)
    assert eng.n_admits == 1
    assert np.isnan(eng.read(0))
    rep = eng.tick()                 # no window yet: a no-op tick
    assert rep.n_scored == 0 and eng.dispatch_count == 0
    assert eng.tick_count == 1


@pytest.mark.parametrize("case", ["unfused", "legacy", "no_ecg_ring",
                                  "other_ingest", "no_members"])
def test_wrong_service_or_ingest_refused_like_the_reference(zoo, case):
    jm, tm = zoo
    errors = []
    for pkg, mem, kw, mk in (
            (jp, jm, {}, lambda ms, n: ja.DeviceIngest(ms, n, 1.0)),
            (tp, tm, {"device": "cpu"},
             lambda ms, n: ta.DeviceIngest(ms, n, 1.0, device="cpu"))):
        agg = ja if pkg is jp else ta
        eng_pkg = js if pkg is jp else ts
        ecg = [agg.ModalitySpec("ecg", 250.0, 3)]
        svc_kw = {"unfused": {"fused": False},
                  "legacy": {"marshal": "legacy"}}.get(case, {})
        members = [] if case == "no_members" else mem
        di = mk([agg.ModalitySpec("vitals", 1.0, 7)] if case ==
                "no_ecg_ring" else ecg, 2)
        try:
            eng = eng_pkg.SlotEngine(
                pkg.EnsembleService(members, **svc_kw, **kw), di)
            if case == "other_ingest":
                other = mk(ecg, 2)
                eng.update(_close(other, np.random.default_rng(3), [0],
                                  0.0)[0])
        except Exception as e:
            errors.append((type(e), str(e).split(" (")[0]))
        else:
            errors.append(None)
    assert errors[0] is not None and errors[1] is not None
    assert errors[0][0] is errors[1][0] is ValueError
    assert errors[0][1] == errors[1][1]


def test_engine_refuses_ingest_on_another_device(zoo):
    svc = _svc(zoo)
    with pytest.raises(ValueError, match="device"):
        ts.SlotEngine(svc, _port_ingest(2, device="meta"))
    eng = ts.SlotEngine(svc, _port_ingest(2))
    with pytest.raises(ValueError, match="member composition"):
        eng.rebind(tp.EnsembleService(zoo[1][:3], device="cpu"))
    eng.rebind(eng.service)                          # idempotent
    assert eng.n_rebinds == 0


def test_masked_update_and_fleet_mean_match_the_reference():
    rng = np.random.default_rng(4)
    prev = rng.standard_normal((5, 8)).astype(np.float32)
    cands = [rng.standard_normal((2, 8)).astype(np.float32),
             rng.standard_normal((3, 8)).astype(np.float32)]
    occ = rng.random(8) < 0.5
    jnew, jmean = js._masked_update(jax.numpy.asarray(prev),
                                    tuple(map(jax.numpy.asarray, cands)),
                                    jax.numpy.asarray(occ))
    state = torch.from_numpy(prev.copy())
    ptr = state.data_ptr()
    tmean = ts._masked_update(state, [torch.from_numpy(c) for c in cands],
                              torch.from_numpy(occ))
    assert state.data_ptr() == ptr                   # folded in place
    assert_bitwise(state, np.asarray(jnew), "fold")  # selection only
    assert_close(tmean, np.asarray(jmean), "member mean")
    mats = [rng.standard_normal((k, 8)).astype(np.float32) for k in (2, 3)]
    assert_close(ts._fleet_mean([torch.from_numpy(m) for m in mats],
                                torch.device("cpu")),
                 np.asarray(js._fleet_mean(tuple(map(jax.numpy.asarray,
                                                     mats)))), "fleet")


# ------------------------------------------------------------ the wiring
def _feed_pipes(pipes, n_patients, steps, seed):
    rng = np.random.default_rng(seed)
    for j in range(steps):           # 1-s windows fed in 0.5-s chunks
        t = j * 0.5
        for p in range(n_patients):
            c = rng.standard_normal((3, 125)).astype(np.float32)
            for pipe in pipes:
                pipe.feed(t, p, "ecg", c)


def test_pipeline_slots_engine(zoo):
    """The slot pipeline serves every window the flush pipeline serves:
    the same (patient, t_window) records as the port's flush pipeline
    (bitwise: two beds tick at rung 2, and the flush pipeline's P = 1
    passes give the same bits on the CPU) and as the JAX slot pipeline
    (within 1e-4)."""
    jm, tm = zoo
    tsvc = tp.EnsembleService(tm, device="cpu")
    flush = tp.StreamingPipeline(tsvc, 2, window_seconds=1.0,
                                 device_ingest=True, device="cpu")
    slots = tp.StreamingPipeline(tsvc, 2, window_seconds=1.0,
                                 device_ingest=True, engine="slots",
                                 device="cpu")
    jslots = jp.StreamingPipeline(jp.EnsembleService(jm), 2,
                                  window_seconds=1.0, device_ingest=True,
                                  engine="slots")
    _feed_pipes([flush, slots, jslots], 2, 7, seed=7)
    slots.tick_now(3.5)
    jslots.tick_now(3.5)
    assert len(flush.records) == len(slots.records) == 6
    key = lambda r: (r.patient, r.t_window)          # noqa: E731
    assert [key(r) for r in slots.records] == \
        [key(r) for r in jslots.records]
    want = {key(r): r.score for r in flush.records}
    got = [r.score for r in slots.records]
    assert_bitwise(np.asarray(got),
                   np.asarray([want[key(r)] for r in slots.records]),
                   "slot pipeline vs flush pipeline")
    assert_close(got, [r.score for r in jslots.records], "vs JAX")
    with pytest.raises(ValueError):
        flush.tick_now(0.0)


@pytest.mark.parametrize("kw", [
    {"engine": "slots"},
    {"engine": "slots", "tier_of": lambda p: "stable",
     "device_ingest": True},
    {"engine": "nope"}], ids=["no_device_ingest", "tiered", "unknown"])
def test_pipeline_slots_ctor_errors_match_the_reference(zoo, kw):
    jm, tm = zoo
    msgs = []
    for pkg, m, extra in ((jp, jm, {}), (tp, tm, {"device": "cpu"})):
        with pytest.raises(ValueError) as ei:
            pkg.StreamingPipeline(pkg.EnsembleService(
                m, **extra), 2, **kw, **extra)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_server_slots_engine_end_to_end(zoo):
    """Conservation (served == submitted, none failed), the scores the
    engine's reads (bitwise the flush at the slot rung), no thread left
    behind, and every bucket pass from ticks."""
    svc = _svc(zoo)
    di = _port_ingest(8)
    eng = ts.SlotEngine(svc, di)
    refs = _close(di, np.random.default_rng(5), range(8), 0.0)
    srv = tserver.EnsembleServer(engine="slots", slot_engine=eng,
                                 tick_interval=0.01, n_workers=2,
                                 slot_wait_timeout=30.0).start()
    for p in range(8):
        assert srv.submit(p, refs[p])
    stats = srv.stop()
    assert stats.served == 8 and stats.failed == 0
    assert srv.leaked == []
    assert eng.dispatch_count % svc.n_buckets == 0
    assert svc.dispatch_count == 0           # no query flushed
    got = {p: s for p, s, *_ in srv.results()}
    assert_bitwise(np.asarray([got[p] for p in range(8)]),
                   flush_at(svc, [refs[p] for p in range(8)], 8), "served")
    left = [t.name for t in threading.enumerate()
            if t.is_alive() and t.name.startswith("repro-")]
    assert left == []


def test_server_slots_stale_read_retires_nan(zoo):
    """A query whose covering tick never lands retires NaN within
    ``slot_wait_timeout`` instead of hanging ``drain()``."""
    di = _port_ingest(2)
    eng = ts.SlotEngine(_svc(zoo), di)
    refs = _close(di, np.random.default_rng(6), [0], 0.0)
    srv = tserver.EnsembleServer(engine="slots", slot_engine=eng,
                                 tick_interval=3600.0,
                                 slot_wait_timeout=0.05,
                                 n_workers=1).start()
    assert srv.submit(0, refs[0])
    stats = srv.stop()
    assert stats.served == 1 and stats.failed == 1
    assert srv.leaked == []


@pytest.mark.parametrize("case", [
    "no_engine", "handlers", "tiered", "engine_without_slots",
    "ticker_deadline_without_slots", "unknown"])
def test_server_slots_ctor_errors_match_the_reference(zoo, case):
    jm, tm = zoo
    jeng = js.SlotEngine(jp.EnsembleService(jm),
                         ja.DeviceIngest(_mods(ja, False), 2, 1.0))
    teng = ts.SlotEngine(_svc(zoo), _port_ingest(2))
    msgs = []
    for mod, eng in ((jserver, jeng), (tserver, teng)):
        kw = {"no_engine": {"engine": "slots"},
              "handlers": {"engine": "slots", "slot_engine": eng,
                           "batch_handler": lambda w: [0.0]},
              "tiered": {"engine": "slots", "slot_engine": eng,
                         "tier_of": lambda p: "stable"},
              "engine_without_slots": {"handler": lambda w: 0.0,
                                       "slot_engine": eng},
              "ticker_deadline_without_slots": {
                  "handler": lambda w: 0.0,
                  "ticker_deadline_seconds": 1.0},
              "unknown": {"handler": lambda w: 0.0,
                          "engine": "nope"}}[case]
        with pytest.raises(ValueError) as ei:
            mod.EnsembleServer(**kw)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


# ------------------------------------------------- the churn hammer
def test_churn_hammer_deterministic(zoo):
    """A seeded, single-threaded interleaving of ``update``, ``admit``,
    ``discharge``, ``acquire_slot`` (growth past the first four slots)
    and ``tick``, with closes landing mid-tick through the pre-stamp
    seam (those stamps must be skipped).  Every ``(slot, version,
    spad)`` the engine stamped is rescored bitwise offline by a flush
    of its window padded to that rung; re-stamps of a key agree."""
    svc = _svc(zoo)
    di = _port_ingest(4)
    eng = ts.SlotEngine(svc, di)
    rng = np.random.default_rng(11)
    t_row, ver, snaps, stamps = {}, {}, {}, {}
    midtick = []

    def close(s):
        t0 = t_row.get(s, 0.0)
        di.ingest(t0, s, "ecg",
                  rng.standard_normal((3, L)).astype(np.float32))
        ref = di.close_window(s, t0 + 1.0)
        t_row[s] = t0 + 1.0
        v = eng.update(ref)
        ver[s] = v
        snaps[(s, v)] = ref.host_window("ecg")
        return v

    def on_tick(r):
        for s, v, sc in zip(r.stamped, r.versions, r.scores):
            key = (int(s), int(v), int(r.spad))
            assert stamps.setdefault(key, float(sc)) == float(sc), key

    eng.on_tick = on_tick
    n_ops = {"close": 0, "admit": 0, "discharge": 0, "acquire": 0,
             "tick": 0, "midtick": 0}
    for step in range(160):
        op = rng.choice(["close", "close", "admit", "discharge",
                         "acquire", "tick", "tick", "midtick"])
        if op == "acquire" and eng.n_slots >= 16:
            op = "close"
        occ = [int(s) for s in np.flatnonzero(eng.occupied)]
        if op == "close" and occ:
            close(int(rng.choice(occ)))
        elif op == "admit":
            eng.admit(int(rng.integers(0, eng.n_slots)))
        elif op == "discharge" and occ:
            eng.discharge(int(rng.choice(occ)))
        elif op == "acquire":
            close(eng.acquire_slot())
        elif op in ("tick", "midtick"):
            victim = int(rng.choice(occ)) if occ else None
            if op == "midtick" and victim is not None \
                    and eng.has_window[victim]:
                def hook(s=victim):
                    eng._pre_stamp_hook = None
                    midtick.append((s, ver[s], close(s)))
                eng._pre_stamp_hook = hook
            rep = eng.tick()
            eng._pre_stamp_hook = None
            for s, v_old, v_new in midtick:
                assert s not in rep.stamped
                assert eng.scored_version[s] < v_new
            midtick.clear()
        n_ops[op] += 1
    assert eng.n_grows >= 1 and eng.n_slots > 4
    assert min(n_ops.values()) > 0, n_ops
    assert len({spad for _, _, spad in stamps}) >= 2, stamps.keys()

    zero = np.zeros((3, L), np.float32)
    by_spad = {}
    for (s, v, spad), sc in sorted(stamps.items()):
        by_spad.setdefault(spad, []).append((s, v, sc))
    for spad, ents in by_spad.items():
        for i in range(0, len(ents), spad):
            chunk = ents[i:i + spad]
            wins = [snaps[(s, v)] for s, v, _ in chunk]
            wins += [zero] * (spad - len(wins))
            want = svc.predict_batch([{"ecg": w} for w in wins])
            assert_bitwise(np.asarray([sc for *_, sc in chunk]),
                           np.asarray(want[:len(chunk)]), f"spad {spad}")
