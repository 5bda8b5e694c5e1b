"""The port's actuator (``control/swap.py``) and the fault plane with
the real swapper, over CPU lanes.

* the ladder, the facade and ``rungs_monotone`` against the JAX
  package's; ``_failover_placement`` and ``placement_for`` (through
  ``placement_fn``) identical to the JAX ``HotSwapper``'s;
* ``(selector, placement)`` staging, shared staging and its pins, hot
  swaps across placements through ``EnsembleServer`` (nothing dropped,
  bitwise after), ``re_place`` (a no-op, and from the live retire
  EWMAs), quarantine of a lane (speeds, refusals);
* ``FaultPlane.protect`` and ``protect_engine`` with a ``HotSwapper``:
  a permanent loss of lane 2 of 4 mid-flush and lane 1 mid-tick is
  quarantined and re-placed, nothing is dropped and the scores are
  bitwise the unsharded oracle's; a transient loss waits it out.

The reference proves these on forced host devices; here the lanes are
``repro_torch.device.lanes(n, "cpu")``.  The reference's
``test_retire_drift_feeds_replace`` (the controller's RE-PLACE through
``wire_controller``) has its counterpart in ``test_torch_control.py``.
"""
import time

import numpy as np
import pytest
import torch

import jax

from repro.control import swap as jswap
from repro.serving import placement as jpl
from repro_torch.configs.ecg_zoo import bucket_zoo
from repro_torch.control import faults as tf
from repro_torch.control import swap as tswap
from repro_torch.device import device_lanes, lanes
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import aggregator as ta
from repro_torch.serving import pipeline as tp
from repro_torch.serving.placement import (Placement,
                                           grouped_lpt_placement,
                                           placement_signature)
from repro_torch.serving.server import EnsembleServer
from repro_torch.serving.slots import SlotEngine, SlotTicker, TickLadder
from repro_torch.testing import assert_bitwise

torch.set_num_threads(1)
L = 250


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += float(dt)


@pytest.fixture(scope="module")
def tzoo(zoo_members):
    return [tp.ZooMember(m.spec, params_from_numpy(
        jax.tree.map(np.asarray, m.params))) for m in zoo_members]


def _sel(n, idx):
    b = np.zeros(n, np.int8)
    b[list(idx)] = 1
    return b


def _bucket_plan(pool, selector, n_lanes, seed=0):
    idx = np.flatnonzero(np.asarray(selector, bool))
    groups = list(bucket_zoo([pool[i].spec for i in idx]).values())
    costs = [float(len(g) + 1 + 0.1 * ((seed + j) % 3))
             for j, g in enumerate(groups)]
    return grouped_lpt_placement(groups, costs, n_lanes)


def _windows(seed, n):
    rng = np.random.default_rng(seed)
    return [{"ecg": rng.standard_normal((3, L)).astype(np.float32)}
            for _ in range(n)]


def _swapper(tzoo, sel, n_lanes, **kw):
    kw.setdefault("warmup_batch_sizes", (1,))
    return tswap.HotSwapper(tzoo, sel, devices=lanes(n_lanes, "cpu"),
                            **kw)


# ------------------------------------------------ against the reference
class _Rec:
    """A ladder whose activation records what went live."""

    def __init__(self, mod, initial):
        outer = self

        class Ladder(mod.SelectorLadder):
            def _activate(self, selector):
                outer.log.append(selector.tobytes())

        self.log = []
        self.ladder = Ladder(initial)


def test_ladder_and_facade_match_the_reference():
    n = 6
    rungs = [_sel(n, [0]), _sel(n, [0, 2]), _sel(n, range(n))]
    runs = []
    for mod in (jswap, tswap):
        rec = _Rec(mod, rungs[2])
        lad = rec.ladder
        lad.set_ladder(rungs)
        trace = [lad.ladder_pos, lad.can_shed(), lad.can_climb()]
        for op in ("shed", "shed", "shed", "climb", "climb", "climb"):
            trace.append((getattr(lad, op)(), lad.ladder_pos))
        lad.swap_to(_sel(n, [5]))
        trace.append(lad.ladder_pos)
        facade = mod.SwappableService("a")
        trace += [facade.swap("b"), facade.current, facade.swap_count]
        runs.append((trace, rec.log))
    assert runs[0] == runs[1]
    rng = np.random.default_rng(0)
    for _ in range(20):
        pos = {t: int(p) for t, p in zip("abc", rng.integers(-1, 3, 3))}
        lanes_ = {t: type("L", (), {"ladder_pos": p})()
                  for t, p in pos.items()}
        assert tswap.rungs_monotone(lanes_, "abc") \
            == jswap.rungs_monotone(lanes_, "abc")


@pytest.mark.parametrize("case", [
    ([[0, 1], [2], [3, 4]], [2.0, 5.0, 1.0], None),
    ([[0], [1], [2]], [1.0, 1.0, 1.2], [1.0, 1.0, 4.0]),
    ([[0], [1, 2], [3], [4, 5]], [1.0, 2.0, 1.0, 2.0], None),
    ([[0]], [1.0], None)])
def test_failover_placement_identical_to_jax(case):
    """Minimal-move interim plans (survivors keep their speeds, the
    orphans land on the least-finish-time survivor), and the shapes
    that fall back to a fresh plan, slot by slot."""
    assignment, loads, speeds = case
    told = Placement(assignment, loads, speeds)
    jold = jpl.Placement(assignment, loads, speeds)
    for dead in range(-1, len(assignment) + 1):
        got = tswap.HotSwapper._failover_placement(told, dead)
        want = jswap.HotSwapper._failover_placement(jold, dead)
        if want is None:
            assert got is None
            continue
        assert (got.assignment, got.loads, got.speeds) \
            == (want.assignment, want.loads, want.speeds)
        assert got.signature() == want.signature()
    assert tswap.HotSwapper._failover_placement(None, 0) is None


def test_placement_for_through_placement_fn_matches_jax(zoo_members,
                                                        tzoo):
    """Plans come from ``placement_fn`` once a selector and are cached
    (ladder oscillation reuses them); ``fresh=True`` asks again.  The
    JAX swapper runs one-slot plans (its CPU lane has one device)."""
    n = len(tzoo)
    calls = {"jax": [], "torch": []}

    def plan_fn(mod, key):
        def fn(sel):
            calls[key].append(sel.tobytes())
            idx = list(range(int(sel.sum())))
            return mod.Placement([idx], [float(len(idx))])
        return fn

    jsw = jswap.HotSwapper(zoo_members, _sel(n, [0]),
                           warmup_batch_sizes=(1,),
                           placement_fn=plan_fn(jpl, "jax"))
    tsw = _swapper(tzoo, _sel(n, [0]), 1,
                   placement_fn=plan_fn(tswap, "torch"))
    assert tsw.sharded and jsw.sharded
    for sel, fresh in ((_sel(n, [0]), False), (_sel(n, [0, 1]), False),
                       (_sel(n, [0]), False), (_sel(n, [0]), True)):
        a = jsw.placement_for(sel, fresh=fresh)
        b = tsw.placement_for(sel, fresh=fresh)
        assert b.signature() == a.signature()
        assert placement_signature(b) == jpl.placement_signature(a)
    assert calls["torch"] == calls["jax"] and len(calls["jax"]) == 3


# ---------------------------------------------------------- staging
def test_stage_caches_selector_placement_pairs(tzoo):
    n = len(tzoo)
    sel = _sel(n, range(0, n, 2))
    pl2 = _bucket_plan(tzoo, sel, 2)
    pl4 = _bucket_plan(tzoo, sel, 4)
    sw = _swapper(tzoo, sel, 4,
                  placement_fn=lambda s: _bucket_plan(tzoo, s, 2))
    assert sw.sharded and sw.device == torch.device("cpu")
    a1, a2, b1 = sw.stage(sel, pl2), sw.stage(sel, pl2), sw.stage(sel, pl4)
    assert a1 is a2 and a1 is not b1
    assert a1.placement.signature() == pl2.signature()
    assert b1.placement.signature() == pl4.signature()
    assert {b.device for b in b1._buckets} <= set(sw.devices)


def test_shared_staging_and_unregister_releases_pins(tzoo):
    """Two swappers on one ``StagingCache`` standing on the same
    (selector, placement) pair serve through ONE staged service; a
    swapper unregistered from the cache stops pinning its pair, so the
    next eviction pass drops it."""
    n = len(tzoo)
    cache = tswap.StagingCache()
    rich = _sel(n, range(n))
    a = tswap.HotSwapper(tzoo, rich, staging=cache,
                         warmup_batch_sizes=(1,), device="cpu")
    b = tswap.HotSwapper(tzoo, rich, staging=cache,
                         warmup_batch_sizes=(1,), device="cpu")
    assert a.facade.current is b.facade.current
    assert len(cache.staged) == 1 and len(cache.swappers) == 2
    dead = tswap.HotSwapper(tzoo, _sel(n, [3, 5]), staging=cache,
                            warmup_batch_sizes=(1,), device="cpu")
    assert len(cache.staged) == 2
    cache.unregister(dead)
    assert len(cache.swappers) == 2 and id(dead) not in cache.pins
    a.swap_to(_sel(n, [4]))              # an eviction pass
    a.swap_to(rich)
    keys = {k.split(b"|", 1)[0] for k in cache.staged}
    assert _sel(n, [3, 5]).tobytes() not in keys
    assert rich.tobytes() in keys and b.facade.current is a.facade.current


def test_hot_swap_zero_drop_across_placement_changes(tzoo):
    """Placement changes are hot swaps: re-placing mid-stream through
    ``EnsembleServer`` drops nothing, and the scores after the last swap
    are bitwise a cold service's on the new plan."""
    n = len(tzoo)
    sel = _sel(n, range(n))
    plans = [_bucket_plan(tzoo, sel, d, seed=d) for d in (2, 4, 8)]
    sw = _swapper(tzoo, sel, 8, placement_fn=lambda s: plans[0])
    for pl in plans:
        sw.stage(sel, pl)
    srv = EnsembleServer(batch_handler=sw.facade.predict_batch,
                         n_workers=2, max_batch=1,
                         max_wait_ms=0.5).start()
    windows = _windows(7, 24)
    for i in range(24):
        if i in (8, 16):
            deadline = time.monotonic() + 60.0  # the swap lands between
            while srv.stats.served < i:         # flushes of the stream
                assert time.monotonic() < deadline
                time.sleep(0.001)
            assert sw.re_place(plans[i // 8])
        assert srv.submit(i, windows[i])
    stats = srv.stop()
    assert stats.served == 24 and stats.failed == 0 and not srv.leaked
    assert sw.facade.swap_count == 2
    assert placement_signature(sw.active_placement) == plans[2].signature()
    scores = {p: s for p, s, *_ in srv.results()}
    cold = tp.EnsembleService(tzoo, placement=plans[2],
                              devices=lanes(8, "cpu"))
    flat = tp.EnsembleService(tzoo, device="cpu")
    for i in range(24):
        want = flat.predict(windows[i])
        assert scores[i] == want                  # every plan, bitwise
        if i >= 16:
            assert scores[i] == cold.predict(windows[i])


def test_re_place_noop_when_plan_unchanged(tzoo):
    n = len(tzoo)
    sel = _sel(n, [0])
    pl = _bucket_plan(tzoo, sel, 2)
    sw = _swapper(tzoo, sel, 2, placement_fn=lambda s: pl)
    svc = sw.facade.current
    assert sw.re_place() is False
    assert sw.facade.current is svc and sw.facade.swap_count == 0


def test_re_place_from_live_retire_drift(tzoo):
    """``re_place()`` with no plan re-derives it from the LIVE shard
    retire EWMAs: lane 0 slowed down holds two buckets, the drift plan
    splits them."""
    n = len(tzoo)
    sel = _sel(n, range(n))
    groups = list(bucket_zoo([m.spec for m in tzoo]).values())
    pl_init = grouped_lpt_placement(
        groups, [1.0, 1.0] + [0.5] * (len(groups) - 2), 2)
    sw = _swapper(tzoo, sel, 2, n_devices=2, placement_fn=lambda s: pl_init)
    sw.placement_fn = None                 # planning from drift from now
    slow = sw.devices[0]
    slow_keys = {tuple(sorted(b.idx)) for b in sw.facade.current._buckets
                 if b.device == slow}
    assert len(slow_keys) >= 2

    def guard(lane):
        if lane == slow:
            time.sleep(0.05)

    sw.service_hook = lambda svc: setattr(svc, "dispatch_guard", guard)
    sw.facade.current.dispatch_guard = guard
    for w in _windows(8, 6):
        sw.facade.predict(w)
    live = sw.facade.current.live_bucket_costs()
    fin = sw.facade.current.measured_finish_times()
    assert live is not None and fin[0] > fin[1] + 0.03
    want = sw.facade.current.plan_placement(2, bucket_costs=live)
    assert sw.re_place() is True
    assert sw.active_placement.signature() == want.signature()
    assert sw.active_placement.signature() != pl_init.signature()
    for slot in sw.active_placement.assignment:
        on_slot = {k for k in slow_keys if set(k) <= set(slot)}
        assert on_slot != slow_keys


def test_quarantine_drops_dead_lane_speed(tzoo):
    n = len(tzoo)
    sel = _sel(n, range(0, n, 2))
    sw = _swapper(tzoo, sel, 2, n_devices=2, speeds=[1.0, 3.0],
                  plan_batch=1, cost_reps=1)
    devs = list(sw.devices)
    assert sw.active_placement.speeds == [1.0, 3.0]
    assert sw.quarantine_device(devs[0])
    assert sw.speeds == [3.0] and sw.devices == devs[1:]
    assert sw.active_placement.speeds == [3.0]
    assert sw.active_placement.n_slots == 1
    assert {b.device for b in sw.facade.current._buckets} == {devs[1]}


def test_quarantine_refusals(tzoo):
    n = len(tzoo)
    sel = _sel(n, range(n))
    flat = tswap.HotSwapper(tzoo, sel, warmup_batch_sizes=(1,),
                            device="cpu")
    assert not flat.sharded and flat.quarantine_device(lanes(1, "cpu")[0]) \
        is False
    sw = _swapper(tzoo, sel, 2, placement_fn=lambda s: _bucket_plan(
        tzoo, s, 2))
    other = lanes(3, "cpu")[2]                   # not in this pool
    assert sw.quarantine_device(other) is False
    assert sw.quarantine_device(torch.device("cpu")) is False
    dead = sw.devices[1]
    gen = sw._devices_gen
    assert sw.quarantine_device(dead) is True
    assert sw._devices_gen == gen + 1 and sw.quarantined == [dead]
    assert sw.quarantine_device(dead) is False   # already gone
    assert sw.quarantine_device(sw.devices[0]) is False   # the last lane


def test_defaults_resolve_to_the_same_lanes(tzoo, monkeypatch):
    """``EnsembleService``, ``HotSwapper`` and ``FaultPlane.arm`` all
    default to ``device_lanes()``: one lane a card."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    want = device_lanes()
    svc = tp.EnsembleService(tzoo, device="cpu")
    sw = tswap.HotSwapper(tzoo, _sel(len(tzoo), [0]), device="cpu",
                          warmup_batch_sizes=(1,))
    plane = tf.FaultPlane([]).arm()
    assert svc.devices == sw._lanes() == plane.devices == want
    assert [d.device for d in want] == [torch.device("cuda", 0),
                                        torch.device("cuda", 1)]


def test_arm_defaults_to_the_swappers_lanes(tzoo):
    """``arm(sw)`` with no list takes the swapper's own lanes (a copy:
    quarantine shrinks the swapper's list, not the plane's indices),
    so a loss of lane 2 of four fires on lane 2 alone."""
    n = len(tzoo)
    sw = _swapper(tzoo, np.ones(n, np.int8), 4,
                  placement_fn=lambda s: _bucket_plan(tzoo, s, 4))
    clk = FakeClock()
    plane = tf.FaultPlane([tf.FaultEvent(0.1, "device_loss", target=2)],
                          clock=clk).arm(sw)
    assert plane.devices == sw.devices and plane.devices is not sw.devices
    clk.advance(0.2)
    for i, lane in enumerate(sw.devices):
        if i == 2:
            with pytest.raises(tf.DeviceLostError) as ei:
                plane.guard(lane)
            assert ei.value.index == 2 and ei.value.device == lane
        else:
            plane.guard(lane)
    with pytest.raises(tf.DeviceLostError):
        sw.facade.current.predict_batch(_windows(14, 2))


@pytest.mark.parametrize("case", ["bare", "short", "far"])
def test_arm_refuses_lanes_a_sharded_service_cannot_match(tzoo, case):
    """A sharded service is armed only against a lane list that holds
    its lanes and every scheduled loss: bare ``torch.device``s, a list
    missing some lanes, or a loss beyond the list would leave the drill
    silent."""
    n = len(tzoo)
    sw = _swapper(tzoo, np.ones(n, np.int8), 4,
                  placement_fn=lambda s: _bucket_plan(tzoo, s, 4))
    target = 5 if case == "far" else 2
    plane = tf.FaultPlane([tf.FaultEvent(0.1, "device_loss",
                                         target=target)])
    devices = {"bare": [torch.device("cpu")] * 4,
               "short": sw.devices[:1], "far": None}[case]
    with pytest.raises((TypeError, ValueError)):
        plane.arm(sw, devices=devices)


# ---------------------------------------- the fault plane, real swapper
def test_protect_permanent_lane_loss_mid_flush(tzoo):
    """Lane 2 of 4 lost for good: the first flush trips over it after
    lanes 0 and 1 dispatched; ``protect`` quarantines it in ONE
    failover thread, the flush retries on the three survivors, every
    query is served and every score is bitwise the unsharded
    oracle's."""
    n = len(tzoo)
    rich = np.ones(n, np.int8)
    sw = _swapper(tzoo, rich, 4, n_devices=4, plan_batch=1, cost_reps=1)
    devs = list(sw.devices)
    assert sw.active_placement.n_slots == 4
    plane = tf.FaultPlane([tf.FaultEvent(0.0, "device_loss", target=2)])
    plane.arm(sw, devices=devs)
    seen = []
    orig = plane.guard

    def spy(lane):
        seen.append(lane)
        orig(lane)

    plane.guard = spy
    plane._arm_service(sw.facade.current)
    handler = plane.protect(sw.facade.predict_batch, sw,
                            retry_sleep=0.005)
    srv = EnsembleServer(batch_handler=handler, n_workers=2,
                         max_batch=1, max_wait_ms=0.5).start()
    windows = _windows(11, 16)
    for i, w in enumerate(windows):
        assert srv.submit(i, w)
    stats = srv.stop()
    scores = {p: s for p, s, *_ in srv.results()}
    assert stats.served == 16 and stats.failed == 0 and not srv.leaked
    assert len(scores) == 16 and not any(np.isnan(list(scores.values())))
    assert devs[2] in seen and seen.index(devs[2]) >= 1   # mid-flush
    assert list(plane._failover_threads) == [2]
    assert [r["kind"] for r in plane.recoveries] == ["quarantined"]
    assert sw.quarantined == [devs[2]] and sw.devices == [devs[0], devs[1],
                                                          devs[3]]
    assert sw.active_placement.n_slots == 3
    assert devs[2] not in {b.device for b in sw.facade.current._buckets}
    flat = tp.EnsembleService(tzoo, device="cpu")
    assert_bitwise([scores[i] for i in range(16)],
                   [flat.predict(w) for w in windows], "after failover")


def test_protect_transient_lane_loss_waits(tzoo):
    """A transient loss is waited out on short sleeps: no quarantine,
    the device comes back, the flush serves bitwise."""
    n = len(tzoo)
    rich = np.ones(n, np.int8)
    sw = _swapper(tzoo, rich, 4, placement_fn=lambda s: _bucket_plan(
        tzoo, s, 4))
    plane = tf.FaultPlane([tf.FaultEvent(0.0, "device_loss", target=1,
                                         duration=0.2)])
    plane.arm(sw, devices=sw.devices)
    handler = plane.protect(sw.facade.predict_batch, sw,
                            retry_sleep=0.01)
    windows = _windows(12, 3)
    t0 = time.monotonic()
    got = handler(windows)
    assert time.monotonic() - t0 >= 0.15
    assert sw.quarantined == [] and not plane._failover_threads
    assert [r["kind"] for r in plane.recoveries] == ["device_restored"]
    assert_bitwise(got, tp.EnsembleService(tzoo, device="cpu")
                   .predict_batch(windows), "transient")


def test_protect_engine_permanent_loss_rebind(tzoo):
    """Permanent loss of lane 1 mid-tick: the ``TickLadder`` sheds while
    the shards restage and climbs back after, the swapper quarantines,
    the engine rebinds onto the survivors and re-runs the tick — which
    reads bitwise the UNSHARDED oracle."""
    n = len(tzoo)
    rich = np.ones(n, np.int8)
    sw = _swapper(tzoo, rich, 4, n_devices=4, warmup_batch_sizes=(4,),
                  plan_batch=1, cost_reps=1)
    devs = list(sw.devices)
    di = ta.DeviceIngest([ta.ModalitySpec("ecg", 250.0, 3)], 4, 1.0,
                         device="cpu")
    eng = SlotEngine(sw.facade.current, di)
    assert len(eng.groups) == 4
    ticker = SlotTicker(eng, interval=0.02)
    lad = TickLadder(ticker, intervals=(0.08, 0.02))
    intervals = []
    sw.quarantine_hooks.append(
        lambda lane, svc: intervals.append(ticker.interval))
    clk = FakeClock()
    plane = tf.FaultPlane([tf.FaultEvent(0.1, "device_loss", target=1)],
                          clock=clk)
    plane.arm(sw, devices=devs)
    plane.protect_engine(eng, sw, ticker=ticker, tick_ladder=lad)
    rng = np.random.default_rng(13)
    pts = [0, 1, 2, 3]
    refs = []
    for p in pts:
        di.ingest(0.0, p, "ecg",
                  rng.standard_normal((3, L)).astype(np.float32))
        refs.append(di.close_window(p, 1.0))
    for r in refs:
        eng.update(r)
    eng.tick()                               # the pre-loss baseline
    clk.advance(1.0)                         # the loss fires
    rep = eng.tick()                         # recovered inside the tick
    assert eng.n_tick_faults >= 1 and eng.n_tick_aborts == 0
    assert eng.n_rebinds >= 1 and devs[1] in sw.quarantined
    assert intervals == [0.08]               # shed while restaging
    assert lad.ladder_pos == len(lad.ladder) - 1 and ticker.interval == 0.02
    assert len(eng.groups) == 3
    assert devs[1] not in {g.device for g in eng.groups}
    assert sorted(map(int, rep.stamped)) == pts
    oracle = tp.EnsembleService(tzoo, device="cpu")
    assert_bitwise([eng.read(p) for p in pts], oracle.predict_batch(refs),
                   "after the rebind")
