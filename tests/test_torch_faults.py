"""The port's fault plane (``repro_torch/control/faults.py``) against the
JAX package's, and the slot engine's fault contract, on the CPU.

* the compound schedule generators give identical events for the same
  seeds, ``to_json`` gives identical text and ``from_json`` round-trips;
* ``guard``, the stall tokens, backpressure, active losses, fired
  events and recoveries give the same outcomes over one ``FakeClock``
  grid (the port compares ``torch.device`` values by equality: the
  probes are built apart from the plane's list); ``protect``'s retry
  budget runs out on the injected clock after the same calls;
* a device loss at ANY guard of a tick aborts it before the fold: the
  state tensor's bytes are unchanged and the reads stale, never wrong;
  recovery re-runs the tick, a queued rebind lands at the next tick, a
  close landing mid-tick skips its stamp;
* ``TickLadder`` takes the reference's positions for the same actions;
  ``SlotTicker`` and ``TickerWatchdog`` respawn after a stall or a
  death, and ``stop()`` joins every generation.  Nothing here sleeps to
  make something happen: clocks are injected and threads are driven
  by events.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro.control import faults as jf
from repro.serving import slots as js
from repro_torch.configs.ecg_zoo import zoo_specs
from repro_torch.control import faults as tf
from repro_torch.device import Lane, device_lanes
from repro_torch.models.ecg_resnext import init_ecg
from repro_torch.serving import aggregator as ta
from repro_torch.serving import pipeline as tp
from repro_torch.serving import server as tserver
from repro_torch.serving import slots as ts
from repro_torch.testing import assert_bitwise

torch.set_num_threads(1)
L = 250


class FakeClock:
    """Injectable monotonic clock: a plane's schedule and deadlines
    advance exactly when the test says so."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += float(dt)


class _StubEngine:
    """Duck-typed engine for the ticker and watchdog: counts ticks and
    sets ``ticked`` on each; ``die_first`` kills the first generation
    (``SystemExit`` out of its first tick)."""

    def __init__(self, die_first: bool = False, until: int = 1):
        self.n = 0
        self.until = until
        self.ticked = threading.Event()
        self._die = die_first

    def tick(self):
        if self._die:
            self._die = False
            raise SystemExit
        self.n += 1
        if self.n >= self.until:
            self.ticked.set()


# ---------------------------------------------- the plane vs the reference
@pytest.mark.parametrize("n_devices", [1, 2, 3, 8])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_compound_schedules_match_the_reference(n_devices, seed):
    for gen in ("compound_schedule", "slot_compound_schedule"):
        for t0 in (0.45, 2.0):
            want = [e.to_dict() for e in getattr(jf, gen)(n_devices, seed,
                                                          t0)]
            got = [e.to_dict() for e in getattr(tf, gen)(n_devices, seed,
                                                         t0)]
            assert got == want, (gen, t0)


def test_trace_json_identical_and_round_trips(tmp_path):
    for seed in (0, 3):
        sched = tf.slot_compound_schedule(8, seed=seed) \
            + tf.compound_schedule(2, seed=seed)
        plane = tf.FaultPlane(sched, seed=seed)
        jplane = jf.FaultPlane([jf.FaultEvent(**e.to_dict())
                                for e in sched], seed=seed)
        text = plane.to_json()
        assert text == jplane.to_json()
        path = str(tmp_path / f"trace{seed}.json")
        plane.to_json(path)
        for src in (text, path, __import__("json").loads(text)):
            back = tf.FaultPlane.from_json(src)
            assert [e.to_dict() for e in back.schedule] \
                == [e.to_dict() for e in plane.schedule]
            assert back.seed == seed and back.to_json() == text
    with pytest.raises(ValueError, match="unknown fault kind"):
        tf.FaultEvent(0.0, "meteor")


def _probe(plane, devices, fresh):
    """One grid point: every guard outcome (the lost index or None),
    then the stall tokens, backpressure, losses and ``done``."""
    out = []
    for dev in [None] + [fresh(i) for i in range(len(devices))]:
        try:
            plane.guard(dev)
            out.append(None)
        except Exception as e:
            out.append((type(e).__name__, e.index))
    out += [plane.stall_pending(), plane.ticker_stall_pending(),
            plane.backpressure_active(), sorted(plane.active_losses()),
            plane.done()]
    return out


def test_plane_outcomes_match_the_reference_on_a_fake_clock(monkeypatch):
    """The same schedule on the same ``FakeClock`` grid: identical
    guard outcomes (transient and permanent losses, a loss past the
    device list, which a default-device guard also hits), stall tokens,
    backpressure, fired events and recoveries.  A wall-clock step
    changes nothing."""
    sched = [(0.3, "device_loss", 1, 0.5), (0.5, "worker_stall", 0, 0.2),
             (0.5, "worker_stall", 0, 0.3), (0.6, "ticker_stall", 0, 0.4),
             (0.9, "backpressure", 0, 0.6), (1.0, "device_loss", 0, 0.0),
             (1.2, "device_loss", 2, 0.25), (1.6, "device_loss", 3, 0.1)]
    jdevs = [object(), object(), object()]
    tdevs = [torch.device("cpu"), torch.device("meta"),
             torch.device("cuda", 3)]
    jclk, tclk = FakeClock(), FakeClock()
    jplane = jf.FaultPlane([jf.FaultEvent(*e) for e in sched], clock=jclk)
    tplane = tf.FaultPlane([tf.FaultEvent(*e) for e in sched], clock=tclk)
    # probes before arming are refused alike
    with pytest.raises(RuntimeError):
        tplane.now()
    assert tplane.ticker_stall_pending() == jplane.ticker_stall_pending()
    jplane.arm(devices=jdevs)
    tplane.arm(devices=tdevs)
    monkeypatch.setattr(time, "time", lambda: 1e12)      # a wall jump
    for _ in range(50):
        want = _probe(jplane, jdevs, lambda i: jdevs[i])
        got = _probe(tplane, tdevs, lambda i: torch.device(str(tdevs[i])))
        assert got == want, (tclk.t, got, want)
        jclk.advance(0.05)
        tclk.advance(0.05)
    assert [(t, e.to_dict()) for t, e in tplane.fired] \
        == [(t, e.to_dict()) for t, e in jplane.fired]
    assert tplane.recoveries == jplane.recoveries
    assert any(r["kind"] == "device_restored" for r in tplane.recoveries)


def test_guard_compares_torch_devices_by_equality():
    clk = FakeClock()
    plane = tf.FaultPlane([tf.FaultEvent(0.1, "device_loss", target=0)],
                          clock=clk).arm(devices=[torch.device("cpu")])
    clk.advance(0.2)
    probe = torch.device("cpu")              # not the plane's object
    assert probe is not plane.devices[0]
    with pytest.raises(tf.DeviceLostError) as ei:
        plane.guard(probe)
    assert ei.value.index == 0 and ei.value.device == probe
    plane.guard(torch.device("meta"))        # another device: passes


def test_arm_defaults_to_the_cards_and_needs_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tf.FaultPlane([]).arm()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    plane = tf.FaultPlane([]).arm()
    # one lane a card: the same default as EnsembleService and
    # HotSwapper, so the guard compares lanes with lanes
    assert plane.devices == [Lane(0, torch.device("cuda", 0)),
                             Lane(1, torch.device("cuda", 1))]
    assert plane.devices == device_lanes()


def test_protect_retry_budget_matches_the_reference():
    """``protect()``'s retry budget rides the injected clock: with a
    permanent loss and no swapper, both planes give up after the same
    number of calls."""
    counts = []
    for mod, devs in ((jf, [object()]), (tf, [torch.device("cpu")])):
        clk = FakeClock()
        plane = mod.FaultPlane([mod.FaultEvent(0.1, "device_loss",
                                               target=0)], clock=clk)
        plane.arm(devices=devs)
        clk.advance(0.2)
        calls = []

        def fn(windows, _mod=mod, _calls=calls, _clk=clk):
            _calls.append(1)
            _clk.advance(1.0)
            raise _mod.DeviceLostError(None, 0)

        guarded = plane.protect(fn, swapper=None, retry_budget_s=5.0,
                                retry_sleep=0.0)
        with pytest.raises(mod.DeviceLostError):
            guarded([])
        counts.append(len(calls))
    assert counts[0] == counts[1] and 2 <= counts[1] <= 8


def test_protect_engine_wires_the_ticker_and_the_recovery_hook():
    """Without a swapper (the single-card pool) a loss is not
    recoverable in the tick: the hook returns False and the tick
    aborts; the ticker's stall hook is the plane's token consumer."""
    clk = FakeClock()
    plane = tf.FaultPlane([tf.FaultEvent(0.1, "device_loss", target=0),
                           tf.FaultEvent(0.1, "ticker_stall",
                                         duration=0.5)], clock=clk)
    stub = _StubEngine()
    ticker = ts.SlotTicker(stub, interval=1.0)
    plane.protect_engine(stub, swapper=None, ticker=ticker)
    plane.arm(devices=[torch.device("cpu")])
    assert ticker.before_tick() == 0.0
    clk.advance(0.2)
    assert ticker.before_tick() == 0.5 and ticker.before_tick() == 0.0
    assert stub.on_device_lost(tf.DeviceLostError(None, 0)) is False


# ------------------------------------------ the engine's fault contract
@pytest.fixture(scope="module")
def members():
    specs = zoo_specs(reduced=True, input_len=L, blocks=(2,))
    return [tp.ZooMember(s, init_ecg(s, torch.Generator().manual_seed(i)))
            for i, s in enumerate(specs)]


def _engine(members, n):
    svc = tp.EnsembleService(members, device="cpu")
    di = ta.DeviceIngest([ta.ModalitySpec("ecg", 250.0, 3)], n, 1.0,
                         device="cpu")
    return svc, di, ts.SlotEngine(svc, di)


def _close(di, rng, patients, t0):
    refs = {}
    for p in patients:
        di.ingest(t0, p, "ecg",
                  rng.standard_normal((3, L)).astype(np.float32))
        refs[p] = di.close_window(p, t0 + 1.0)
    return refs


def _oracle(svc, refs, patients):
    return np.asarray(svc.predict_batch([refs[p] for p in patients]))


def _reads(eng, patients):
    return np.asarray([eng.read(p) for p in patients])


def _state_bytes(eng):
    return [g.state.numpy().tobytes() for g in eng.groups]


@pytest.mark.parametrize("at", range(3), ids=["gather", "bucket0",
                                              "bucket1"])
def test_device_loss_at_any_guard_aborts_before_the_fold(members, at):
    """Every guard of a tick (the ring gather's, then one per bucket
    pass) fires before the fold: a loss at any of them leaves the state
    tensor's bytes as they were, the reads stale but never wrong, and
    the first tick after the restore is bitwise the flush."""
    svc, di, eng = _engine(members, 4)
    assert svc.n_buckets == 2
    rng = np.random.default_rng(at)
    pts = [0, 1, 2, 3]
    refs = _close(di, rng, pts, 0.0)
    for p in pts:
        eng.update(refs[p])
    eng.tick()
    before = _reads(eng, pts)
    assert_bitwise(before, _oracle(svc, refs, pts), "first tick")
    state = _state_bytes(eng)

    clk = FakeClock()
    plane = tf.FaultPlane([tf.FaultEvent(1.0, "device_loss", target=0,
                                         duration=5.0)], clock=clk)
    plane.arm(devices=[torch.device("cpu")])
    calls = []

    def guard(device):
        calls.append(device)
        if len(calls) == at + 1:
            clk.advance(2.0)               # the loss fires at this guard
        plane.guard(device)

    svc.dispatch_guard = guard
    refs2 = _close(di, rng, pts, 1.0)
    vers = {p: eng.update(refs2[p]) for p in pts}
    with pytest.raises(tf.DeviceLostError):
        eng.tick()
    assert calls == [None] * (at + 1)
    assert eng.n_tick_faults == 1 and eng.n_tick_aborts == 1
    assert _state_bytes(eng) == state       # untouched, byte for byte
    assert_bitwise(_reads(eng, pts), before, "stale, never wrong")
    assert not eng.wait_scored(0, vers[0], timeout=0.0)
    assert eng.dispatch_count == svc.n_buckets

    clk.advance(10.0)                       # the device is restored
    del calls[:]
    rep = eng.tick()
    assert calls == [None] * (1 + svc.n_buckets)
    assert sorted(map(int, rep.stamped)) == pts
    assert_bitwise(_reads(eng, pts), _oracle(svc, refs2, pts), "restored")
    assert _state_bytes(eng) != state


def test_on_device_lost_recovery_reruns_the_tick(members):
    svc, di, eng = _engine(members, 4)
    clk = FakeClock()
    plane = tf.FaultPlane([tf.FaultEvent(1.0, "device_loss", target=0,
                                         duration=3.0)], clock=clk)
    plane.arm(devices=[torch.device("cpu")])
    svc.dispatch_guard = plane.guard
    pts = [0, 1, 2, 3]
    refs = _close(di, np.random.default_rng(3), pts, 0.0)
    for p in pts:
        eng.update(refs[p])
    clk.advance(1.5)                        # the loss is active
    calls = []

    def recover(err):
        calls.append(err.index)
        clk.advance(10.0)                   # the device reboots
        return True

    eng.on_device_lost = recover
    rep = eng.tick()
    assert calls == [0]
    assert eng.n_tick_faults == 1 and eng.n_tick_aborts == 0
    assert sorted(map(int, rep.stamped)) == pts
    assert_bitwise(_reads(eng, pts), _oracle(svc, refs, pts), "re-run")


def test_request_rebind_applied_at_the_next_tick(members):
    svc, di, eng = _engine(members, 2)
    svc2 = tp.EnsembleService(members, device="cpu")
    eng.request_rebind(svc2)
    assert eng.service is svc
    refs = _close(di, np.random.default_rng(4), [0, 1], 0.0)
    for p in (0, 1):
        eng.update(refs[p])
    rep = eng.tick()
    assert eng.service is svc2 and eng.n_rebinds == 1
    assert len(rep.stamped) == 2
    assert_bitwise(_reads(eng, [0, 1]), _oracle(svc2, refs, [0, 1]),
                   "rebound")


def test_midtick_close_skips_the_stamp(members):
    """A close between a tick's readback and its stamp bumps the close
    version, so that slot is not stamped (the gather may have seen the
    newer samples); the next tick scores the new window bitwise."""
    svc, di, eng = _engine(members, 2)
    rng = np.random.default_rng(5)
    refs = _close(di, rng, [0, 1], 0.0)
    for p in (0, 1):
        eng.update(refs[p])
    newref = {}

    def hook():
        eng._pre_stamp_hook = None
        newref.update(_close(di, rng, [0], 1.0))
        eng.update(newref[0])

    eng._pre_stamp_hook = hook
    rep = eng.tick()
    assert 0 not in rep.stamped and 1 in rep.stamped
    assert np.isnan(eng.read(0))           # never scored; not wrong
    assert eng.read(1) == _oracle(svc, refs, [0, 1])[1]
    rep2 = eng.tick()
    assert 0 in rep2.stamped
    assert_bitwise(_reads(eng, [0, 1]),
                   _oracle(svc, {0: newref[0], 1: refs[1]}, [0, 1]),
                   "after the mid-tick close")


def test_wait_scored_with_a_stopped_ticker_times_out(members):
    svc, di, eng = _engine(members, 2)
    ticker = ts.SlotTicker(eng, interval=0.01).start()
    assert ticker.stop()
    v = eng.update(_close(di, np.random.default_rng(6), [0], 0.0)[0])
    t0 = time.monotonic()
    assert not eng.wait_scored(0, v, timeout=0.05)
    assert time.monotonic() - t0 < 1.0
    assert np.isnan(eng.read(0))


# -------------------------------------------------- ticker and watchdog
def test_tick_ladder_matches_the_reference():
    rng = np.random.default_rng(8)
    for trial in range(20):
        rungs = sorted(set(rng.uniform(0.01, 1.0, rng.integers(1, 5))
                           .round(3).tolist()))
        start = None if trial % 2 else int(rng.integers(0, len(rungs)))
        lads = []
        for mod in (js, ts):
            ticker = mod.SlotTicker(_StubEngine(), interval=0.5)
            lads.append((mod.TickLadder(ticker, rungs, start=start),
                         ticker))
        for _ in range(12):
            act = rng.choice(["shed", "climb", "swap_to"])
            pos = int(rng.integers(-1, len(rungs) + 1))
            out = []
            for lad, ticker in lads:
                try:
                    r = lad.swap_to(pos) if act == "swap_to" \
                        else getattr(lad, act)()
                except ValueError:
                    r = ValueError
                out.append((r, lad.ladder_pos, lad.active_interval,
                            ticker.interval, lad.can_shed(),
                            lad.can_climb(), lad.ladder))
            assert out[0] == out[1], (act, pos, out)
    for bad in ([], [0.1, -0.1]):
        with pytest.raises(ValueError):
            ts.TickLadder(ts.SlotTicker(_StubEngine()), bad)
    with pytest.raises(ValueError):
        ts.TickLadder(ts.SlotTicker(_StubEngine()), [0.1], start=5)


def test_ticker_stop_joins_every_generation():
    t = ts.SlotTicker(_StubEngine(), interval=0.01).start()
    assert t.respawn() and t.respawn()
    assert len(t._threads) == 3
    assert len({th.name for th in t._threads}) == 3
    assert t.stop(join_timeout=2.0) is True
    assert t.alive_threads() == [] and not t.alive
    assert not t.respawn()                  # stopped for good


def test_ticker_wedged_generation_surfaces_in_leak_accounting():
    entered, release = threading.Event(), threading.Event()

    class Wedge:
        def tick(self):
            entered.set()
            release.wait(10.0)

    t = ts.SlotTicker(Wedge(), interval=0.001).start()
    assert entered.wait(5.0)                # generation 0 is wedged
    assert t.respawn()
    assert t.stop(join_timeout=0.1) is False
    assert t.alive_threads()                # the zombie is named
    release.set()
    assert t.stop(join_timeout=5.0) is True
    assert t.alive_threads() == []


def test_watchdog_respawns_a_stalled_ticker():
    """Generation 0 stalls in ``before_tick`` (no beat); only a
    respawned generation can tick after that."""
    stub = _StubEngine()
    stalled, release = threading.Event(), threading.Event()
    first = [True]

    def before_tick():
        if first[0]:
            first[0] = False
            stalled.set()
            release.wait(10.0)              # a stall that never beats
        return 0.0

    t = ts.SlotTicker(stub, interval=0.005)
    t.before_tick = before_tick
    t.start()
    wd = ts.TickerWatchdog(t, deadline_seconds=0.05, poll=0.01).start()
    try:
        assert stalled.wait(5.0)
        assert stub.ticked.wait(10.0)       # a fresh generation ticks
        assert wd.n_respawns >= 1 and t.n_respawns >= 1
        assert any(e["cause"] == "stall" for e in wd.events)
    finally:
        release.set()
        assert wd.stop()
        assert t.stop(join_timeout=5.0)     # generation 0 exits too
    assert t.alive_threads() == []


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_watchdog_respawns_a_dead_ticker():
    stub = _StubEngine(die_first=True)      # generation 0 dies
    t = ts.SlotTicker(stub, interval=0.005).start()
    wd = ts.TickerWatchdog(t, deadline_seconds=0.05, poll=0.01).start()
    try:
        assert stub.ticked.wait(10.0)
        assert wd.n_respawns >= 1
        assert any(e["cause"] == "dead" for e in wd.events)
    finally:
        assert wd.stop() and t.stop(join_timeout=5.0)


def test_watchdog_reads_a_slow_rung_live_not_as_a_stall():
    """The quiet threshold is ``deadline + ticker.interval``, read live:
    ticks 0.2 s apart under a 0.05-s deadline are not a stall."""
    stub = _StubEngine(until=3)
    t = ts.SlotTicker(stub, interval=0.2).start()
    wd = ts.TickerWatchdog(t, deadline_seconds=0.05, poll=0.01).start()
    try:
        assert stub.ticked.wait(10.0)       # three slow ticks
        assert wd.n_respawns == 0
    finally:
        assert wd.stop() and t.stop()
    with pytest.raises(ValueError):
        ts.TickerWatchdog(t, deadline_seconds=0.0)


def test_server_slots_ticker_watchdog_lifecycle(members):
    """``EnsembleServer`` wires the ticker watchdog: a stall mid-serve
    is respawned through, the queries score bitwise after the gap, and
    shutdown leaves no thread, respawned generations included."""
    svc, di, eng = _engine(members, 4)
    srv = tserver.EnsembleServer(engine="slots", slot_engine=eng,
                                 n_workers=2, tick_interval=0.005,
                                 slot_wait_timeout=30.0,
                                 ticker_deadline_seconds=0.05)
    stalled, release = threading.Event(), threading.Event()
    first = [True]

    def before_tick():
        if first[0]:
            first[0] = False
            stalled.set()
            release.wait(10.0)
        return 0.0

    srv.ticker.before_tick = before_tick
    srv.start()
    pts = [0, 1, 2, 3]
    refs = _close(di, np.random.default_rng(9), pts, 0.0)
    try:
        assert stalled.wait(5.0)
        for p in pts:
            assert srv.submit(p, refs[p])
        srv.drain(timeout=30.0)
        got = {p: s for p, s, _, _ in srv.results()}
        assert srv.ticker.n_respawns >= 1
        assert srv.ticker_watchdog.n_respawns >= 1
    finally:
        release.set()
        srv.stop(join_timeout=5.0)
    assert_bitwise(np.asarray([got[p] for p in pts]),
                   _oracle(svc, refs, pts), "served through the stall")
    assert srv.leaked == []
    left = [th.name for th in threading.enumerate()
            if th.is_alive() and th.name.startswith("repro-")]
    assert left == []
