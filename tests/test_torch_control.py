"""The port's closed control loop (``repro_torch/control``,
``serving/latency.py``, ``serving/simulator.py``) against the JAX
package's, on the CPU.

All of it is host logic and numpy arithmetic in the reference's order,
so every comparison is IDENTICAL (no tolerance):

* the latency model: ``arrival_curve``, ``service_curve``,
  ``max_horizontal_distance``, ``queueing_bound`` and
  ``LatencyProfiler`` on seeded traces;
* the DES: every field of ``SimResult`` over static cohorts, churn with
  census steps, burst admissions, batch mode, backlog carried across
  the epoch edge, tiers and escalation, over a few seeds;
* telemetry: ``SloTelemetry`` readings under the exact and the sketch
  engines fed the same seeded out-of-order events under an injected
  clock (with ``since=`` cuts, a service profile and an imbalance),
  ``merge``, and the tap of the port's ``EnsembleServer``;
* the controller: the ``decide`` cases of ``tests/test_control.py``,
  cooldown, the RE-PLACE brand, background RE-PLACE and recompose with
  bounded joins, ``stop`` and a hung recompose, and
  ``wire_controller``'s service profile;
* the two reference tests that waited for this slice, over the port:
  the tick ladder actuated by the controller, and RE-PLACE fed by the
  live retire drift over 2 CPU lanes through ``wire_controller``;
* a seeded closed loop (controller + ``recompose`` + ``simulate``, the
  epoch loop of ``benchmarks/adaptive_bench.py::run_adaptive_sim``
  written below over either package): the same action log, per-epoch
  p99 and served selectors, under both telemetry engines.

Every threaded test joins with a bounded timeout and asserts on it.
"""
import threading
import time
import types

import numpy as np
import pytest
import torch

import jax

from repro.control import controller as jctl
from repro.control import faults as jfaults
from repro.control import swap as jswap
from repro.control import telemetry as jtel
from repro.core import bagging as jbag
from repro.core import composer as jcomp
from repro.core import profiles as jprof
from repro.serving import latency as jlat
from repro.serving import placement as jpl
from repro.serving import simulator as jsim
from repro_torch.configs.ecg_zoo import bucket_zoo
from repro_torch.control import controller as tctl
from repro_torch.control import faults as tfaults
from repro_torch.control import swap as tswap
from repro_torch.control import telemetry as ttel
from repro_torch.core import bagging as tbag
from repro_torch.core import composer as tcomp
from repro_torch.core import profiles as tprof
from repro_torch.device import lanes
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import aggregator as ta
from repro_torch.serving import latency as tlat
from repro_torch.serving import pipeline as tp
from repro_torch.serving import placement as tpl
from repro_torch.serving import simulator as tsim
from repro_torch.serving.server import EnsembleServer
from repro_torch.serving.slots import SlotEngine, SlotTicker, TickLadder
from repro_torch.testing import assert_bitwise

torch.set_num_threads(1)
L = 250
JOIN_S = 5.0                 # every join in this file is bounded by it


def _sel(n, idx):
    b = np.zeros(n, np.int8)
    b[list(idx)] = 1
    return b


# ------------------------------------------------------- latency model
@pytest.mark.parametrize("n", [0, 1, 2, 17, 60, 300])
def test_arrival_curve_and_bounds_identical(n):
    rng = np.random.default_rng(n)
    arr = rng.uniform(0, 10, n)
    if n > 4:
        arr[:3] = arr[3]                      # a burst at one instant
    dts = np.concatenate([[0.0], rng.uniform(0, 12, 9)])
    np.testing.assert_array_equal(tlat.arrival_curve(arr, dts),
                                  jlat.arrival_curve(arr, dts))
    alpha = jlat.arrival_curve(arr, dts)
    for mu, T0 in ((4.0, 0.05), (50.0, 0.0), (0.5, 1.0), (0.0, 0.1)):
        np.testing.assert_array_equal(tlat.service_curve(mu, T0, dts),
                                      jlat.service_curve(mu, T0, dts))
        assert tlat.max_horizontal_distance(dts, alpha, mu, T0) \
            == jlat.max_horizontal_distance(dts, alpha, mu, T0)
        assert tlat.queueing_bound(arr, mu, T0) \
            == jlat.queueing_bound(arr, mu, T0)


def _zoo(prof, n=6, seed=0):
    rng = np.random.default_rng(seed)
    return prof.ModelZoo([prof.ModelProfile(
        name=f"m{i}", depth=2 + i, width=16,
        macs=float(rng.uniform(1e8, 2e9)),
        memory_bytes=float(rng.uniform(1e6, 4e9)), modality=i % 3,
        input_len=7500, val_auc=0.7) for i in range(n)])


@pytest.mark.parametrize("case", ["analytic", "measured", "speeds",
                                  "placement", "oom", "unstable"])
def test_latency_profiler_identical(case):
    costs = np.linspace(0.01, 0.05, 6)
    got = []
    for prof, lat, pl in ((jprof, jlat, jpl), (tprof, tlat, tpl)):
        cfg = dict(n_devices=2, n_patients=40, window_seconds=10.0)
        kw = {}
        if case != "analytic":
            kw["cost_fn"] = lambda i: costs[i]
        if case == "speeds":
            kw["device_speeds"] = [1.0, 2.5]
        if case == "oom":
            cfg["device_mem_bytes"] = 1e6
        if case == "unstable":
            cfg["n_patients"] = 150       # lam 15/s over mu 11/s in full
        f_l = lat.LatencyProfiler(_zoo(prof), prof.SystemConfig(**cfg),
                                  seed=3, **kw)
        plan = pl.lpt_placement([0.05, 0.01, 0.03], 2) \
            if case == "placement" else None
        row = []
        for b in (_sel(6, [0, 2, 5]), _sel(6, range(6)), _sel(6, [])):
            row += [f_l(b, placement=plan), f_l.serving_latency(b, plan),
                    f_l.throughput(b), f_l.ensemble_memory(b)]
        row.append(f_l.query_arrivals().tolist())
        got.append(row)
    assert got[0] == got[1]


# ------------------------------------------------------------------ DES
def _sim_fields(r):
    """Every field of a ``SimResult``, as plain values."""
    return ([(q.patient, q.t_window, q.t_start, q.t_done, q.n_models,
              q.tier) for q in r.queries], r.arrivals.tolist(),
            r.ingest_events, r.device_busy, r.duration,
            {k: (v.n_pushed, v.n_popped, v.total_wait, v.max_wait,
                 v.max_depth)
             for k, v in r.queue_stats.items()},
            r.patients, r.churn_log, r.backlog.tolist(), r.backlog_tiers,
            r.tier_log, r.p(50), r.p(99), r.utilization,
            r.queue_delays().tolist())


FRACS = {"stable": 0.5, "elevated": 0.3, "critical": 0.2}
TIER_COSTS = {"stable": [0.01], "elevated": [0.01, 0.02],
              "critical": [0.01, 0.02, 0.03]}
SIM_CASES = {
    "static": ([0.01, 0.02], dict(n_patients=12, window_seconds=5.0,
                                  duration_seconds=40.0, n_devices=2)),
    "churn": ([0.01], dict(window_seconds=10.0, duration_seconds=100.0,
                           census=[(0.0, 10), (30.0, 25), (70.0, 5)])),
    "burst": ([0.002], dict(window_seconds=10.0, duration_seconds=40.0,
                            census=[(0.0, 6), (20.0, 12)],
                            churn_phase_jitter=0.0)),
    "batch": ([0.01, 0.03], dict(n_patients=8, window_seconds=5.0,
                                 duration_seconds=30.0, batch_period=7.0)),
    "backlog": ([0.3], dict(n_patients=30, n_devices=1, window_seconds=5.0,
                            duration_seconds=40.0, carry_backlog=True)),
    "tiered": (TIER_COSTS, dict(window_seconds=5.0, duration_seconds=60.0,
                                census=[(0.0, 6), (20.0, 14), (40.0, 4)],
                                n_devices=2, tiers=FRACS,
                                escalate_hazard=0.25)),
    "tiered_backlog": ({t: [0.25] for t in FRACS},
                       dict(n_patients=24, n_devices=1, window_seconds=5.0,
                            duration_seconds=40.0, carry_backlog=True,
                            tiers=FRACS)),
}


@pytest.mark.parametrize("seed", [0, 5, 11])
@pytest.mark.parametrize("case", sorted(SIM_CASES))
def test_simulate_identical(case, seed):
    costs, cfg = SIM_CASES[case]
    runs = []
    for sim in (jsim, tsim):
        c = sim.SimConfig(seed=seed, **cfg)
        r1 = sim.simulate(costs, c)
        out = [_sim_fields(r1)]
        if cfg.get("carry_backlog"):
            # the next epoch ingests the carry at t=0, tiers and all
            nxt = {t: [0.02] for t in FRACS} if "tiers" in cfg else [0.05]
            r2 = sim.simulate(nxt, c, backlog=r1.backlog,
                              backlog_tiers=r1.backlog_tiers)
            out.append(_sim_fields(r2))
            assert len(r1.backlog) > 0
        runs.append(out)
    assert runs[0] == runs[1]
    assert runs[1][0][0], "the run served nothing: nothing compared"


def test_simulate_refusals_match():
    for sim in (jsim, tsim):
        with pytest.raises(ValueError):
            sim.simulate([0.01], sim.SimConfig(n_patients=2,
                                               escalate_hazard=0.5))
        with pytest.raises(ValueError):
            sim.simulate([0.01], sim.SimConfig(carry_backlog=True,
                                               batch_period=1.0))


# ------------------------------------------------------------ telemetry
def _events(seed, n=1500, jitter=0.5):
    """A seeded trace with out-of-order timestamps: (kind, t, latency)."""
    rng = np.random.default_rng(seed)
    t, last, out = 0.0, 0.0, []
    for _ in range(n):
        t += float(rng.exponential(0.01))
        tt = max(t + float(rng.uniform(-jitter, 0.0)), last - jitter)
        lat = float(rng.lognormal(-2.0, 0.7))
        kind = rng.uniform()
        out.append(("arrival", tt, None))
        out.append(("served", tt, lat) if kind < 0.85 else
                   ("shed", tt, None) if kind < 0.95 else
                   ("failure", tt, None))
        last = max(last, tt)
    return out


def _feed(tel, events):
    for kind, t, lat in events:
        if kind == "served":
            tel.record_served(lat, t)
        else:
            getattr(tel, f"record_{kind}")(t)


def _readings(tel, now):
    """Every read of a telemetry at ``now`` (None: its clock), as plain
    values."""
    at = tel.clock() if now is None else now
    snaps = [tel.snapshot(now=now),
             tel.snapshot(mu=40.0, ts=0.05, now=now, imbalance=1.3),
             tel.snapshot(now=now, since=at - 4.0),
             tel.snapshot(mu=90.0, ts=0.01, now=now, since=at - 7.3)]
    hist = tel.latency_histogram(now)
    return ([tuple(vars(s).values()) + (s.predicted_latency,)
             for s in snaps],
            tel.arrivals(now).tolist(), tel.latencies(now).tolist(),
            tel.arrival_rate(now),
            tel.arrival_curve(np.linspace(0, 3, 7), now).tolist(),
            tel.queueing_bound(60.0, 0.02, now),
            None if hist is None else hist.tolist(), tel.n_buckets)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("exact", [True, False])
def test_slo_telemetry_readings_identical(exact, seed):
    events = _events(seed)
    clock = [0.0]
    got = []
    for tel_mod in (jtel, ttel):
        tel = tel_mod.SloTelemetry(0.3, 20.0, clock=lambda: clock[0],
                                   exact=exact)
        _feed(tel, events)
        got.append([_readings(tel, now) for now in (5.0, 12.5, 40.0)])
        clock[0] = 12.5
        got[-1].append(_readings(tel, None))
        clock[0] = 0.0
    assert str(got[0]) == str(got[1])         # NaN-safe equality
    assert got[1][1][0][0][3] > 0              # it served samples


@pytest.mark.parametrize("window,slo", [(60.0, 1.0), (10.0, 0.001),
                                        (0.0, 1.0), (3600.0, 0.05)])
def test_auto_n_buckets_identical(window, slo):
    assert ttel.auto_n_buckets(window, slo) == jtel.auto_n_buckets(window,
                                                                   slo)


@pytest.mark.parametrize("exact", [True, False])
def test_merge_identical(exact):
    events = _events(2, n=900)
    got = []
    for tel_mod in (jtel, ttel):
        parts = [tel_mod.SloTelemetry(0.3, 20.0, clock=lambda: 9.0,
                                      exact=exact) for _ in range(3)]
        for i, ev in enumerate(events):
            _feed(parts[i % 3], [ev])
        merged = tel_mod.SloTelemetry.merge(parts)
        got.append(_readings(merged, 9.0))
        with pytest.raises(ValueError):
            tel_mod.SloTelemetry.merge([parts[0], tel_mod.SloTelemetry(
                0.5, 20.0, exact=exact)])
        with pytest.raises(ValueError):
            tel_mod.SloTelemetry.merge([])
    assert str(got[0]) == str(got[1])


def test_server_telemetry_tap():
    """The port's server taps every arrival, retirement and shed."""
    tel = ttel.SloTelemetry(slo_seconds=1.0, window_seconds=60.0)
    srv = EnsembleServer(handler=lambda w: 1.0, n_workers=1,
                         telemetry=tel).start()
    for i in range(6):
        assert srv.submit(i, {})
    srv.drain(timeout=JOIN_S)
    srv.stop()
    assert not srv.leaked
    snap = tel.snapshot()
    assert (snap.n_arrivals, snap.n_served, snap.n_shed) == (6, 6, 0)
    shed = ttel.SloTelemetry(window_seconds=60.0)
    full = EnsembleServer(handler=lambda w: 0.0, max_queue=1,
                          telemetry=shed)             # never started
    assert full.submit(0, {}) and not full.submit(1, {})
    snap = shed.snapshot()
    assert (snap.n_arrivals, snap.n_shed) == (1, 1)


# ---------------------------------------------------- controller policy
def _ladder_cls(swap_mod):
    class NoopLadder(swap_mod.SelectorLadder):
        """A ladder whose activation records what went live."""

        def __init__(self, s):
            super().__init__(s)
            self.activations = []

        def _activate(self, selector):
            self.activations.append(selector.tobytes())
    return NoopLadder


def _noop_ladder(swap_mod, sel):
    return _ladder_cls(swap_mod)(sel)


def _snap(tel_mod, **kw):
    base = dict(t=0.0, window_seconds=30.0, n_arrivals=100, n_served=100,
                n_shed=0, arrival_rate=2.0, p50=0.1, p99=0.2,
                violation_rate=0.0)
    base.update(kw)
    return tel_mod.TelemetrySnapshot(**base)


def _controller(pkg, ladder_pos="top", **cfg):
    ctl_mod, tel_mod, swap_mod = pkg
    rungs = [_sel(4, [0]), _sel(4, [0, 1]), _sel(4, [0, 1, 2])]
    lad = _noop_ladder(swap_mod, rungs[-1 if ladder_pos == "top" else 0])
    lad.set_ladder(rungs)
    conf = ctl_mod.ControllerConfig(**{"slo_seconds": 1.0,
                                       "cooldown_seconds": 0.0, **cfg})
    return ctl_mod.AdaptiveController(tel_mod.SloTelemetry(), lad,
                                      config=conf, sync=True), lad


REF = (jctl, jtel, jswap)
PORT = (tctl, ttel, tswap)
DECIDE_CASES = [
    ("top", None, dict(n_served=3), "hold"),
    ("top", None, dict(violation_rate=0.5), "shed"),
    ("top", None, dict(p99=1.4), "shed"),
    ("top", None, dict(n_shed=5), "shed"),
    ("bottom", None, dict(violation_rate=0.5), "recompose"),
    ("top", 2.0, dict(arrival_rate=4.0), "recompose"),
    ("top", 2.0, dict(arrival_rate=1.0), "recompose"),
    ("top", None, dict(ts=0.3, tq_bound=1.1), "recompose"),
    ("top", None, dict(ts=0.3, tq_bound=0.8), "hold"),
    ("bottom", None, dict(p99=0.2), "climb"),
    ("bottom", None, dict(p99=0.8), "hold"),
    ("top", None, dict(p99=0.2), "hold"),
    ("bottom", None, dict(violation_rate=0.05, p99=0.2), "hold"),
]


@pytest.mark.parametrize("pos,baseline,kw,want", DECIDE_CASES)
def test_decide_identical(pos, baseline, kw, want):
    got = []
    for pkg in (REF, PORT):
        ctl, _ = _controller(pkg, pos)
        ctl.baseline_rate = baseline
        got.append(ctl.decide(_snap(pkg[1], **kw)).value)
    assert got == [want, want]


def _violating(tel, t0, n=40, lat=2.0, step=0.5):
    for k in range(n):
        tel.record_arrival(t0 + k * step)
        tel.record_served(lat, t0 + k * step)


def test_step_acts_and_cools_down_identical():
    """SHED kicks off a recompose, the cooldown gates the next step, a
    healthy window at the baseline rate climbs: the same log and
    ladder trace on both packages."""
    traces = []
    for ctl_mod, tel_mod, swap_mod in (REF, PORT):
        calls = []
        rungs = [_sel(4, [0]), _sel(4, [0, 1, 2])]
        lad = _noop_ladder(swap_mod, rungs[-1])
        lad.set_ladder(rungs)
        t = [100.0]
        tel = tel_mod.SloTelemetry(slo_seconds=1.0, window_seconds=30.0,
                                   clock=lambda: t[0])
        _violating(tel, 80.0)
        ctl = ctl_mod.AdaptiveController(
            tel, lad, recompose_fn=lambda s: calls.append(s) or rungs[0],
            config=ctl_mod.ControllerConfig(slo_seconds=1.0,
                                            cooldown_seconds=30.0),
            sync=True, clock=lambda: t[0])
        trace = [ctl.step().value, lad.ladder_pos, len(calls),
                 ctl.step().value]
        t[0] = 140.0
        for k in range(60):
            tel.record_served(0.1, 120.0 + k / 3)
            tel.record_arrival(120.0 + k / 3)
        trace += [ctl.step().value, lad.ladder_pos, ctl.n_recomposes,
                  ctl.baseline_rate, ctl.decision_counts(),
                  [(tt, d.value) for tt, d in ctl.log], lad.activations]
        traces.append(trace)
    assert traces[0] == traces[1]
    assert traces[1][:5] == ["shed", 0, 1, "hold", "climb"]


def _replace_ladder(swap_mod, pl_mod, re_place_result, slow=None):
    class ReplaceLadder(_ladder_cls(swap_mod)):
        def __init__(self, sel):
            super().__init__(sel)
            self.active_placement = pl_mod.Placement([[0], [1, 2]],
                                                     [1.0, 2.0])
            self.re_place_calls = 0
            self.release = threading.Event()

        def re_place(self, placement=None):
            self.re_place_calls += 1
            if slow:
                self.release.wait(slow)
                self.active_placement = pl_mod.Placement([[0, 2], [1]],
                                                         [2.0, 2.0])
            return re_place_result

    lad = ReplaceLadder(_sel(4, [0, 1, 2]))
    lad.set_ladder([_sel(4, [0]), _sel(4, [0, 1, 2])])
    return lad


def _healthy_tel(tel_mod, clock):
    tel = tel_mod.SloTelemetry(slo_seconds=1.0, window_seconds=30.0,
                               clock=clock)
    for k in range(30):
        tel.record_arrival(80.0 + k / 2)
        tel.record_served(0.1, 80.0 + k / 2)
    return tel


def test_replace_brand_identical():
    """A RE-PLACE that cannot improve the plan brands it: REPLACE stands
    aside until the placement changes or the imbalance grows past the
    branded level — the same calls and decisions on both packages."""
    traces = []
    for pkg, pl_mod in ((REF, jpl), (PORT, tpl)):
        ctl_mod, tel_mod, _ = pkg
        lad = _replace_ladder(pkg[2], pl_mod, False)
        imb = [2.0]
        ctl = ctl_mod.AdaptiveController(
            _healthy_tel(tel_mod, lambda: 100.0), lad,
            config=ctl_mod.ControllerConfig(slo_seconds=1.0,
                                            cooldown_seconds=0.0,
                                            imbalance_high=1.25),
            service_profile_fn=lambda: (50.0, 0.05, imb[0]),
            sync=True, clock=lambda: 100.0)
        trace = [ctl.decide(ctl.snapshot()).value, ctl.step().value,
                 lad.re_place_calls, ctl.step().value, lad.re_place_calls,
                 ctl._replace_noop_imb]
        imb[0] = 2.5                          # the drift grew: re-armed
        trace.append(ctl.decide(ctl.snapshot()).value)
        imb[0] = 2.0
        lad.active_placement = pl_mod.Placement([[0, 1], [2]], [2.0, 1.0])
        trace += [ctl.decide(ctl.snapshot()).value, ctl.log == []]
        traces.append(trace)
    assert traces[0] == traces[1]
    assert traces[1] == ["replace", "hold", 1, "hold", 1, 2.0, "replace",
                         "replace", True]


def test_async_replace_does_not_block_step():
    """sync=False: the RE-PLACE runs in a daemon thread, step() returns
    at once, one rebalance is in flight at a time; the join is bounded."""
    lad = _replace_ladder(tswap, tpl, True, slow=JOIN_S)
    t = [100.0]
    ctl = tctl.AdaptiveController(
        _healthy_tel(ttel, lambda: t[0]), lad,
        config=tctl.ControllerConfig(slo_seconds=1.0, cooldown_seconds=0.0),
        service_profile_fn=lambda: (50.0, 0.05, 3.0),
        sync=False, clock=lambda: t[0])
    t0 = time.monotonic()
    assert ctl.step() is tctl.Decision.REPLACE
    assert time.monotonic() - t0 < 0.5
    assert ctl._replacing.is_set()
    assert ctl.step() is tctl.Decision.HOLD   # one rebalance in flight
    lad.release.set()
    ctl._replace_thread.join(JOIN_S)
    assert not ctl._replace_thread.is_alive()
    assert lad.active_placement.loads == [2.0, 2.0]
    assert ctl._replace_noop_sig is None      # it acted: no brand
    assert ctl.stop(timeout=JOIN_S) and ctl.leaked == []


def _drifting(recompose_fn):
    """A port controller whose next step sees an arrival-rate drift and
    recomposes in the background."""
    rungs = [_sel(4, [0]), _sel(4, [0, 1])]
    lad = _noop_ladder(tswap, rungs[1])
    lad.set_ladder(rungs)
    tel = ttel.SloTelemetry(slo_seconds=1.0, window_seconds=30.0)
    ctl = tctl.AdaptiveController(
        tel, lad, recompose_fn=recompose_fn,
        config=tctl.ControllerConfig(cooldown_seconds=0.0, min_samples=0),
        sync=False)
    ctl.baseline_rate = 1.0
    now = time.monotonic()
    for k in range(30):
        tel.record_arrival(now - k * 0.1)
    return ctl, lad


def test_async_recompose_swaps():
    done = threading.Event()

    def slow_recompose(snap):
        done.wait(JOIN_S)
        return _sel(4, [2, 3])

    ctl, lad = _drifting(slow_recompose)
    assert ctl.step() is tctl.Decision.RECOMPOSE   # drift, in the back
    assert ctl._recomposing.is_set()
    assert ctl.step() is tctl.Decision.HOLD        # one in flight
    done.set()
    assert ctl.join_recompose(JOIN_S) is True
    np.testing.assert_array_equal(lad.active_selector, _sel(4, [2, 3]))
    assert ctl.n_recomposes == 1 and not ctl._recomposing.is_set()


def test_stop_joins_all_threads():
    ctl, _ = _controller(PORT)
    ctl.sync = False
    ctl.start(period_seconds=0.02)
    time.sleep(0.1)                            # a few monitor ticks
    assert ctl.stop(timeout=JOIN_S) is True
    assert ctl.leaked == []
    assert not any(t.name.startswith("repro-ctl-")
                   for t in threading.enumerate() if t.is_alive())


def test_stop_reports_hung_recompose():
    hang = threading.Event()

    def hung_recompose(snap):
        hang.wait(JOIN_S)
        return None

    ctl, _ = _drifting(hung_recompose)
    ctl.step()
    try:
        assert ctl.stop(timeout=0.2) is False
        assert ctl.leaked == ["repro-ctl-recompose"]
    finally:
        hang.set()                             # let the thread exit
    assert ctl.join_recompose(JOIN_S) is True


def test_config_slo_must_match_telemetry():
    for ctl_mod, tel_mod, swap_mod in (REF, PORT):
        with pytest.raises(ValueError):
            ctl_mod.AdaptiveController(
                tel_mod.SloTelemetry(slo_seconds=0.5),
                _noop_ladder(swap_mod, _sel(2, [0])),
                config=ctl_mod.ControllerConfig(slo_seconds=1.0))


# --------------------------------------------------------- wire_controller
class _FakeSwapper:
    """What ``wire_controller``'s profile reads off a swapper."""

    def __init__(self, pl_mod, fin, speeds, n_devices, placement=True):
        self.active_selector = _sel(6, [0, 2, 3, 5])
        self.active_placement = pl_mod.Placement(
            [[0, 2], [3, 5]], [0.03, 0.01]) if placement else None
        self.speeds = speeds
        self.n_devices = n_devices
        self.ladder, self.ladder_pos = [], -1
        svc = types.SimpleNamespace(measured_finish_times=lambda: fin)
        self.facade = types.SimpleNamespace(current=svc)

    def can_shed(self):
        return False

    def can_climb(self):
        return False


@pytest.mark.parametrize("fin,speeds,n_devices,costs,placement", [
    ([0.05, 0.01], None, 2, np.linspace(0.01, 0.06, 6), True),
    (None, [1.0, 3.0], 2, np.linspace(0.01, 0.06, 6), True),
    ([0.05, 0.01, 0.02], None, 4, np.ones(6), True),    # wrong length
    (None, None, 0, np.linspace(0.01, 0.06, 6), False),
    ([0.05, 0.01], None, 2, None, True)])
def test_wire_controller_profile_identical(fin, speeds, n_devices, costs,
                                           placement):
    got = []
    for faults, tel_mod, pl_mod in ((jfaults, jtel, jpl),
                                    (tfaults, ttel, tpl)):
        sw = _FakeSwapper(pl_mod, fin, speeds, n_devices, placement)
        steps = []
        ctl = faults.wire_controller(tel_mod.SloTelemetry(), sw,
                                     member_costs=costs, sync=True,
                                     start=False, on_step=steps.append)
        got.append((ctl.service_profile_fn(), ctl.step(now=1.0).value,
                    [d.value for d in steps], ctl._monitor is None))
    assert str(got[0]) == str(got[1])


def test_wire_controller_attaches_exporter_and_survives_hook():
    from repro_torch.obs.export import MetricsExporter
    tel = ttel.SloTelemetry()
    exp = MetricsExporter()
    sw = _FakeSwapper(tpl, None, None, 1)

    def bad_hook(decision):
        raise RuntimeError("an observer fails")

    ctl = tfaults.wire_controller(tel, sw, sync=True, start=False,
                                  exporter=exp, on_step=bad_hook)
    assert exp.controller is ctl and exp.telemetry is tel
    assert ctl.exporter is exp
    assert ctl.step(now=1.0) is tctl.Decision.HOLD    # the hook is caught
    ctl2 = tfaults.wire_controller(tel, sw, sync=True, start=True,
                                   period_seconds=0.01)
    assert ctl2._monitor is not None and ctl2._monitor.is_alive()
    assert ctl2.stop(timeout=JOIN_S) and not ctl2._monitor.is_alive()


# ----------------------------------- the two reference tests, over the port
@pytest.fixture(scope="module")
def tzoo(zoo_members):
    return [tp.ZooMember(m.spec, params_from_numpy(
        jax.tree.map(np.asarray, m.params))) for m in zoo_members]


def test_tick_ladder_actuated_by_adaptive_controller(tzoo):
    """Tick rate joins the controller's knobs: SLO violations SHED the
    tick ladder (interval slows), a healthy window climbs back."""
    di = ta.DeviceIngest([ta.ModalitySpec("ecg", 250.0, 3)], 2, 1.0,
                         device="cpu")
    eng = SlotEngine(tp.EnsembleService(tzoo, device="cpu"), di)
    ticker = SlotTicker(eng, interval=0.01)
    lad = TickLadder(ticker, intervals=[0.01, 0.1])
    t = [100.0]
    tel = ttel.SloTelemetry(slo_seconds=0.5, clock=lambda: t[0])
    ctl = tctl.AdaptiveController(
        tel, lad, sync=True, clock=lambda: t[0],
        config=tctl.ControllerConfig(slo_seconds=0.5, cooldown_seconds=0.0,
                                     drift_factor=1e9))
    for k in range(30):                        # violating traffic
        tel.record_arrival(99.0)
        tel.record_served(0.9, 99.0 + k / 100.0)
    assert ctl.step() is tctl.Decision.SHED
    assert lad.ladder_pos == 0 and ticker.interval == 0.1
    t[0] += 100.0                              # violations age out
    for k in range(30):
        tel.record_arrival(t[0] - 1.0)
        tel.record_served(0.05, t[0] - 1.0 + k / 100.0)
    assert ctl.step() is tctl.Decision.CLIMB
    assert lad.ladder_pos == 1 and ticker.interval == 0.01
    assert not ticker.alive                    # driven by hand only


def _windows(seed, n):
    rng = np.random.default_rng(seed)
    return [{"ecg": rng.standard_normal((3, L)).astype(np.float32)}
            for _ in range(n)]


def test_retire_drift_feeds_replace(tzoo):
    """A slowdown injected on lane 0 drifts its shards' retire EWMAs;
    the controller, wired to a live server, sees the finish-time
    imbalance, fires RE-PLACE, and ``re_place`` re-derives the plan
    from the drift, splitting lane 0's co-resident buckets; nothing is
    dropped and the scores stay bitwise the unsharded oracle's."""
    n = len(tzoo)
    sel = np.ones(n, np.int8)
    groups = list(bucket_zoo([m.spec for m in tzoo]).values())
    assert len(groups) >= 4
    pl_init = tpl.grouped_lpt_placement(
        groups, [1.0, 1.0] + [0.5] * (len(groups) - 2), 2)
    sw = tswap.HotSwapper(tzoo, sel, warmup_batch_sizes=(1,), n_devices=2,
                          devices=lanes(2, "cpu"),
                          placement_fn=lambda s: pl_init)
    sw.placement_fn = None                     # planning from drift on
    assert tpl.placement_signature(sw.active_placement) \
        == pl_init.signature()
    slow = sw.devices[0]
    slow_keys = {tuple(sorted(b.idx)) for b in sw.facade.current._buckets
                 if b.device == slow}
    assert len(slow_keys) >= 2                 # a co-resident pair

    def guard(lane):
        if lane == slow:
            # the injected slowdown: longer than the reference's 20 ms,
            # because here a pass is real CPU work (the reference's is an
            # asynchronous dispatch), and the slowed lane must lead by
            # more than a busy host's pass time
            time.sleep(0.1)

    sw.service_hook = lambda svc: setattr(svc, "dispatch_guard", guard)
    sw.facade.current.dispatch_guard = guard
    tel = ttel.SloTelemetry(slo_seconds=2.0, window_seconds=60.0)
    ctl = tfaults.wire_controller(
        tel, sw, member_costs=[0.01] * n,
        config=tctl.ControllerConfig(slo_seconds=2.0, cooldown_seconds=0.0,
                                     min_samples=5),
        sync=True, start=False)
    oracle = tp.EnsembleService(tzoo, device="cpu")
    windows = _windows(3, 12)
    served = []

    def score(batch):
        out = sw.facade.predict_batch(batch)
        served.append((list(batch), out))
        return out

    srv = EnsembleServer(batch_handler=score, n_workers=2, max_batch=1,
                         max_wait_ms=0.5, telemetry=tel).start()
    try:
        for i in range(8):                     # the drift phase
            assert srv.submit(i, windows[i])
        srv.drain(timeout=30.0)
        assert srv.stats.served == 8
        assert sw.facade.current.live_bucket_costs() is not None
        fin = sw.facade.current.measured_finish_times()
        assert fin is not None and fin[0] > fin[1] + 0.05
        assert tpl.finish_imbalance(fin) > 1.25    # the REPLACE trigger
        assert ctl.step() is tctl.Decision.REPLACE
        new_pl = sw.active_placement
        assert tpl.placement_signature(new_pl) != pl_init.signature()
        for slot in new_pl.assignment:         # the slowed pair split
            on_slot = {k for k in slow_keys if set(k) <= set(slot)}
            assert on_slot != slow_keys
        for i in range(8, 12):                 # the rebalanced phase
            assert srv.submit(i, windows[i])
        srv.drain(timeout=30.0)
    finally:
        stats = srv.stop()
    assert not srv.leaked
    assert stats.served == 12 and stats.failed == 0
    assert len(served) == 12
    for batch, out in served:
        assert_bitwise(np.asarray(out),
                       np.asarray(oracle.predict_batch(batch)))


# ------------------------------------------------- a seeded closed loop
def _pkg(ctl, tel, swap, comp, prof, lat, pl, sim, bag):
    return types.SimpleNamespace(ctl=ctl, tel=tel, swap=swap, comp=comp,
                                 prof=prof, lat=lat, pl=pl, sim=sim,
                                 bag=bag)


LOOP_REF = _pkg(jctl, jtel, jswap, jcomp, jprof, jlat, jpl, jsim, jbag)
LOOP_PORT = _pkg(tctl, ttel, tswap, tcomp, tprof, tlat, tpl, tsim, tbag)


def _testbed(P, n=10, n_val=400, seed=0):
    """``benchmarks/adaptive_bench.py::synthetic_testbed`` over ``P``."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, n_val)
    quality = np.linspace(0.5, 1.8, n) + rng.normal(0, 0.1, n)
    scores = np.stack([1.0 / (1.0 + np.exp(-(q * (2 * y - 1)
                                              + rng.normal(0, 2.0, n_val))))
                       for q in quality])
    costs = np.linspace(0.04, 0.22, n)
    labels = (y == 1).astype(int)
    zoo = P.prof.ModelZoo([P.prof.ModelProfile(
        name=f"m{i}", depth=2 + i, width=16, macs=costs[i] * 1e9,
        memory_bytes=1e6, modality=0, input_len=100,
        val_auc=P.bag.roc_auc(labels, scores[i])) for i in range(n)],
        val_scores=scores, val_labels=labels)

    def f_a(b):
        sel = scores[np.asarray(b, bool)]
        return P.bag.roc_auc(labels, sel.mean(axis=0)) if len(sel) else 0.5
    return zoo, costs, f_a


def _ladder_from(res, costs):
    """Cheapest single member, the best profiled selector at <= half the
    incumbent's cost, the incumbent (``adaptive_bench._ladder_from``)."""
    def cost_of(b):
        return float(costs[np.asarray(b, bool)].sum())

    cheap = np.zeros(len(costs), np.int8)
    cheap[int(np.argmin(costs))] = 1
    levels = [cheap]
    mid = [(a, b) for b, a in zip(res.B, res.Y_acc)
           if 0 < cost_of(b) <= cost_of(res.b_star) / 2
           and not np.array_equal(b, cheap)]
    if mid:
        levels.append(np.asarray(max(mid, key=lambda t: t[0])[1], np.int8))
    if not any(np.array_equal(x, res.b_star) for x in levels):
        levels.append(res.b_star.astype(np.int8))
    return levels


def _closed_loop(P, schedule, exact, slo=1.0, epoch_s=40.0, window_s=10.0,
                 n_devices=2, seed=0):
    """The epoch loop of ``run_adaptive_sim``: per-epoch DES -> telemetry
    replay -> controller step -> warm-started recompose -> the next
    epoch's selector."""
    zoo, costs, f_a = _testbed(P, seed=seed)
    epochs = [c for n_ep, c in schedule for _ in range(n_ep)]

    def f_l_for(n_patients):
        return P.lat.LatencyProfiler(zoo, P.prof.SystemConfig(
            n_devices=n_devices, n_patients=n_patients,
            window_seconds=window_s), cost_fn=lambda i: costs[i], seed=seed)

    res0 = P.comp.compose(len(zoo), f_a, f_l_for(epochs[0]), slo,
                          P.comp.ComposerParams(N=6, M=80, K=4, N0=10,
                                                seed=seed))

    class DesLadder(P.swap.SelectorLadder):
        def _activate(self, selector):
            pass

    swapper = DesLadder(res0.b_star)
    swapper.set_ladder(_ladder_from(res0, costs))
    tel = P.tel.SloTelemetry(slo_seconds=slo, window_seconds=epoch_s,
                             clock=lambda: 0.0, exact=exact)
    state = {"warm": res0}

    def recompose_fn(snap):
        n_est = max(1, int(round(snap.arrival_rate * window_s)))
        r = P.comp.recompose(f_a, f_l_for(n_est), slo,
                             warm_start=state["warm"],
                             params=P.comp.ComposerParams(N=4, M=80, K=4,
                                                          N0=8, seed=seed))
        state["warm"] = r
        swapper.set_ladder(_ladder_from(r, costs))
        return r.b_star

    def profile_fn():
        c = costs[swapper.active_selector.astype(bool)]
        if not len(c):
            return float("inf"), 0.0
        pl = P.pl.lpt_placement(list(c), n_devices)
        return n_devices / float(c.sum()), pl.makespan, pl.imbalance

    ctl = P.ctl.AdaptiveController(
        tel, swapper, recompose_fn=recompose_fn,
        config=P.ctl.ControllerConfig(slo_seconds=slo, cooldown_seconds=0.0,
                                      min_samples=10),
        service_profile_fn=profile_fn, sync=True)
    carry, per_epoch = np.asarray([]), []
    for e, census in enumerate(epochs):
        sel = swapper.active_selector.copy()
        r = P.sim.simulate(list(costs[sel.astype(bool)]), P.sim.SimConfig(
            n_patients=census, n_devices=n_devices, window_seconds=window_s,
            duration_seconds=epoch_s, seed=seed + 17 * e,
            carry_backlog=True), backlog=carry)
        t0 = e * epoch_s
        for q in r.queries:
            if q.t_window >= 0:                # carried arrivals counted
                tel.record_arrival(t0 + q.t_window)
            tel.record_served(q.latency, t0 + min(q.t_done, epoch_s))
        for age in r.backlog:
            if age <= epoch_s:                 # born here, served later
                tel.record_arrival(t0 + epoch_s - age)
        carry = r.backlog
        per_epoch.append((np.flatnonzero(sel).tolist(), r.p(99),
                          len(r.queries), len(r.backlog),
                          ctl.step(now=(e + 1) * epoch_s).value))
    return {"actions": [(t, d.value) for t, d in ctl.log],
            "epochs": per_epoch, "n_recomposes": ctl.n_recomposes,
            "warm": state["warm"]}


@pytest.mark.parametrize("exact", [False, True])
def test_closed_loop_identical(exact):
    """Controller + recompose + DES over a census spike: the port's
    action log, per-epoch p99 and served selectors are the reference's."""
    sched = [(2, 16), (2, 48), (2, 16)]
    ref = _closed_loop(LOOP_REF, sched, exact)
    port = _closed_loop(LOOP_PORT, sched, exact)
    assert port["actions"] == ref["actions"]
    assert port["epochs"] == ref["epochs"]
    assert port["n_recomposes"] == ref["n_recomposes"] >= 1
    np.testing.assert_array_equal(port["warm"].b_star, ref["warm"].b_star)
    kinds = {d for _, d in port["actions"]}
    assert {"shed", "recompose"} <= kinds, port["actions"]
    # epoch-edge conservation: born = served + carried out - carried in
    born = sum(s + b for _, _, s, b, _ in port["epochs"]) \
        - sum(b for _, _, _, b, _ in port["epochs"][:-1])
    assert born == sum(s for _, _, s, _, _ in port["epochs"]) \
        + port["epochs"][-1][3]
