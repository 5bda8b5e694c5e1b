"""The port's per-acuity-tier control (``repro_torch/control/tiers.py``,
``TieredTelemetry``, ``TieredController``) against the JAX package's,
and its tiered serving on the CPU.

* ``TierRegistry`` and ``TieredTelemetry`` (slices, routing, the fleet
  as a derived merge) give the reference's answers, identically;
* ``TieredController`` takes the reference's decisions over the same
  scripted snapshots and rates, step for step, with and without a cost
  model; the shed order stays monotone under any action sequence, the
  critical tier holds while flooring the others restores capacity and
  sheds only when nothing else can;
* the tiered DES conserves queries per tier under churn, escalation and
  the epoch-edge carry;
* ``TieredEnsemble`` over CPU lanes: one staged service per (selector,
  placement) pair across tiers, pin-aware eviction, and a tiered hot
  swap mid-stream with zero drops, bitwise a cold service's scores.

The reference's per-tier "lanes" are ``swappers`` here
(``TieredEnsemble.swappers``, ``TieredController(telemetry,
swappers)``): "lane" means only ``repro_torch.device.Lane``.
"""
from collections import Counter

import numpy as np
import pytest
import torch

import jax

try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:
    from _hypothesis_shim import given, settings, st

from repro.control import controller as jctl
from repro.control import swap as jswap
from repro.control import telemetry as jtel
from repro.control import tiers as jtiers
from repro_torch.control import controller as tctl
from repro_torch.control import swap as tswap
from repro_torch.control import telemetry as ttel
from repro_torch.control import tiers as ttiers
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import pipeline as tp
from repro_torch.serving import simulator as tsim
from repro_torch.serving.server import EnsembleServer
from repro_torch.testing import assert_bitwise

torch.set_num_threads(1)
TIERS = ttiers.TIER_ORDER
FRACS = {"stable": 0.5, "elevated": 0.3, "critical": 0.2}
COSTS = {"stable": [0.01], "elevated": [0.01, 0.02],
         "critical": [0.01, 0.02, 0.03]}
REF = (jctl, jtel, jswap)
PORT = (tctl, ttel, tswap)


def _sel(n, idx):
    b = np.zeros(n, np.int8)
    b[list(idx)] = 1
    return b


# ---------------------------------------------------- registry, telemetry
def test_registry_identical():
    assert ttiers.TIER_ORDER == jtiers.TIER_ORDER
    traces = []
    for mod in (jtiers, ttiers):
        reg = mod.TierRegistry()
        trace = [reg.tier_of(7), reg.default]
        reg.assign(1, "critical")
        reg.assign(2, "elevated")
        trace += [reg.tier_of(1), reg.escalate(3), reg.escalate(3),
                  reg.escalate(3), reg.escalate(2), reg.census()]
        reg.discharge(3)
        trace += [reg.census(), reg.tier_of(3)]
        with pytest.raises(ValueError):
            reg.assign(1, "nonexistent")
        with pytest.raises(ValueError):
            mod.TierRegistry(tiers=("a", "b"), default="c")
        traces.append(trace)
    assert traces[0] == traces[1]
    assert traces[1][2:6] == ["critical", "elevated", "critical",
                              "critical"]


def _tiered_feed(tel, rng, n=600):
    for k in range(n):
        t = 0.05 * k + float(rng.uniform(-0.3, 0.0))
        p = int(rng.integers(0, 12))
        how = rng.uniform()
        kw = {"tier": TIERS[p % 3]} if how < 0.2 else \
            {"tier": "no-such-tier"} if how < 0.25 else {"patient": p}
        tel.record_arrival(t, **kw)
        kind = rng.uniform()
        if kind < 0.85:
            tel.record_served(float(rng.lognormal(-1.5, 0.8)), t, **kw)
        elif kind < 0.95:
            tel.record_shed(t, **kw)
        else:
            tel.record_failure(t, **kw)


@pytest.mark.parametrize("exact", [True, False])
def test_tiered_telemetry_identical(exact):
    """Per-tier slices (routed by patient, explicit tier, or the default
    for an unknown one) and the fleet merged from them: every snapshot
    identical to the reference's."""
    got = []
    for tel_mod, tiers_mod in ((jtel, jtiers), (ttel, ttiers)):
        reg = tiers_mod.TierRegistry()
        for p in range(12):
            if p % 4:
                reg.assign(p, TIERS[p % 3])
        tel = tel_mod.TieredTelemetry(reg.tier_of, TIERS, slo_seconds=0.4,
                                      window_seconds=20.0,
                                      clock=lambda: 30.0, exact=exact)
        _tiered_feed(tel, np.random.default_rng(5))
        views = [tel.snapshot(), tel.snapshot(now=25.0, since=15.0),
                 tel.snapshot(mu=30.0, ts=0.1)]
        views += [tel.tier_snapshot(t, now=now) for t in TIERS
                  for now in (22.0, 30.0)]
        got.append([tuple(vars(s).values()) for s in views]
                   + [tel.fleet.n_buckets, tel.default_tier])
    assert str(got[0]) == str(got[1])
    assert got[1][0][3] > 0                     # the fleet served some


def test_tiered_fleet_is_the_sum_of_its_slices():
    reg = ttiers.TierRegistry()
    reg.assign(1, "critical")
    tel = ttel.TieredTelemetry(tier_of=reg.tier_of, tiers=TIERS,
                               slo_seconds=0.5, window_seconds=60.0,
                               clock=lambda: 10.0, exact=True)
    tel.record_arrival(1.0, patient=1)            # -> critical
    tel.record_arrival(1.5, patient=99)           # unknown -> stable
    tel.record_arrival(2.0, tier="elevated")      # explicit tier wins
    tel.record_served(0.1, 2.5, patient=1)
    tel.record_served(0.9, 3.0, tier="stable")    # violates
    counts = {t: tel.tier_snapshot(t).n_arrivals for t in TIERS}
    assert counts == {"stable": 1, "elevated": 1, "critical": 1}
    assert tel.tier_snapshot("stable").violation_rate == 1.0
    fleet = tel.snapshot()
    assert (fleet.n_arrivals, fleet.n_served) == (3, 2)
    tel.record_arrival(4.0, tier="no-such-tier")  # default, never lost
    assert tel.tier_snapshot("stable").n_arrivals == 2
    with pytest.raises(ValueError):
        ttel.TieredTelemetry(reg.tier_of, TIERS, default_tier="icu")


# ------------------------------------------------------- the controller
def _ladders(swap_mod, pos=None, n_rungs=3, n=8):
    fam = [_sel(n, range(k + 1)) for k in range(n_rungs)]

    class NoopLadder(swap_mod.SelectorLadder):
        def _activate(self, selector):
            pass

    out = {}
    for i, t in enumerate(TIERS):
        sw = NoopLadder(fam[n_rungs - 1 if pos is None else pos[i]])
        sw.set_ladder(fam)
        out[t] = sw
    return out, fam


class _Scripted:
    """Controller-facing stub: the fleet snapshot and per-tier arrival
    rates are scripted."""

    def __init__(self, tel_mod, rates):
        self.tel_mod = tel_mod
        self.tiers, self.slo = TIERS, 1.0
        self.fleet = None
        self.rates = dict(rates)

    def snapshot(self, **kw):
        return self.fleet

    def tier_snapshot(self, tier, **kw):
        return _snap(self.tel_mod, arrival_rate=self.rates[tier])


def _snap(tel_mod, **kw):
    base = dict(t=0.0, window_seconds=30.0, n_arrivals=100, n_served=100,
                n_shed=0, arrival_rate=2.0, p50=0.1, p99=0.2,
                violation_rate=0.0)
    base.update(kw)
    return tel_mod.TelemetrySnapshot(**base)


COST = np.linspace(0.01, 0.05, 8)


def _cost_fn(s):
    return float(COST[np.asarray(s, bool)].sum())


def _drive(pkg, evidence, rates, pos=None, cost=True, **cfg):
    """Step a ``TieredController`` over scripted (violation, p99, shed)
    evidence; returns its log, rungs after every step and the counts."""
    ctl_mod, tel_mod, swap_mod = pkg
    swappers, _ = _ladders(swap_mod, pos)
    tel = _Scripted(tel_mod, rates)
    ctl = ctl_mod.TieredController(
        tel, swappers, tier_order=TIERS,
        config=ctl_mod.TieredControllerConfig(**{
            "slo_seconds": 1.0, "cooldown_seconds": 0.0, "min_samples": 1,
            **cfg}),
        cost_fn=_cost_fn if cost else None, n_devices=1)
    trace = []
    for k, (viol, p99, shed) in enumerate(evidence):
        tel.fleet = _snap(tel_mod, violation_rate=viol, p99=p99,
                          n_shed=shed)
        acts = ctl.step(now=float(k))
        trace.append(([(d.value, t) for d, t in acts], ctl.rungs(),
                      ctl.monotone()))
    return trace, [(t, tier, d.value) for t, tier, d in ctl.log], \
        ctl.decision_counts()


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("cost,rho_max", [(False, 0.85), (True, 0.5),
                                          (True, 10.0)])
def test_tiered_controller_identical(seed, cost, rho_max):
    rng = np.random.default_rng(seed)
    evidence = [(float(rng.choice([0.0, 0.005, 0.5])),
                 float(rng.choice([0.1, 0.4, 0.7, 3.0])),
                 int(rng.choice([0, 0, 0, 3]))) for _ in range(25)]
    rates = {t: float(r) for t, r in zip(TIERS, rng.uniform(0.5, 30, 3))}
    pos = [int(p) for p in np.sort(rng.integers(0, 3, 3))]
    runs = [_drive(pkg, evidence, rates, pos=pos, cost=cost,
                   rho_max=rho_max) for pkg in (REF, PORT)]
    assert runs[0] == runs[1]
    assert all(mono for _, _, mono in runs[1][0])
    kinds = {d for _, _, d in runs[1][1]}
    assert "shed" in kinds
    if not cost or rho_max > 1:             # a tight budget climbs none
        assert "climb" in kinds


def test_tiered_controller_rejects_mismatches():
    swappers, _ = _ladders(tswap)
    with pytest.raises(ValueError):
        tctl.TieredController(_Scripted(ttel, {}), swappers,
                              tier_order=TIERS,
                              config=tctl.TieredControllerConfig(
                                  slo_seconds=2.0))
    with pytest.raises(ValueError):
        tctl.TieredController(_Scripted(ttel, {}), swappers,
                              tier_order=("stable", "critical"))


@given(st.lists(st.booleans(), min_size=1, max_size=30))
@settings(max_examples=20, deadline=None)
def test_shed_order_monotone_under_any_action_sequence(overloads):
    """Whatever the evidence, a stable bed is never on a richer rung
    than an elevated one, nor an elevated one than a critical one; and
    the critical tier sheds only once the lower tiers are floored."""
    evidence = [(0.5, 1.5, 0) if o else (0.0, 0.1, 0) for o in overloads]
    trace, _, _ = _drive(PORT, evidence, {t: 1.0 for t in TIERS},
                         cost=False)
    for _, rungs, mono in trace:
        pos = [rungs[t] for t in TIERS]
        assert mono and all(p >= 0 for p in pos)
        assert all(a <= b for a, b in zip(pos, pos[1:])), pos
        if rungs["critical"] < 2:
            assert rungs["stable"] == rungs["elevated"] == 0


def test_critical_holds_while_floor_restores_capacity():
    trace, log, _ = _drive(PORT, [(0.9, 3.0, 0)] * 12,
                           {t: 1.0 for t in TIERS}, rho_max=0.5)
    assert trace[-1][1] == {"stable": 0, "elevated": 0, "critical": 2}
    assert all(tier != "critical" for _, tier, _ in log)


def test_critical_sheds_when_no_alternative():
    trace, log, counts = _drive(
        PORT, [(0.9, 3.0, 0)] * 12,
        {"stable": 1.0, "elevated": 1.0, "critical": 40.0}, rho_max=0.5)
    assert trace[-1][1] == {"stable": 0, "elevated": 0, "critical": 0}
    tiers = [tier for _, tier, d in log if d == "shed"]
    first = tiers.index("critical")
    assert "critical" not in tiers[:first] and set(tiers[:first]) == {
        "stable", "elevated"}
    assert counts["critical/shed"] == 2
    # dropping queries is 'no alternative' even without a cost model
    _, log2, _ = _drive(PORT, [(0.0, 0.9, 5)], {t: 1.0 for t in TIERS},
                        pos=[0, 0, 2], cost=False)
    assert (0.0, "critical", "shed") in log2


# ------------------------------------------------------------ tiered DES
@pytest.mark.parametrize("seed,devices,hazard", [(0, 1, 0.0), (7, 2, 0.2),
                                                 (123, 3, 0.4)])
def test_tiered_des_conserves_queries_per_tier(seed, devices, hazard):
    cfg = tsim.SimConfig(window_seconds=5.0, duration_seconds=60.0,
                         census=[(0.0, 6), (20.0, 14), (40.0, 4)],
                         seed=seed, n_devices=devices, tiers=FRACS,
                         escalate_hazard=hazard)
    r = tsim.simulate(COSTS, cfg)
    assert len(r.queries) == len(r.arrivals) > 0
    trail = {}
    for t, p, old, new in r.tier_log:
        trail.setdefault(p, []).append((t, new))
        if old:                                # one step up, never down
            assert list(FRACS).index(new) == list(FRACS).index(old) + 1
    for q in r.queries:
        assert q.n_models == len(COSTS[q.tier]) and q.t_done > q.t_window
        at_birth = [tier for t, tier in trail[q.patient] if t <= q.t_window]
        assert q.tier == at_birth[-1]
    per = Counter(q.tier for q in r.queries)
    assert sum(per.values()) == len(r.queries)
    # the epoch-edge carry keeps each query's tier, and conserves it
    slow = {t: [0.25] for t in FRACS}
    ecfg = tsim.SimConfig(n_patients=24, n_devices=1, window_seconds=5.0,
                          duration_seconds=40.0, seed=seed,
                          carry_backlog=True, tiers=FRACS)
    r1 = tsim.simulate(slow, ecfg)
    born = Counter(q.tier for q in r1.queries) + Counter(r1.backlog_tiers)
    assert sum(born.values()) == len(r1.arrivals) and len(r1.backlog)
    r2 = tsim.simulate({t: [0.02] for t in FRACS}, ecfg,
                       backlog=r1.backlog, backlog_tiers=r1.backlog_tiers)
    carried = [q for q in r2.queries if q.t_window < 0]
    assert len(carried) + sum(1 for a in r2.backlog
                              if a > ecfg.duration_seconds) \
        == len(r1.backlog)
    cin, cout = Counter(r1.backlog_tiers), Counter(q.tier for q in carried)
    assert all(cout[t] <= cin[t] for t in cout)


# --------------------------------------- the tiered ensemble, CPU lanes
@pytest.fixture(scope="module")
def tzoo(zoo_members):
    return [tp.ZooMember(m.spec, params_from_numpy(
        jax.tree.map(np.asarray, m.params))) for m in zoo_members]


def _rungs(n):
    return [_sel(n, [0]), _sel(n, range(0, n, 2)), _sel(n, range(n))]


def _ensemble(tzoo, initial, **kw):
    te = ttiers.TieredEnsemble(tzoo, initial=initial,
                               warmup_batch_sizes=(1,), device="cpu", **kw)
    te.set_ladder(_rungs(len(tzoo)))
    return te


def test_tier_staging_shared_and_eviction(tzoo):
    """T tiers x R rungs stage R services; a tier on another's rung
    serves through the same object; one tier churning through novel
    pairs never evicts another tier's live pair or a rung; a swapper
    unregistered stops pinning its pairs."""
    n = len(tzoo)
    rungs = _rungs(n)
    te = _ensemble(tzoo, dict(zip(TIERS, rungs)))
    assert len(te.staging.staged) == len(rungs)
    assert te.rungs() == {"stable": 0, "elevated": 1, "critical": 2}
    assert te.monotone()
    assert te.swapper_metrics() == {
        t: {"rung": float(i), "n_members": float(rungs[i].sum())}
        for i, t in enumerate(TIERS)}
    te.swapper("stable").climb()
    assert te.swapper("stable").facade.current \
        is te.swapper("elevated").facade.current
    assert len(te.staging.staged) == len(rungs)
    te.swapper("stable").shed()
    crit = te.swapper("critical").facade.current
    elev = te.swapper("elevated").facade.current
    for k in range(1, 4):                       # novel off-ladder pairs
        te.swapper("stable").swap_to(_sel(n, [k, (k + 3) % n]))
        assert te.swapper("critical").facade.current is crit
        assert te.swapper("elevated").facade.current is elev
        staged = {key.split(b"|", 1)[0] for key in te.staging.staged}
        assert all(s.tobytes() in staged for s in rungs)
    assert len(te.staging.staged) == len(rungs) + 1
    assert not te.monotone()                    # stable is off-ladder
    dead = tswap.HotSwapper(tzoo, _sel(n, [3, 5]), staging=te.staging,
                            warmup_batch_sizes=(1,), device="cpu")
    assert len(te.staging.swappers) == 4
    te.staging.unregister(dead)
    assert len(te.staging.swappers) == 3
    te.swapper("stable").swap_to(_sel(n, [4]))  # an eviction pass
    te.swapper("stable").swap_to(rungs[0])
    assert _sel(n, [3, 5]).tobytes() not in {
        k.split(b"|", 1)[0] for k in te.staging.staged}


def test_tiered_hot_swap_zero_drop_mid_stream(tzoo):
    """Shedding one tier and escalating a patient mid-stream drops no
    query; every score is bitwise a cold service's on the selector of
    the tier that served it."""
    n = len(tzoo)
    rungs = _rungs(n)
    te = _ensemble(tzoo, {t: rungs[2] for t in TIERS})
    for p in range(24):
        te.registry.assign(p, TIERS[p % 3])
    served = []

    def handler(batch, tier):
        # the facade's own delegate, with the service it resolved kept
        svc = te.swapper(tier or te.registry.default).facade.current
        out = svc.predict_batch(batch)
        served.append((tier, svc, list(batch), out))
        return out

    srv = EnsembleServer(batch_handler=handler, tier_of=te.tier_of,
                         n_workers=2, max_batch=1, max_wait_ms=0.5).start()
    rng = np.random.default_rng(0)
    windows = [{"ecg": rng.standard_normal((3, 250)).astype(np.float32)}
               for _ in range(24)]
    try:
        for i in range(12):
            assert srv.submit(i, windows[i])
        assert te.swapper("stable").shed()      # a tier swap mid-stream
        te.registry.escalate(0)                 # a stable bed worsens
        for i in range(12, 24):
            assert srv.submit(i, windows[i])
        srv.drain(timeout=30.0)
    finally:
        stats = srv.stop()
    assert not srv.leaked
    assert stats.served == 24 and stats.failed == 0 and len(served) == 24
    assert te.swapper("stable").facade.swap_count == 1 and te.monotone()
    staged = {id(te.swapper("critical").stage(r)): r for r in rungs}
    cold = {r.tobytes(): tp.EnsembleService.for_selector(tzoo, r,
                                                         device="cpu")
            for r in rungs[1:]}
    for tier, svc, batch, out in served:
        sel = staged[id(svc)]
        if tier != "stable":
            np.testing.assert_array_equal(sel, rungs[2])
        assert_bitwise(np.asarray(out), np.asarray(
            cold[sel.tobytes()].predict_batch(batch)))
    w = windows[0]
    assert_bitwise(np.asarray(te.predict(w, "stable")),
                   np.asarray(cold[rungs[1].tobytes()].predict_batch([w])[0]))
    assert te.tier_of(0) == "elevated"
    assert_bitwise(np.asarray(te.predict(w, te.tier_of(0))),
                   np.asarray(cold[rungs[2].tobytes()].predict_batch([w])[0]))
