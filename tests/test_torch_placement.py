"""The port's placement against the JAX package's, and sharded serving
over lanes held to the unsharded service.

* the planner (``lpt_placement``, ``grouped_lpt_placement``,
  ``plan_pod_ensemble``, ``finish_imbalance``, signatures) gives
  IDENTICAL outputs to the JAX package's for seeded cost vectors, and
  its properties (mirrored from ``test_placement_serving.py``) hold;
* a placement over 1, 2, 4 and 8 CPU lanes serves bitwise what the
  unsharded service serves, on the host-pack, refs and legacy paths,
  and within the tolerance of the JAX unsharded service;
* pinning, byte counts, refusals, the per-shard retire EWMAs, the slot
  engine's lane groups and ``ensemble_serve``.

The JAX side runs unsharded on its one CPU device: the reference proves
sharded equals unsharded itself, so the port is held to its unsharded
service.
"""
import time

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:
    from _hypothesis_shim import given, settings, st

import jax

from repro.launch import ensemble_parallel as jep
from repro.launch.mesh import make_host_mesh
from repro.serving import aggregator as ja
from repro.serving import pipeline as jp
from repro.serving import placement as jpl
from repro_torch.configs.ecg_zoo import bucket_zoo
from repro_torch.device import Lane, as_lanes, device_lanes, lanes
from repro_torch.launch.ensemble_parallel import (ensemble_serve,
                                                  stack_members)
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import aggregator as ta
from repro_torch.serving import pipeline as tp
from repro_torch.serving.placement import (Placement, finish_imbalance,
                                           grouped_lpt_placement,
                                           lpt_placement,
                                           placement_signature,
                                           plan_pod_ensemble)
from repro_torch.serving.slots import SlotEngine
from repro_torch.testing import assert_bitwise, assert_close

torch.set_num_threads(1)
L = 250


# ------------------------------------------------ the planner vs JAX
def _costs(case, k, seed):
    rng = np.random.default_rng(1000 * k + seed)
    n = int(rng.integers(1, 25))
    if case == "duplicates":
        return [float(c) for c in rng.choice([0.25, 0.5, 1.0], n)], None
    costs = [float(c) for c in rng.uniform(0.001, 1.0, n)]
    if case == "uniform_speeds":
        return costs, [2.0] * k
    if case == "mixed_speeds":
        return costs, [float(s) for s in rng.choice([0.5, 1.0, 2.0, 4.0],
                                                    k)]
    return costs, None


def _same_plan(got, want):
    assert got.assignment == want.assignment
    assert got.loads == want.loads
    assert got.speeds == want.speeds
    assert got.signature() == want.signature()
    assert got.finish_times == want.finish_times
    assert got.makespan == want.makespan
    assert got.imbalance == want.imbalance
    assert (got.n_slots, got.n_members) == (want.n_slots, want.n_members)


@pytest.mark.parametrize("case", ["distinct", "duplicates",
                                  "uniform_speeds", "mixed_speeds"])
@pytest.mark.parametrize("k", range(1, 9))
def test_planner_identical_to_jax(k, case):
    """Assignments, loads, speeds, signature bytes and every derived
    quantity, tie-breaks included, for three seeds of each case."""
    for seed in range(3):
        costs, speeds = _costs(case, k, seed)
        _same_plan(lpt_placement(costs, k, speeds=speeds),
                   jpl.lpt_placement(costs, k, speeds=speeds))
        groups = [list(range(3 * g, 3 * g + 1 + g % 3))
                  for g in range(len(costs))]
        _same_plan(grouped_lpt_placement(groups, costs, k, speeds=speeds),
                   jpl.grouped_lpt_placement(groups, costs, k,
                                             speeds=speeds))
        named = {f"m{i}": c for i, c in enumerate(costs)}
        assert plan_pod_ensemble(named, k) \
            == jpl.plan_pod_ensemble(named, k)
        ft = [c / (1 + i % 3) for i, c in enumerate(costs)]
        assert finish_imbalance(ft) == jpl.finish_imbalance(ft)
    assert placement_signature(None) == jpl.placement_signature(None)


def test_plan_placement_from_costs_identical_to_jax(zoo_members):
    """``EnsembleService.plan_placement`` over given bucket costs: the
    same groups, so the same member plan as the JAX service's."""
    jsvc = jp.EnsembleService(zoo_members)
    tsvc = tp.EnsembleService(_port(zoo_members), device="cpu")
    costs = [0.3, 0.1, 0.4, 0.2]
    for k, speeds in ((1, None), (2, None), (3, [1.0, 2.0, 0.5]),
                      (8, None)):
        _same_plan(tsvc.plan_placement(k, bucket_costs=costs,
                                       speeds=speeds),
                   jsvc.plan_placement(k, bucket_costs=costs,
                                       speeds=speeds))


# ---------------------------------------- LPT properties (reference's)
@given(st.lists(st.floats(0.001, 1.0), min_size=1, max_size=24),
       st.integers(1, 8))
@settings(max_examples=40, deadline=None)
def test_lpt_conserves_members_and_loads(costs, k):
    pl = lpt_placement(costs, k)
    placed = sorted(i for slot in pl.assignment for i in slot)
    assert placed == list(range(len(costs)))
    for slot, load in zip(pl.assignment, pl.loads):
        assert load == pytest.approx(sum(costs[i] for i in slot))
    assert sum(pl.loads) == pytest.approx(sum(costs))


@given(st.lists(st.floats(0.001, 1.0), min_size=1, max_size=24),
       st.integers(1, 8))
@settings(max_examples=40, deadline=None)
def test_lpt_makespan_invariants(costs, k):
    pl = lpt_placement(costs, k)
    assert pl.imbalance >= 1.0 - 1e-12
    assert pl.makespan <= sum(costs) + 1e-9
    assert pl.makespan >= max(max(costs), sum(costs) / k) - 1e-9


@given(st.lists(st.floats(0.001, 1.0), min_size=1, max_size=16))
@settings(max_examples=25, deadline=None)
def test_lpt_makespan_monotone_in_device_count(costs):
    spans = [lpt_placement(costs, k).makespan for k in range(1, 9)]
    assert spans[0] == pytest.approx(sum(costs))
    for a, b in zip(spans, spans[1:]):
        assert b <= a + 1e-9


@given(st.integers(1, 12), st.integers(1, 8), st.floats(0.001, 1.0))
@settings(max_examples=25, deadline=None)
def test_lpt_stable_under_duplicate_costs(n, k, c):
    costs = [c] * n
    p1, p2 = lpt_placement(costs, k), lpt_placement(costs, k)
    assert p1.assignment == p2.assignment
    assert p1.signature() == p2.signature()
    sizes = sorted(len(s) for s in p1.assignment)
    assert sizes[-1] - sizes[0] <= 1


@given(st.lists(st.floats(0.01, 1.0), min_size=1, max_size=8),
       st.integers(1, 6), st.integers(1, 4))
@settings(max_examples=25, deadline=None)
def test_grouped_lpt_keeps_groups_atomic(group_costs, k, group_size):
    groups = [list(range(g * group_size, (g + 1) * group_size))
              for g in range(len(group_costs))]
    pl = grouped_lpt_placement(groups, group_costs, k)
    placed = sorted(m for slot in pl.assignment for m in slot)
    assert placed == list(range(len(group_costs) * group_size))
    for g in groups:
        owners = {i for i, slot in enumerate(pl.assignment)
                  if set(g) & set(slot)}
        assert len(owners) == 1
    assert pl.makespan <= sum(group_costs) + 1e-9


@given(st.lists(st.floats(0.01, 1.0), min_size=1, max_size=10),
       st.integers(1, 8))
@settings(max_examples=25, deadline=None)
def test_plan_pod_ensemble_assigns_every_member(costs, k):
    member_costs = {f"m{i}": c for i, c in enumerate(costs)}
    out = plan_pod_ensemble(member_costs, k)
    assert sorted(out) == sorted(member_costs)
    assert set(out.values()) <= set(range(max(1, k)))


SPEED_GRID = (0.5, 1.0, 2.0, 4.0)


@given(st.lists(st.floats(0.001, 1.0), min_size=1, max_size=16),
       st.integers(1, 8), st.floats(0.25, 4.0))
@settings(max_examples=40, deadline=None)
def test_speed_lpt_uniform_speeds_reduce_bitwise(costs, k, s):
    blind = lpt_placement(costs, k)
    for sp in ([1.0] * max(1, k), [s] * max(1, k)):
        pl = lpt_placement(costs, k, speeds=sp)
        assert (pl.assignment, pl.loads) == (blind.assignment, blind.loads)
        assert pl.signature() == blind.signature()
    assert blind.speeds is None and blind.finish_times == blind.loads


@given(st.lists(st.floats(0.001, 1.0), min_size=1, max_size=12),
       st.integers(2, 6),
       st.lists(st.sampled_from(SPEED_GRID), min_size=6, max_size=6),
       st.integers(0, 5), st.sampled_from((2.0, 4.0, 8.0)))
@settings(max_examples=60, deadline=None)
def test_speed_lpt_makespan_monotone_in_speedup(costs, k, speeds6,
                                                which, factor):
    sp = speeds6[:k]
    base = lpt_placement(costs, k, speeds=sp).makespan
    up = list(sp)
    up[which % k] *= factor
    assert lpt_placement(costs, k, speeds=up).makespan <= base + 1e-9


@given(st.lists(st.floats(0.001, 1.0), min_size=1, max_size=12),
       st.integers(1, 6),
       st.lists(st.sampled_from(SPEED_GRID), min_size=7, max_size=7))
@settings(max_examples=60, deadline=None)
def test_speed_lpt_makespan_monotone_in_added_device(costs, k, speeds7):
    sp = speeds7[:k]
    base = lpt_placement(costs, k, speeds=sp).makespan
    grown = lpt_placement(costs, k + 1, speeds=sp + [speeds7[k]])
    assert grown.makespan <= base + 1e-9


def test_speed_lpt_puts_heavy_work_on_fast_devices():
    costs, speeds = [4.0, 1.0, 1.0, 1.0, 1.0], [1.0, 4.0]
    aware = lpt_placement(costs, 2, speeds=speeds)
    assert 0 in aware.assignment[1]
    blind = lpt_placement(costs, 2)
    blind_true = Placement(assignment=blind.assignment,
                           loads=blind.loads, speeds=speeds)
    assert aware.makespan < blind_true.makespan - 1e-9


def test_speed_lpt_rejects_bad_speed_vectors():
    with pytest.raises(ValueError):
        lpt_placement([1.0, 2.0], 2, speeds=[1.0])
    with pytest.raises(ValueError):
        lpt_placement([1.0, 2.0], 2, speeds=[1.0, 0.0])
    with pytest.raises(ValueError):
        Placement(assignment=[[0], [1]], loads=[1.0, 1.0],
                  speeds=[1.0, -2.0])


def test_imbalance_and_signature_rules():
    stranded = Placement(assignment=[[0, 1], []], loads=[3.0, 0.0])
    assert stranded.imbalance == pytest.approx(2.0)
    assert Placement(assignment=[[]], loads=[0.0]).imbalance == 0.0
    pl = Placement(assignment=[[0], [1]], loads=[1.0, 1.0],
                   speeds=[1.0, 4.0])
    assert pl.imbalance == pytest.approx(1.6)
    assert finish_imbalance([1.0, 0.0, 0.0, 0.0]) == pytest.approx(4.0)
    assert finish_imbalance([]) == 0.0
    a = Placement(assignment=[[0, 1], [2]], loads=[2.0, 1.0])
    b = Placement(assignment=[[0], [1, 2]], loads=[1.0, 2.0])
    c = Placement(assignment=[[1, 0], [2]], loads=[2.0, 1.0],
                  speeds=[1.0, 4.0])
    assert a.signature() != b.signature()
    assert a.signature() == c.signature()        # order and speeds aside
    assert placement_signature(None) not in (a.signature(),
                                             b.signature())


# --------------------------------------------------------- the lanes
def test_lanes_have_identity_and_no_fallback(monkeypatch):
    a, b = lanes(2, "cpu")
    assert a != b and a == Lane(0, torch.device("cpu"))
    assert a != torch.device("cpu") and torch.device("cpu") != a
    assert len({a, b, Lane(0, torch.device("cpu"))}) == 2
    assert [a, b].index(Lane(1, torch.device("cpu"))) == 1
    with pytest.raises(TypeError, match="Lane"):
        as_lanes([torch.device("cpu")] * 2)
    with pytest.raises(ValueError, match="distinct"):
        as_lanes([a, a])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            lanes(4)                    # cuda:0 asked for: no fallback
        with pytest.raises(RuntimeError, match="no CUDA device"):
            device_lanes()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert device_lanes() == [Lane(i, torch.device("cuda", i))
                              for i in range(3)]


# ------------------------------------------------- sharded serving
def _port(zoo_members):
    return [tp.ZooMember(m.spec, params_from_numpy(
        jax.tree.map(np.asarray, m.params))) for m in zoo_members]


@pytest.fixture(scope="module")
def tzoo(zoo_members):
    return _port(zoo_members)


def _sel(n, idx):
    b = np.zeros(n, np.int8)
    b[list(idx)] = 1
    return b


def _ladder(n):
    return {"cheap": _sel(n, [0]), "mid": _sel(n, range(0, n, 2)),
            "full": _sel(n, range(n))}


def _bucket_plan(pool, selector, n_lanes, seed=0):
    """Deterministic bucket-aligned plan (synthetic distinct costs:
    correctness must hold for any valid plan)."""
    idx = np.flatnonzero(np.asarray(selector, bool))
    groups = list(bucket_zoo([pool[i].spec for i in idx]).values())
    costs = [float(len(g) + 1 + 0.1 * ((seed + j) % 3))
             for j, g in enumerate(groups)]
    return grouped_lpt_placement(groups, costs, n_lanes)


def _windows(seed, n=5):
    rng = np.random.default_rng(seed)
    return [{"ecg": rng.standard_normal((3, L)).astype(np.float32)}
            for _ in range(n)]


def _refs(pkg, windows, **kw):
    di = pkg.DeviceIngest([pkg.ModalitySpec("ecg", 250.0, 3)],
                          len(windows), 1.0, **kw)
    out = []
    for p, w in enumerate(windows):
        for off, k in ((0, 100), (100, 150)):
            di.ingest(off / 250.0, p, "ecg", w["ecg"][:, off:off + k])
        out.append(di.close_window(p, 1.0))
    return out


def _batch(path, windows):
    return _refs(ta, windows, device="cpu") if path == "refs" else windows


@pytest.fixture(scope="module")
def oracle(tzoo):
    """Unsharded port outputs per (rung, path): the bitwise target."""
    windows = _windows(0)
    out = {}
    for rung, sel in _ladder(len(tzoo)).items():
        for path in ("packed", "refs", "legacy"):
            svc = tp.EnsembleService.for_selector(
                tzoo, sel, device="cpu",
                marshal="legacy" if path == "legacy" else "packed")
            out[rung, path] = (svc.predict_batch(_batch(path, windows)),
                               svc.predict(_batch(path, windows)[0]),
                               svc.h2d_bytes)
    return windows, out


@pytest.mark.parametrize("path", ["packed", "refs", "legacy"])
@pytest.mark.parametrize("rung", ["cheap", "mid", "full"])
@pytest.mark.parametrize("n_lanes", [1, 2, 4, 8])
def test_sharded_equals_unsharded_bitwise(tzoo, oracle, n_lanes, rung,
                                          path):
    """THE acceptance property: every ladder selector, every lane
    count, every path: the sharded service serves exactly the bits
    of the unsharded one."""
    windows, want = oracle
    sel = _ladder(len(tzoo))[rung]
    svc = tp.EnsembleService.for_selector(
        tzoo, sel, placement=_bucket_plan(tzoo, sel, n_lanes),
        devices=lanes(n_lanes, "cpu"),
        marshal="legacy" if path == "legacy" else "packed")
    got = svc.predict_batch(_batch(path, windows))
    assert_bitwise(got, want[rung, path][0], f"{rung} x {n_lanes}")
    assert svc.predict(_batch(path, windows)[0]) == want[rung, path][1]
    # host bytes are counted once per torch.device, not once per lane
    assert svc.h2d_bytes == want[rung, path][2]


@pytest.mark.parametrize("speeds", [(4.0, 2.0, 1.0, 1.0),
                                    (1.0, 1.0, 4.0, 0.5)])
@pytest.mark.parametrize("rung", ["mid", "full"])
def test_sharded_hetero_speeds_bitwise(tzoo, oracle, rung, speeds):
    """Speeds move work, never change math; the aware plan's makespan
    never exceeds the speed-blind plan's under the true speeds."""
    windows, want = oracle
    sel = _ladder(len(tzoo))[rung]
    idx = np.flatnonzero(sel)
    groups = list(bucket_zoo([tzoo[i].spec for i in idx]).values())
    costs = [float(len(g) + 0.25 * j) for j, g in enumerate(groups)]
    pl = grouped_lpt_placement(groups, costs, 4, speeds=list(speeds))
    blind = grouped_lpt_placement(groups, costs, 4)
    assert pl.makespan <= Placement(blind.assignment, blind.loads,
                                    list(speeds)).makespan + 1e-9
    svc = tp.EnsembleService.for_selector(tzoo, sel, placement=pl,
                                          devices=lanes(4, "cpu"))
    assert_bitwise(svc.predict_batch(windows), want[rung, "packed"][0],
                   "speeds")


def test_member_level_split_close_to_oracle(tzoo, oracle):
    """A member-level plan splits buckets (other stacked sizes), so it
    matches to the tolerance only."""
    windows, want = oracle
    pl = lpt_placement(list(range(12, 0, -1)), 3)
    svc = tp.EnsembleService(tzoo, placement=pl, devices=lanes(3, "cpu"))
    assert svc.n_buckets > 4
    assert_close(svc.predict_batch(windows), want["full", "packed"][0],
                 "member split")


@pytest.mark.parametrize("path", ["packed", "refs", "legacy"])
def test_port_sharded_matches_jax_unsharded(zoo_members, tzoo, path):
    windows = _windows(3)
    marshal = "legacy" if path == "legacy" else "packed"
    jsvc = jp.EnsembleService(zoo_members, marshal=marshal)
    sel = np.ones(len(tzoo), np.int8)
    tsvc = tp.EnsembleService(tzoo, placement=_bucket_plan(tzoo, sel, 4),
                              devices=lanes(4, "cpu"), marshal=marshal)
    if path == "refs":
        want = jsvc.predict_batch(_refs(ja, windows))
        got = tsvc.predict_batch(_refs(ta, windows, device="cpu"))
    else:
        want = jsvc.predict_batch(windows)
        got = tsvc.predict_batch(windows)
    assert_close(got, want, path)
    assert tsvc.dispatch_count == jsvc.dispatch_count == 4


def test_shards_pinned_to_their_lanes_in_plan_order(tzoo):
    """Every shard's params live on its lane's device and its lane is
    the plan slot's; the guard sees the lanes in plan order, one pass a
    shard."""
    sel = _ladder(len(tzoo))["full"]
    pl = _bucket_plan(tzoo, sel, 4)
    devs = lanes(4, "cpu")
    svc = tp.EnsembleService(tzoo, placement=pl, devices=devs)
    assert svc.device == torch.device("cpu")     # the lanes' device
    slot_of = {m: d for d, slot in enumerate(pl.assignment) for m in slot}
    for b in svc._buckets:
        assert b.device is devs[slot_of[b.idx[0]]]
        assert b.slot == slot_of[b.idx[0]] and b.tdev == devs[0].device
        for leaf in jax.tree.leaves(b.stacked):
            assert leaf.device == b.device.device
    assert len({b.device for b in svc._buckets}) > 1
    seen = []
    svc.dispatch_guard = seen.append
    d0 = svc.dispatch_count
    svc.predict_batch(_windows(1))
    assert seen == [b.device for b in svc._buckets]
    assert svc.dispatch_count - d0 == svc.n_buckets == 4


def test_refusals(tzoo):
    sel = _ladder(len(tzoo))["full"]
    pl4 = _bucket_plan(tzoo, sel, 4)
    with pytest.raises(ValueError, match="slot 3 but only 2 lane"):
        tp.EnsembleService(tzoo, placement=pl4,
                           devices=lanes(2, "cpu")).predict_batch(
            _windows(1))
    with pytest.raises(ValueError, match="exactly once"):
        tp.EnsembleService(tzoo, device="cpu", placement=Placement(
            [[0, 1], [1]], [1.0, 1.0]))
    with pytest.raises(ValueError, match="fused"):
        tp.EnsembleService(tzoo, device="cpu", fused=False, placement=pl4)
    with pytest.raises(TypeError, match="Lane"):
        tp.EnsembleService(tzoo, placement=pl4,
                           devices=[torch.device("cpu")] * 4)
    if not torch.cuda.is_available():
        # no lanes given: the default is one lane a CUDA card, never a
        # quiet fall back to the CPU
        svc = tp.EnsembleService(tzoo, device="cpu", placement=pl4)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            svc.predict_batch(_windows(1))


# ---------------------------------------------- retire EWMAs per shard
def test_flush_records_shard_retire_ewmas(tzoo):
    sel = _ladder(len(tzoo))["full"]
    svc = tp.EnsembleService(tzoo, placement=_bucket_plan(tzoo, sel, 2),
                             devices=lanes(2, "cpu"))
    svc.warmup(batch_sizes=(8,))
    assert svc.shard_cost_snapshot() == {}
    assert svc.live_bucket_costs() is None
    assert svc.measured_finish_times() is None     # no shard seen yet
    for _ in range(3):
        svc.predict_batch(_windows(1))
    snap = svc.shard_cost_snapshot()
    groups = list(bucket_zoo([m.spec for m in tzoo]).values())
    assert set(snap) == {tuple(sorted(g)) for g in groups}
    assert all(v > 0 for v in snap.values())
    live = svc.live_bucket_costs()
    assert live is not None and len(live) == len(groups)
    fin = svc.measured_finish_times()
    assert len(fin) == 2
    for slot in range(2):
        assert fin[slot] == max(snap[tuple(sorted(b.idx))]
                                for b in svc._buckets if b.slot == slot)
    svc.predict_batch(_windows(2))
    assert len(svc.shard_cost_snapshot()) == len(snap)      # O(1)
    # an unsharded service takes no clock: nothing reads its EWMAs
    flat = tp.EnsembleService(tzoo, device="cpu")
    flat.predict_batch(_windows(1))
    assert flat.shard_cost_snapshot() == {}
    assert flat.live_bucket_costs() is None
    assert flat.measured_finish_times() is None


def test_stall_at_one_lane_drifts_only_its_shards(tzoo):
    """A stall injected at lane 0's guard is that lane's time: its
    shards' EWMAs drift past their baseline, the other lanes' stay put
    (the clock starts before the guard, as the reference's does)."""
    sel = _ladder(len(tzoo))["full"]
    devs = lanes(2, "cpu")
    svc = tp.EnsembleService(tzoo, placement=_bucket_plan(tzoo, sel, 2),
                             devices=devs)
    svc.warmup(batch_sizes=(8,))
    for _ in range(3):
        svc.predict_batch(_windows(1))
    fast = svc.shard_cost_snapshot()
    slow_keys = {tuple(sorted(b.idx)) for b in svc._buckets
                 if b.device == devs[0]}
    assert slow_keys and slow_keys != set(fast)

    # a stall well above the host's jitter under a loaded test run (a
    # baseline flush can run tens of ms slow); the bounds are fractions
    # of the stall
    stall = 0.2

    def guard(lane):
        if lane == devs[0]:
            time.sleep(stall)

    svc.dispatch_guard = guard
    for _ in range(5):
        svc.predict_batch(_windows(1))
    slow = svc.shard_cost_snapshot()
    drift = {k: slow[k] - fast[k] for k in fast}
    assert min(drift[k] for k in slow_keys) > 0.6 * stall
    assert min(drift[k] for k in slow_keys) \
        > max(drift[k] for k in drift if k not in slow_keys) + 0.4 * stall
    fin = svc.measured_finish_times()
    assert fin[0] > fin[1] + 0.6 * stall


def test_plan_placement_measures_at_flush_rung(tzoo):
    """``plan_placement`` measures at ``PLAN_BATCH``: with synthetic
    batch-dependent timings the batch-1 and flush-rung plans flip and
    the default is the flush-rung one; measured costs are real and
    one a bucket."""
    svc = tp.EnsembleService(tzoo, device="cpu")
    n = len(list(bucket_zoo([m.spec for m in tzoo]).values()))
    assert tp.PLAN_BATCH == jp.PLAN_BATCH == 8
    assert tp.RETIRE_ALPHA == jp.RETIRE_ALPHA
    real = svc.measured_bucket_costs(reps=1, batch=2)
    assert len(real) == n and all(c > 0 for c in real)
    fake = {1: [0.4] + [0.1] * (n - 1),
            tp.PLAN_BATCH: [0.1] + [0.4] * (n - 1)}
    asked = []

    def measured(reps=3, batch=1, warmup=1):
        asked.append(batch)
        return list(fake[batch])

    svc.measured_bucket_costs = measured
    plan_default = svc.plan_placement(2)
    plan_flush = svc.plan_placement(2, batch=tp.PLAN_BATCH)
    plan_b1 = svc.plan_placement(2, batch=1)
    assert asked == [tp.PLAN_BATCH, tp.PLAN_BATCH, 1]
    assert plan_b1.signature() != plan_flush.signature()
    assert plan_default.signature() == plan_flush.signature()
    sharded = tp.EnsembleService(tzoo, placement=plan_flush,
                                 devices=lanes(2, "cpu"))
    with pytest.raises(ValueError, match="unsharded"):
        sharded.plan_placement(2)


# -------------------------------------------- slot engine over lanes
def test_slot_engine_over_8_lanes_ticks_bitwise(tzoo):
    """One group a lane the plan uses, each with its own state and
    fold; the ticks read bitwise the UNSHARDED flush oracle, also after
    the census grows."""
    groups = list(bucket_zoo([m.spec for m in tzoo]).values())
    pl = grouped_lpt_placement(groups, [1.0 + 0.1 * j
                                        for j in range(len(groups))], 8)
    devs = lanes(8, "cpu")
    sharded = tp.EnsembleService(tzoo, placement=pl, devices=devs)
    flat = tp.EnsembleService(tzoo, device="cpu")
    di = ta.DeviceIngest([ta.ModalitySpec("ecg", 250.0, 3)], 8, 1.0,
                         device="cpu")
    eng = SlotEngine(sharded, di)
    assert len(eng.groups) == len(groups) > 1
    assert [g.device for g in eng.groups] \
        == list(dict.fromkeys(b.device for b in sharded._buckets))
    rng = np.random.default_rng(5)

    def round_(patients, t0):
        refs = []
        for p in patients:
            di.ingest(t0, p, "ecg",
                      rng.standard_normal((3, L)).astype(np.float32))
            refs.append(di.close_window(p, t0 + 1.0))
        for r in refs:
            eng.update(r)
        return refs

    refs = round_(range(8), 0.0)
    rep = eng.tick()
    assert rep.n_scored == 8 and eng.dispatch_count == sharded.n_buckets
    got = [eng.read(p) for p in range(8)]
    assert_bitwise(got, flat.predict_batch(refs), "8 lanes")
    assert eng.device_scores.shape == (8,)
    eng.ensure_slots(12)                   # every group's state grows
    assert all(g.state.shape[1] == 16 for g in eng.groups)
    refs = round_(range(12), 2.0)
    eng.tick()
    want = flat.predict_batch(refs + [di.close_window(12, 9.0)] * 4)
    assert_bitwise([eng.read(p) for p in range(12)], want[:12],
                   "grown to 12")


# ------------------------------------------------------ ensemble_serve
@pytest.mark.parametrize("n_lanes", [1, 4])
def test_ensemble_serve_equals_bagging(n_lanes):
    d, n_members = 16, 4
    g = torch.Generator().manual_seed(0)
    members = [{"w1": torch.randn(d, d, generator=g) * 0.3,
                "w2": torch.randn(d, 2, generator=g) * 0.3}
               for _ in range(n_members)]
    batch = {"x": torch.randn(8, d, generator=g)}

    def member_apply(p, b):
        return torch.softmax(torch.tanh(b["x"] @ p["w1"]) @ p["w2"], -1)

    want = torch.stack([member_apply(p, batch) for p in members]).mean(0)
    step = ensemble_serve(member_apply, lanes(n_lanes, "cpu"), n_members)
    got = step(stack_members(members), batch)
    assert got.shape == (8, 2)
    assert_close(got, want, "bagging")
    # and the JAX package's step on its host mesh, on the same weights
    mesh = make_host_mesh()
    jstep = jep.ensemble_serve(
        lambda p, b: jax.nn.softmax(jax.numpy.tanh(b["x"] @ p["w1"])
                                    @ p["w2"], axis=-1), mesh, n_members)
    jm = [{k: np.asarray(v) for k, v in p.items()} for p in members]
    with mesh:
        jgot = jax.jit(jstep)(jep.stack_members(jm),
                              {"x": np.asarray(batch["x"])})
    assert_close(got, np.asarray(jgot), "jax")
