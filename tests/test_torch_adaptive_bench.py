"""The port's benchmark functions (``repro_torch/benchmarks/
{adaptive_bench,composition}.py``) and ``serve_icu``'s DES report
against the JAX package's, on the CPU.

Everything but the hot swap is numpy in the reference's order, so the
comparisons are IDENTICAL (no tolerance): ``synthetic_testbed``'s zoo,
scores and costs; ``run_adaptive_sim`` (both arms, both telemetry
engines) and ``run_tiered_sim`` over the three schedules of
``tests/test_control.py``, every returned field, including the spike on
which the reference's own acceptance bound fails (ROADMAP §3: the port
must give the reference's numbers); ``run_all_methods``, Table 2 and
Fig. 6 on one zoo and one cost list both packages get; the DES report
beside the reference's ``simulate`` and ``queueing_bound``.
``wallclock_hot_swap`` serves the reference's members (carried across
by ``models/convert.py``) on CPU lanes and drops nothing, as the
reference does on the same members.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from benchmarks import adaptive_bench as jab          # noqa: E402
from benchmarks import composition as jcomp          # noqa: E402
from repro.serving.latency import queueing_bound      # noqa: E402
from repro.serving.simulator import SimConfig, simulate  # noqa: E402
from repro_torch.benchmarks import adaptive_bench as tab  # noqa: E402
from repro_torch.benchmarks import composition as tcomp  # noqa: E402
from repro_torch.examples import serve_icu  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import pipeline as tp  # noqa: E402

torch.set_num_threads(1)

# the schedules of tests/test_control.py: the conservation regression,
# the tiered regression and test_adaptive_beats_static_under_spike
SCHEDULES = {"conserve": [(2, 24), (2, 72), (2, 24)],
             "tiered": [(2, 24), (3, 72), (2, 24)],
             "spike": [(2, 24), (3, 72)]}


def assert_same(a, b, path="out"):
    """Equal structure and values, no tolerance; NaN equals NaN."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
        assert a.dtype == b.dtype, path
    elif isinstance(a, (float, np.floating)):
        assert a == b or (a != a and b != b), f"{path}: {a} != {b}"
    else:
        assert a == b, f"{path}: {a!r} != {b!r}"


def assert_same_result(a, b):
    """Every ``ComposerResult`` field but ``wall_seconds``, identical."""
    for f in ("b_star", "B", "Y_acc", "Y_lat"):
        assert_same(getattr(a, f), getattr(b, f), f)
    assert_same((a.accuracy, a.latency, a.feasible, a.n_profiler_calls),
                (b.accuracy, b.latency, b.feasible, b.n_profiler_calls))
    assert_same(a.history, b.history, "history")


def _testbeds(seed=0, **kw):
    return jab.synthetic_testbed(seed=seed, **kw), \
        tab.synthetic_testbed(seed=seed, **kw)


# ------------------------------------------------------- the testbed
@pytest.mark.parametrize("seed,kw", [(0, {}), (3, dict(n=16, n_val=200)),
                                     (7, dict(cost_lo=0.01,
                                              cost_hi=0.5))])
def test_synthetic_testbed_bitwise(seed, kw):
    (jzoo, jcosts, jf_a), (tzoo, tcosts, tf_a) = _testbeds(seed, **kw)
    assert_same(tzoo.val_scores, jzoo.val_scores)
    assert_same(tzoo.val_labels, jzoo.val_labels)
    assert_same(tcosts, jcosts)
    assert [vars(p) for p in tzoo.profiles] \
        == [vars(p) for p in jzoo.profiles]
    rng = np.random.default_rng(seed)
    for b in (rng.uniform(size=(6, len(tzoo))) < 0.4).astype(np.int8):
        assert tf_a(b) == jf_a(b)
    assert tf_a(np.zeros(len(tzoo), np.int8)) == 0.5


# ------------------------------------------------- the closed loop DES
def _adaptive(mod, zoo, costs, f_a, schedule, adaptive, exact):
    return mod.run_adaptive_sim(zoo=zoo, costs=costs, f_a=f_a, slo=1.0,
                                schedule=schedule, seed=0,
                                adaptive=adaptive, telemetry_exact=exact)


@pytest.mark.parametrize("exact", [False, True], ids=["sketch", "exact"])
@pytest.mark.parametrize("adaptive", [False, True],
                         ids=["static", "adaptive"])
@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_run_adaptive_sim_identical(name, adaptive, exact):
    (jzoo, jcosts, jf_a), (tzoo, tcosts, tf_a) = _testbeds()
    ref = _adaptive(jab, jzoo, jcosts, jf_a, SCHEDULES[name], adaptive,
                    exact)
    port = _adaptive(tab, tzoo, tcosts, tf_a, SCHEDULES[name], adaptive,
                     exact)
    assert_same(port, ref)
    assert port["born_total"] == port["served_total"] \
        + port["final_backlog"]
    assert all(("decision" in r) == adaptive for r in port["epochs"])


def test_spike_reproduces_the_reference_numbers():
    """``test_adaptive_beats_static_under_spike``'s two runs: the port
    gives the reference's numbers, which miss that test's ``<= 1.0``
    bound on the adaptive arm's last epoch (ROADMAP §3: 2.664 s adaptive,
    8.951 s static)."""
    (jzoo, jcosts, jf_a), (tzoo, tcosts, tf_a) = _testbeds()
    out = {}
    for adaptive in (False, True):
        ref = _adaptive(jab, jzoo, jcosts, jf_a, SCHEDULES["spike"],
                        adaptive, False)
        port = _adaptive(tab, tzoo, tcosts, tf_a, SCHEDULES["spike"],
                         adaptive, False)
        assert_same(port, ref)
        out[adaptive] = port
    st, ad = out[False], out[True]
    assert round(st["epochs"][-1]["p99_s"], 3) == 8.951
    assert round(ad["epochs"][-1]["p99_s"], 3) == 2.664
    assert (round(st["violation_rate"], 3),
            round(ad["violation_rate"], 3)) == (0.739, 0.602)
    assert [d for _, d in ad["actions"]].count("shed") == 3


@pytest.mark.parametrize("exact", [False, True], ids=["sketch", "exact"])
@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_run_tiered_sim_identical(name, exact):
    (jzoo, jcosts, jf_a), (tzoo, tcosts, tf_a) = _testbeds()
    kw = dict(slo=1.0, schedule=SCHEDULES[name], seed=0,
              telemetry_exact=exact)
    ref = jab.run_tiered_sim(zoo=jzoo, costs=jcosts, f_a=jf_a, **kw)
    port = tab.run_tiered_sim(zoo=tzoo, costs=tcosts, f_a=tf_a, **kw)
    assert_same(port, ref)
    assert port["per_tier_served_sum"] == port["served_total"]


def test_ladder_from_identical():
    (jzoo, jcosts, jf_a), (tzoo, tcosts, tf_a) = _testbeds()
    from repro.core.composer import ComposerParams as JP, compose as jc
    from repro.core.profiles import SystemConfig as JS
    from repro.serving.latency import LatencyProfiler as JL
    f_l = JL(jzoo, JS(n_devices=2, n_patients=24, window_seconds=10.0),
             cost_fn=lambda i: jcosts[i])
    res = jc(len(jzoo), jf_a, f_l, 1.0, JP(N=6, M=80, K=4, N0=10, seed=0))
    assert_same(tab._ladder_from(res, tcosts), jab._ladder_from(res, jcosts))


# ----------------------------------------------- composition functions
@pytest.fixture(scope="module")
def comp_zoos():
    """One synthetic zoo in both packages, with side scores and one cost
    list both get (the composition functions read ``extras``)."""
    (jzoo, jcosts, _), (tzoo, _, _) = _testbeds(seed=1, n=10, n_val=120)
    rng = np.random.default_rng(5)
    y = jzoo.val_labels
    extras = {"vitals_scores": np.clip(0.5 + 0.3 * (2 * y - 1)
                                       + rng.normal(0, 0.3, len(y)), 0, 1),
              "labs_scores": np.clip(0.5 + 0.2 * (2 * y - 1)
                                     + rng.normal(0, 0.3, len(y)), 0, 1),
              "measured_costs": [float(c) for c in jcosts]}
    return jzoo, tzoo, extras


def test_run_all_methods_identical(comp_zoos):
    jzoo, tzoo, extras = comp_zoos
    jsys = jcomp.SystemConfig(n_devices=2, n_patients=64)
    tsys = tcomp.SystemConfig(n_devices=2, n_patients=64)
    budget = 0.5 * float(np.sum(extras["measured_costs"]))
    ref = jcomp.run_all_methods(jzoo, extras, budget, 0, jsys, n_iters=4)
    port = tcomp.run_all_methods(tzoo, extras, budget, 0, tsys, n_iters=4)
    assert list(port) == list(ref) == ["RD", "AF", "LF", "NPO", "HOLMES"]
    for name in ref:
        assert_same_result(port[name], ref[name])
    for b in (ref["HOLMES"].b_star, ref["LF"].b_star):
        assert_same(tcomp._ensemble_metrics(tzoo, extras, b),
                    jcomp._ensemble_metrics(jzoo, extras, b))


def test_bench_table2_identical(comp_zoos, capsys):
    jzoo, tzoo, extras = comp_zoos
    ref = jcomp.bench_table2(seeds=(0, 1), zoo=jzoo, extras=extras)
    ref_out = capsys.readouterr().out
    port = tcomp.bench_table2(seeds=(0, 1), zoo=tzoo, extras=extras)
    port_out = capsys.readouterr().out
    assert_same(port, ref)
    # the printed table, but for the seconds the run took
    strip = lambda s: [ln for ln in s.splitlines() if "budget" not in ln]
    assert strip(port_out) == strip(ref_out)


def test_bench_fig6_identical(comp_zoos, capsys):
    jzoo, tzoo, extras = comp_zoos
    ref = jcomp.bench_fig6(zoo=jzoo, extras=extras)
    ref_out = capsys.readouterr().out
    port = tcomp.bench_fig6(zoo=tzoo, extras=extras)
    assert_same(port, ref)
    assert capsys.readouterr().out == ref_out


# ------------------------------------------------------ the DES report
@pytest.mark.parametrize("beds,n_devices,minutes", [
    (8, 2, 1.0), (64, 2, 3.0), (192, 1, 2.0)])
def test_des_report_equals_the_reference(beds, n_devices, minutes):
    costs = [0.0073, 0.0121, 0.0049, 0.0188, 0.0095][:2 + n_devices]
    got = serve_icu.des_report(costs, beds, n_devices, minutes)
    r = simulate(costs, SimConfig(n_patients=beds, n_devices=n_devices,
                                  duration_seconds=minutes * 60,
                                  window_seconds=30.0))
    tq = queueing_bound(r.arrivals, n_devices / sum(costs), max(costs))
    assert got["queries"] == len(r.queries) > 0
    assert got["tq_bound_s"] == tq
    assert (got["p50_s"], got["p95_s"], got["max_s"]) \
        == (r.p(50), r.p(95), float(r.latencies().max()))
    assert got["utilization"] == r.utilization
    assert got["max_tq_s"] == float(r.queue_delays().max())
    assert got["sub_second_p95"] == bool(r.p(95) < 1.0)


def test_des_report_shorter_than_a_window():
    got = serve_icu.des_report([0.01, 0.02], 8, 2, 0.25)
    assert got["queries"] == 0 and "p95_s" not in got


# ------------------------------------------------------ the hot swap
@pytest.fixture(scope="module")
def tzoo(zoo_members):
    return [tp.ZooMember(m.spec, params_from_numpy(
        jax.tree.map(np.asarray, m.params))) for m in zoo_members]


@pytest.mark.parametrize("n_swaps", [2, 3])
def test_wallclock_hot_swap_drops_nothing(zoo_members, tzoo, n_swaps):
    kw = dict(n_queries=24, n_swaps=n_swaps, verbose=False)
    ref = jab.wallclock_hot_swap(pool=zoo_members, **kw)
    port = tab.wallclock_hot_swap(pool=tzoo, device="cpu", **kw)
    keys = ("submitted", "served", "dropped", "swaps")
    assert {k: port[k] for k in keys} == {k: ref[k] for k in keys} \
        == {"submitted": 24, "served": 24, "dropped": 0, "swaps": n_swaps}
    staged = port["staged"]
    assert [s["selector"] for s in staged] == [
        list(range(0, len(tzoo), 2)), list(range(1, len(tzoo), 2))]
    # every flush of the call: served ones plus staging's pow2 warm-up
    assert sum(s["service"].dispatch_count for s in staged) \
        == sum(s["flushes"] * s["service"].n_buckets for s in staged)
    assert all(s["warmup_flushes"] == 4 for s in staged)
    assert 0 < sum(s["flushes"] for s in staged) <= 24


def test_wallclock_hot_swap_default_pool_on_cpu():
    out = tab.wallclock_hot_swap(n_queries=12, n_swaps=1, verbose=False,
                                 device="cpu")
    assert (out["served"], out["dropped"], out["swaps"]) == (12, 0, 1)
    assert all(s["service"].device.type == "cpu" for s in out["staged"])
