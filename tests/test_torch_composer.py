"""The port's offline composition (``repro_torch/core``) against the JAX
package's, on the CPU.

Everything here is numpy arithmetic in the reference's order, drawing
from ``numpy.random.Generator`` where the reference draws, so every
comparison is IDENTICAL (no tolerance): ``compose`` and ``recompose``
(every ``ComposerResult`` field but ``wall_seconds``), Algorithm 2's
``explore`` and its operators, the surrogate pair, the objectives, the
four baselines, Eq. 5 and the paper's metrics, and the profile
matrices — on the seeded testbed of ``tests/test_composer.py``.
"""
import numpy as np
import pytest

from repro.core import bagging as jbag
from repro.core import baselines as jbase
from repro.core import composer as jcomp
from repro.core import genetic as jgen
from repro.core import objective as jobj
from repro.core import profiles as jprof
from repro.core import surrogate as jsur
from repro_torch.core import bagging as tbag
from repro_torch.core import baselines as tbase
from repro_torch.core import composer as tcomp
from repro_torch.core import genetic as tgen
from repro_torch.core import objective as tobj
from repro_torch.core import profiles as tprof
from repro_torch.core import surrogate as tsur

from test_composer import make_testbed


def assert_same_result(a, b):
    """Every ``ComposerResult`` field but ``wall_seconds``, identical."""
    np.testing.assert_array_equal(a.b_star, b.b_star)
    assert a.b_star.dtype == b.b_star.dtype
    assert (a.accuracy, a.latency, a.feasible, a.n_profiler_calls) \
        == (b.accuracy, b.latency, b.feasible, b.n_profiler_calls)
    for f in ("B", "Y_acc", "Y_lat"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.history == b.history


# ------------------------------------------------------------ composer
@pytest.mark.parametrize("seed,budget,warm,heldout", [
    (0, 0.15, False, False), (1, 0.2, True, False),
    (2, 0.1, False, True), (3, 1e-6, False, False)])
def test_compose_identical(seed, budget, warm, heldout):
    n, f_a, f_l, lat, *_ = make_testbed(seed=seed)
    prm = dict(N=5, M=60, K=4, N0=8, seed=seed)
    kw = {}
    if warm:
        kw["warm_start"] = [np.eye(n, dtype=np.int8)[i] for i in (0, 3)]
    if heldout:
        rng = np.random.default_rng(seed)
        held = (rng.uniform(size=(20, n)) < 0.3).astype(np.int8)
        kw.update(heldout_B=held,
                  heldout_acc=np.asarray([f_a(b) for b in held]),
                  heldout_lat=np.asarray([f_l(b) for b in held]))
    ref = jcomp.compose(n, f_a, f_l, budget, jcomp.ComposerParams(**prm),
                        **kw)
    port = tcomp.compose(n, f_a, f_l, budget, tcomp.ComposerParams(**prm),
                         **kw)
    assert_same_result(ref, port)
    assert port.feasible == (budget > 1e-3)
    if heldout:
        assert all("r2_lat" in h for h in port.history)


@pytest.mark.parametrize("seed", [1, 2])
def test_recompose_warm_start_identical(seed):
    """The online loop's inner search: warm-started from each package's
    own previous result under a doubled load, the same seeds, memo hits
    and answer."""
    n, f_a, f_l, *_ = make_testbed(seed=seed)
    results, calls = [], []
    for comp in (jcomp, tcomp):
        res0 = comp.compose(n, f_a, f_l, 0.2, comp.ComposerParams(
            N=5, M=60, K=4, N0=8, seed=seed))
        n_calls = [0]

        def f_a_counting(b):
            n_calls[0] += 1
            return f_a(b)

        res1 = comp.recompose(f_a_counting, lambda b: 2.0 * f_l(b), 0.2,
                              warm_start=res0,
                              params=comp.ComposerParams(N=3, M=60, K=4,
                                                         N0=8, seed=seed))
        results.append((res0, res1))
        calls.append(n_calls[0])
    assert_same_result(results[0][0], results[1][0])
    assert_same_result(results[0][1], results[1][1])
    assert calls[0] == calls[1] < results[1][1].n_profiler_calls


# ------------------------------------------------------------- genetic
@pytest.mark.parametrize("n,m,S,p,q,seed", [
    (8, 40, 2, 0.8, 0.5, 0), (16, 100, 3, 0.5, 0.2, 1),
    (5, 60, 1, 1.0, 1.0, 2), (30, 10, 4, 0.0, 0.5, 3)])
def test_explore_and_operators_identical(n, m, S, p, q, seed):
    B = (np.random.default_rng(seed).uniform(size=(6, n)) < 0.4
         ).astype(np.int8)
    out = [mod.explore(B, m, S, p, q, np.random.default_rng(seed))
           for mod in (jgen, tgen)]
    np.testing.assert_array_equal(out[0], out[1])
    assert out[1].dtype == np.int8
    ops = []
    for mod in (jgen, tgen):
        rng = np.random.default_rng(seed + 7)
        ops.append((mod.recombination(B[0], B[1], rng),
                    mod.mutation(B[2], S, rng)))
    for a, b in zip(*ops):
        np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------- surrogate
def test_surrogate_pair_identical():
    n, f_a, f_l, *_ = make_testbed(n=12, seed=4)
    rng = np.random.default_rng(4)
    B = (rng.uniform(size=(40, n)) < 0.35).astype(np.int8)
    held = (rng.uniform(size=(15, n)) < 0.35).astype(np.int8)
    ya, yl = (np.asarray([f(b) for b in B]) for f in (f_a, f_l))
    ha, hl = (np.asarray([f(b) for b in held]) for f in (f_a, f_l))
    got = []
    for mod in (jsur, tsur):
        pair = mod.SurrogatePair.from_observations(B, ya, yl, n_trees=10,
                                                   max_depth=6, seed=3)
        got.append((pair.is_fitted, *pair.predict(held),
                    pair.r2(held, ha, hl)))
    assert got[0][0] and got[1][0]
    for a, b in zip(got[0][1:3], got[1][1:3]):
        np.testing.assert_array_equal(a, b)
    assert got[0][3] == got[1][3]
    with pytest.raises(RuntimeError):
        tsur.SurrogatePair().predict(held)


# ---------------------------------------------------------- objectives
@pytest.mark.parametrize("x", [-2.0, -1e-9, 0.0, 0.3, 5.0])
def test_objectives_identical(x):
    assert tobj.hard_delta(x) == jobj.hard_delta(x)
    assert tobj.soft_delta(3.0)(x) == jobj.soft_delta(3.0)(x)
    for acc, lat in ((0.8, 0.1), (0.9, 0.3), (0.5, 0.2)):
        for kind in ("LatencyConstrainedObjective",
                     "AccuracyConstrainedObjective"):
            a = getattr(jobj, kind)(0.2 + x / 10)
            b = getattr(tobj, kind)(0.2 + x / 10)
            assert a(acc, lat) == b(acc, lat)
            arg = lat if kind.startswith("Latency") else acc
            assert a.feasible(arg) == b.feasible(arg)


# ----------------------------------------------------------- baselines
@pytest.mark.parametrize("seed", [0, 1])
def test_baselines_identical(seed):
    """RD, AF, LF and NPO (warm-started from the three greedy answers,
    as the paper's harness does) give identical results."""
    n, f_a, f_l, lat, *_ = make_testbed(n=14, seed=seed)
    budget = 0.18
    single = np.asarray([f_a(np.eye(n, dtype=np.int8)[i])
                         for i in range(n)])
    runs = []
    for mod in (jbase, tbase):
        rd = mod.random_baseline(n, f_a, f_l, budget, seed=seed)
        af = mod.accuracy_first(n, f_a, f_l, budget, single)
        lf = mod.latency_first(n, f_a, f_l, budget, lat)
        nr = mod.npo(n, f_a, f_l, budget,
                     max_subset=max(1, int(lf.b_star.sum())), n_calls=30,
                     seed=seed, warm_start=[r.b_star for r in (rd, af, lf)])
        runs.append((rd, af, lf, nr))
    for a, b in zip(*runs):
        assert_same_result(a, b)
    assert isinstance(runs[1][0], tcomp.ComposerResult)


# ------------------------------------------------------ Eq. 5, metrics
@pytest.mark.parametrize("seed,ties", [(0, False), (1, True), (2, True),
                                       (3, False)])
def test_bagging_and_metrics_identical(seed, ties):
    rng = np.random.default_rng(seed)
    scores = rng.uniform(size=(7, 90))
    if ties:                                  # ranks averaged over ties
        scores = np.round(scores, 1)
    y = rng.integers(0, 2, 90)
    for b in (rng.integers(0, 2, 7), np.zeros(7, np.int8), np.ones(7)):
        pa = jbag.bagging_predict(scores, b)
        pb = tbag.bagging_predict(scores, b)
        np.testing.assert_array_equal(pa, pb)
        assert jbag.all_metrics(y, pa) == tbag.all_metrics(y, pb)
        for fn in ("roc_auc", "pr_auc", "f1_score", "accuracy"):
            assert getattr(jbag, fn)(y, pa) == getattr(tbag, fn)(y, pb)
    assert tbag.roc_auc(np.ones(4), scores[0, :4]) == 0.5   # one class
    assert tbag.pr_auc(np.zeros(4), scores[0, :4]) == 0.0


# ------------------------------------------------------------ profiles
def test_profiles_identical():
    rng = np.random.default_rng(0)
    rows = [dict(name=f"m{i}", depth=2 + i, width=8 * (i + 1),
                 macs=float(rng.uniform(1e6, 1e9)),
                 memory_bytes=float(rng.uniform(1e5, 1e7)), modality=i % 3,
                 input_len=7500, val_auc=float(rng.uniform(0.5, 0.9)))
            for i in range(5)]
    scores = rng.uniform(size=(5, 20))
    zoos = [mod.ModelZoo([mod.ModelProfile(**r) for r in rows],
                         val_scores=scores, val_labels=np.arange(20) % 2)
            for mod in (jprof, tprof)]
    np.testing.assert_array_equal(zoos[0].V, zoos[1].V)
    assert zoos[0].names() == zoos[1].names() and len(zoos[1]) == 5
    np.testing.assert_array_equal(jprof.SystemConfig().vector(),
                                  tprof.SystemConfig().vector())
    assert tprof.PROFILE_FIELDS == jprof.PROFILE_FIELDS
