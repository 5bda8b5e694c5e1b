"""The port's entry points (``repro_torch/examples/{serve_icu,quickstart,
compose_ensemble}.py``) run to their end on the CPU, as a user starts
them with ``--device cpu``: the reduced zoo restored from the committed
``results/zoo_cache/`` members, the port's own costs measured into a
cache at ``tmp_path`` (no test writes under ``results/``).

``serve_icu.main`` with every switch returns each section's numbers:
every bed served by the fused and the ingest flows (the ingest flow's
scores within the port's tolerance of a flush of the same windows),
the scrape's ``holmes_served_total`` equal to the server's count, the
chaos drill's conservation with no leaked thread, the hot swap's zero
dropped, and the tiered and adaptive demos on the DES.  The section
functions are also held on their own: the chaos drill's counted guard,
the DES report against ``simulate`` (``test_torch_adaptive_bench.py``).
"""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.benchmarks import zoo_setup
from repro_torch.examples import compose_ensemble, quickstart, serve_icu
from repro_torch.testing import assert_close

torch.set_num_threads(1)
ALL = ["--device", "cpu", "--beds", "8", "--minutes", "1", "--adaptive",
       "--tiered", "--chaos", "--metrics"]


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """The port's zoo cache, shared by the module (its costs are
    measured once), at a temporary path."""
    return tmp_path_factory.mktemp("zoo_cache_torch")


@pytest.fixture
def at_tmp(cache, tmp_path, monkeypatch):
    monkeypatch.setattr(zoo_setup, "CACHE", cache)
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))


def _results_snapshot():
    """path -> (size, mtime_ns) of every file under ``results/``."""
    return {str(p): (p.stat().st_size, p.stat().st_mtime_ns)
            for p in sorted(zoo_setup.RESULTS.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def served(cache):
    """``serve_icu.main`` with every switch, once for the module: its
    sections' results, the sections it entered in order, and
    ``results/`` before and after."""
    mp = pytest.MonkeyPatch()
    mp.setattr(zoo_setup, "CACHE", cache)
    mp.setattr("tempfile.tempdir", str(cache))
    order = []

    def observe(name):
        order.append(name)
        return contextlib.nullcontext()

    before = _results_snapshot()
    out = serve_icu.main(ALL, observe=observe)
    after = _results_snapshot()
    mp.undo()
    return out, order, (before, after)


def test_serve_icu_runs_every_section_in_the_reference_order(served):
    out, order, _ = served
    assert order == ["compose", "des", "fused", "metrics", "ingest",
                     "chaos", "tiered", "adaptive", "hot_swap"]
    assert set(out) == set(order) | {"service"}
    comp = out["compose"]
    assert 0 < len(comp["selected"]) < 12
    assert comp["latency_s"] <= comp["budget_s"]
    assert out["service"].device.type == "cpu"
    assert out["des"]["queries"] > 0


def test_serve_icu_fused_and_ingest_serve_every_bed(served):
    out, _, _ = served
    svc = out["service"]
    for flow in ("fused", "ingest"):
        f = out[flow]
        assert (f["served"], f["submitted"], f["failed"]) == (8, 8, 0)
        assert f["leaked"] == []
        assert f["zoo_passes"] == f["flushes"] * svc.n_buckets > 0
    ing = out["ingest"]
    assert ing["h2d_bytes_per_query"] < 100          # index triples only
    beds = sorted(ing["scores"])
    assert beds == list(range(8))
    want = svc.predict_batch([{"ecg": ing["windows"][b]} for b in beds])
    assert_close(np.array([ing["scores"][b] for b in beds]),
                 np.array(want), "ingest vs host-window flush")


def test_serve_icu_metrics_scrape_counts_the_server(served):
    out, _, _ = served
    m = out["metrics"]
    assert m["n_series"] > 0
    assert m["served_total"] == out["fused"]["served"] == 8
    assert m["n_spans"] == m["spans_dumped"] == 8
    assert 0.9 < m["coverage"] <= 1.0


def test_serve_icu_chaos_conserves_every_query(served):
    out, _, _ = served
    c = out["chaos"]
    assert c["conservation"] and c["leaked"] == []
    assert c["served"] + c["shed"] == c["submitted"] > 0
    assert c["stalls"] >= 1 and c["failed"] >= 1
    assert c["rejected"] == c["shed"] == sum(c["rejected_by_tier"].values())
    assert [r["kind"] for r in c["recoveries"]] == ["device_restored"]
    n_buckets = out["service"].n_buckets
    assert len(c["passes"]) == n_buckets
    # whole flushes are every bucket's pass; a loss landing mid-flush
    # leaves a prefix of buckets run
    assert c["zoo_passes"] == c["flushes"] * n_buckets
    assert min(c["passes"]) >= c["flushes"]
    assert all(a >= b for a, b in zip(c["passes"], c["passes"][1:]))


def test_serve_icu_control_plane_demos(served):
    out, _, _ = served
    td = out["tiered"]
    assert td["per_tier_served_sum"] == td["served_total"]
    assert [e["census"] for e in td["epochs"]] == [8] * 3 + [24] * 4 \
        + [8] * 3
    ad = out["adaptive"]
    assert ad["schedule"] == [(3, 8), (4, 24), (3, 8)]
    for arm in ("static", "adaptive"):
        r = ad[arm]
        assert r["born_total"] == r["served_total"] + r["final_backlog"]
    swap = out["hot_swap"]
    assert (swap["served"], swap["submitted"], swap["dropped"],
            swap["swaps"]) == (24, 24, 0, 2)
    assert swap["staged"][0]["selector"] == out["compose"]["selected"]


def test_serve_icu_raises_without_cuda_before_any_build(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    built = []
    monkeypatch.setattr(serve_icu, "build_zoo",
                        lambda *a, **k: built.append(1))
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_icu.main(["--beds", "8"])
    assert not built


def test_quickstart_runs_to_its_end(at_tmp):
    out = quickstart.main(["--device", "cpu"])
    assert out["chosen"] and out["latency_s"] <= out["budget_s"]
    assert len(out["records"]) == 6
    scores = np.array([r.score for r in out["records"]])
    assert np.all((scores >= 0) & (scores <= 1))
    assert out["p95_s"] > 0


def test_compose_ensemble_runs_to_its_end(at_tmp):
    out = compose_ensemble.main(["--device", "cpu"])
    assert list(out["table2"]) == ["RD", "AF", "LF", "NPO", "HOLMES"]
    assert {"NPO", "HOLMES"} <= set(out["fig6"])
    dual = out["dual"]
    assert dual["accuracy"] >= dual["floor"] and dual["selector"]


def test_counted_guard_counts_passes_by_bucket():
    """A flush calls the guard before each bucket pass; a raise ends the
    flush, and that thread's next call starts a new one."""
    lost = [False]

    def guard(device):
        if lost[0]:
            raise RuntimeError("lost")

    g = serve_icu._CountedGuard(guard, 3)
    for _ in range(3):                      # one whole flush
        g(None)
    g(None)                                 # a flush's first pass
    lost[0] = True
    with pytest.raises(RuntimeError):
        g(None)                             # lost before its second
    with pytest.raises(RuntimeError):
        g(None)                             # a retry, lost at once
    lost[0] = False
    for _ in range(3):                      # the retry, whole
        g(None)
    assert g.passes == [3, 2, 2]


def test_serve_icu_writes_nothing_under_results(served, cache):
    """The members come from the committed cache (read only); the costs
    the port measured and its metadata went to the cache it was given."""
    _, _, (before, after) = served
    assert after == before
    assert (cache / "costs_r1_p16_c8_s3_t120_seed0_cpu.json").exists()
    assert not list(cache.glob("*.npz"))          # nothing trained
