"""The port's zoo builder (``repro_torch/benchmarks/zoo_setup.py``)
against the reference's ``small_zoo`` fixture (``tests/conftest.py``).

The port's ``build_zoo`` restores the committed members of the fixture's
tag from ``results/zoo_cache/`` (read only), scores them on the CPU and
measures its own serving costs into a cache of its own (``tmp_path``
here).  Profiles equal the reference's; validation scores and AUCs agree
within the one tolerance of ``repro_torch.testing``; the profilers
follow.  A build with a tag nothing has cached trains, saves to the
port's cache, and restores bitwise on the next call.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.benchmarks import zoo_setup
from repro_torch.core.profiles import SystemConfig as TSystemConfig
from repro_torch.models.convert import load_zoo_npz
from repro_torch.models.ecg_resnext import leaves
from repro_torch.testing import assert_bitwise, assert_close

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
COMMITTED = ROOT / "results" / "zoo_cache"
TAG = "r1_p12_c6_s3_t60_seed0"
KW = dict(n_patients=12, clips=6, steps=60, seconds=3, verbose=False)


def _snapshot():
    """name -> (size, mtime_ns) of every file of the committed cache."""
    return {p.name: (p.stat().st_size, p.stat().st_mtime_ns)
            for p in sorted(COMMITTED.iterdir())}


@pytest.fixture(scope="module")
def built(small_zoo, tmp_path_factory):
    """The reference's fixture first (it rewrites its own metadata file
    on every call), then the port's build around a snapshot of the
    committed cache."""
    cache = tmp_path_factory.mktemp("zoo_cache_torch")
    before = _snapshot()
    zoo, extras = zoo_setup.build_zoo(cache=cache, device="cpu", **KW)
    after = _snapshot()
    return zoo, extras, cache, before, after


def test_restores_the_committed_members(built):
    zoo, extras, cache, _, _ = built
    assert extras["trained"] == {}
    assert len(zoo) == 12
    for spec in extras["specs"]:
        want = load_zoo_npz(str(COMMITTED / f"{TAG}_{spec.name}.npz"))
        got = extras["params"][spec.name]
        for a, b in zip(leaves(got), leaves(want)):
            assert_bitwise(a, b, spec.name)
    assert not list(cache.glob("*.npz"))        # nothing trained or saved


def test_profiles_equal_the_reference(built, small_zoo):
    zoo, _, _, _, _ = built
    ref, _ = small_zoo
    for p, r in zip(zoo.profiles, ref.profiles):
        assert (p.name, p.depth, p.width, p.macs, p.memory_bytes,
                p.modality, p.input_len) == (
            r.name, r.depth, r.width, r.macs, r.memory_bytes, r.modality,
            r.input_len)
    assert_bitwise(zoo.val_labels, ref.val_labels)


def test_val_scores_and_aucs_match_the_reference(built, small_zoo):
    zoo, extras, _, _, _ = built
    ref, ref_extras = small_zoo
    assert_close(zoo.val_scores, ref.val_scores, "val scores")
    assert_close(np.array([p.val_auc for p in zoo.profiles]),
                 np.array([p.val_auc for p in ref.profiles]), "val AUCs")
    assert_close(extras["vitals_scores"], ref_extras["vitals_scores"])
    assert_close(extras["labs_scores"], ref_extras["labs_scores"])
    for k in ("train", "val"):
        for name, arr in ref_extras[k].items():
            assert_bitwise(extras[k][name], arr, f"{k} {name}")


def test_costs_and_metadata_are_the_ports_own(built):
    zoo, extras, cache, _, _ = built
    costs = json.loads((cache / f"costs_{TAG}_cpu.json").read_text())
    assert [costs[s.name] for s in extras["specs"]] == \
        extras["measured_costs"]
    assert all(c > 0 for c in extras["measured_costs"])
    meta = json.loads((cache / f"zoo_{TAG}.json").read_text())
    assert meta["aucs"] == [p.val_auc for p in zoo.profiles]


def test_committed_cache_is_left_as_it_was(built):
    """Names, sizes and mtimes of every file of ``results/zoo_cache/``
    before and after the port's build.  The reference's own metadata
    files ``zoo_*.json`` are held by name and size only: the reference's
    ``build_zoo`` rewrites them (same bytes) on every call, and other
    test files call it in parallel workers."""
    _, _, _, before, after = built
    assert set(before) == set(after)
    for name in before:
        if name.startswith("zoo_") and name.endswith(".json"):
            assert before[name][0] == after[name][0], name
        else:
            assert before[name] == after[name], name


def test_a_second_build_reads_the_ports_cache(built, monkeypatch):
    zoo, extras, cache, _, _ = built

    def no_measure(*a, **k):
        raise AssertionError("costs measured again")
    monkeypatch.setattr(zoo_setup.EnsembleService, "measured_costs",
                        no_measure)
    zoo2, extras2 = zoo_setup.build_zoo(cache=cache, device="cpu", **KW)
    assert extras2["measured_costs"] == extras["measured_costs"]
    assert_bitwise(zoo2.val_scores, zoo.val_scores)


def test_trains_saves_and_restores_an_uncached_tag(tmp_path):
    kw = dict(n_patients=6, clips=2, seconds=1, steps=3, widths=(8,),
              blocks=(2,), verbose=False, cache=tmp_path, device="cpu")
    tag = zoo_setup.zoo_tag(True, 6, 2, 1, 3, 0, (8,), (2,))
    assert not list(COMMITTED.glob(f"{tag}_*"))
    zoo, extras = zoo_setup.build_zoo(**kw)
    names = [s.name for s in extras["specs"]]
    assert sorted(extras["trained"]) == sorted(names) and len(names) == 3
    assert sorted(p.name for p in tmp_path.glob("*.npz")) == sorted(
        f"{tag}_{n}.npz" for n in names)
    zoo2, extras2 = zoo_setup.build_zoo(**kw)
    assert extras2["trained"] == {}
    for n in names:
        for a, b in zip(leaves(extras2["params"][n]),
                        leaves(extras["params"][n])):
            assert_bitwise(a, b, n)
    assert_bitwise(zoo2.val_scores, zoo.val_scores)


def test_profilers_budget_and_single_model_stats_follow(built, small_zoo):
    """On the reference's costs (the port measures its own), the port's
    profilers, budget and single-model stats equal the reference's."""
    from benchmarks import zoo_setup as jzoo_setup    # small_zoo's path
    from repro.core.profiles import SystemConfig as JSystemConfig

    zoo, extras, _, _, _ = built
    ref, ref_extras = small_zoo
    extras = dict(extras, measured_costs=ref_extras["measured_costs"])
    t_fa, t_fl = zoo_setup.make_profilers(zoo, TSystemConfig(), extras)
    j_fa, j_fl = jzoo_setup.make_profilers(ref, JSystemConfig(), ref_extras)
    rng = np.random.default_rng(0)
    for b in [np.ones(12, np.int8), np.zeros(12, np.int8)] + [
            rng.integers(0, 2, 12).astype(np.int8) for _ in range(6)]:
        assert_close(t_fa(b), j_fa(b), str(b))
        assert t_fl(b) == pytest.approx(j_fl(b), rel=1e-12), str(b)
    assert zoo_setup.binding_budget(zoo, t_fl) == pytest.approx(
        jzoo_setup.binding_budget(ref, j_fl), rel=1e-12)
    t_acc, t_lat = zoo_setup.single_model_stats(zoo, t_fa, t_fl)
    j_acc, j_lat = jzoo_setup.single_model_stats(ref, j_fa, j_fl)
    assert_close(t_acc, j_acc)
    np.testing.assert_allclose(t_lat, j_lat, rtol=1e-12)
