"""The port's serving path against the JAX package's, on the same weights.

* per-query scores of ``predict_batch`` in packed, refs and legacy
  modes, with and without the CPU-side vitals and labs models, within
  the one tolerance of ``repro_torch.testing``;
* inside the port: refs equal packed BITWISE at every pow2 rung, fused
  equals ``fused=False`` within tolerance;
* ``StreamingPipeline(device_ingest=True)`` against the JAX pipeline,
  and against the port's own host-aggregator pipeline (bitwise);
* ``EnsembleServer`` serving every submitted query, its counters against
  the JAX server's on the same submissions; the copied obs and tabular
  modules against their originals.
"""
import numpy as np
import pytest
import torch

import jax

from repro.configs.ecg_zoo import zoo_specs
from repro.models import tabular as jtab
from repro.models.ecg_resnext import init_ecg
from repro.obs import sketch as jsketch
from repro.serving import aggregator as ja
from repro.serving import pipeline as jp
from repro.serving import server as jserver
from repro_torch.kernels import conv1d_stripe as kconv
from repro_torch.kernels import window_gather as kgather
from repro_torch.models import tabular as ttab
from repro_torch.models.convert import params_from_numpy
from repro_torch.obs import sketch as tsketch
from repro_torch.serving import aggregator as ta
from repro_torch.serving import pipeline as tp
from repro_torch.serving import server as tserver
from repro_torch.testing import assert_bitwise, assert_close

torch.set_num_threads(1)
L = 250


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


def _windows(rng, n, side=True):
    out = []
    for _ in range(n):
        w = {"ecg": rng.standard_normal((3, L)).astype(np.float32)}
        if side:
            w["vitals"] = rng.standard_normal((7, 1)).astype(np.float32)
            w["labs"] = rng.standard_normal(8).astype(np.float32)
        out.append(w)
    return out


def _refs(pkg, windows, **kw):
    """Stream host windows into a ``pkg.DeviceIngest`` (mixed chunk
    sizes) and close one ref per patient."""
    mods = [pkg.ModalitySpec("ecg", 250.0, 3),
            pkg.ModalitySpec("vitals", 1.0, 7)]
    di = pkg.DeviceIngest(mods, len(windows), 1.0, **kw)
    refs = []
    for p, w in enumerate(windows):
        for off, k in ((0, 100), (100, 64), (164, 86)):
            di.ingest(off / 250.0, p, "ecg", w["ecg"][:, off:off + k])
        if "vitals" in w:
            di.ingest(0.0, p, "vitals", w["vitals"])
        extra = {"labs": w["labs"]} if "labs" in w else {}
        refs.append(di.close_window(p, 1.0, extra=extra))
    return refs


@pytest.mark.parametrize("side", [False, True], ids=["zoo", "zoo+cpu"])
@pytest.mark.parametrize("mode", ["packed", "refs", "legacy"])
def test_scores_match_jax(zoo, side_models, mode, side):
    jm, tm = zoo
    kw = dict(zip(("vitals_model", "labs_model"), side_models)) \
        if side else {}
    marshal = "legacy" if mode == "legacy" else "packed"
    jsvc = jp.EnsembleService(jm, marshal=marshal, **kw)
    tsvc = tp.EnsembleService(tm, marshal=marshal, device="cpu", **kw)
    windows = _windows(np.random.default_rng(1), 3, side)
    if mode == "refs":
        want = jsvc.predict_batch(_refs(ja, windows))
        got = tsvc.predict_batch(_refs(ta, windows, device="cpu"))
    else:
        want = jsvc.predict_batch(windows)
        got = tsvc.predict_batch(windows)
    assert len(got) == 3
    assert_close(got, want, mode)
    assert tsvc.dispatch_count == jsvc.dispatch_count == 2
    assert tsvc.h2d_bytes == jsvc.h2d_bytes


def test_refs_equal_packed_bitwise_every_rung(zoo, side_models):
    _, tm = zoo
    vit, labs = side_models
    svc = tp.EnsembleService(tm, vitals_model=vit, labs_model=labs,
                             device="cpu")
    windows = _windows(np.random.default_rng(2), 8)
    refs = _refs(ta, windows, device="cpu")
    for P in (1, 2, 3, 5, 8):
        assert_bitwise(np.asarray(svc.predict_batch(refs[:P])),
                       np.asarray(svc.predict_batch(windows[:P])), f"P={P}")


def test_short_and_dropout_windows_refs_equal_packed(zoo):
    """Fewer samples than input_len: both paths left-zero-fill."""
    _, tm = zoo
    svc = tp.EnsembleService(tm, device="cpu")
    rng = np.random.default_rng(3)
    windows = [{"ecg": rng.standard_normal((3, n)).astype(np.float32)}
               for n in (40, 120, 249)]
    di = ta.DeviceIngest([ta.ModalitySpec("ecg", 250.0, 3)], 3, 1.0,
                         device="cpu")
    refs = []
    for p, w in enumerate(windows):
        for off in range(0, w["ecg"].shape[-1], 30):
            di.ingest(off / 250.0, p, "ecg", w["ecg"][:, off:off + 30])
        refs.append(di.close_window(p, 1.0))
    assert_bitwise(np.asarray(svc.predict_batch(refs)),
                   np.asarray(svc.predict_batch(windows)))


def test_fused_matches_per_member_oracle(zoo, side_models):
    _, tm = zoo
    vit, labs = side_models
    windows = _windows(np.random.default_rng(4), 3)
    fused = tp.EnsembleService(tm, vitals_model=vit, labs_model=labs,
                               device="cpu")
    unfused = tp.EnsembleService(tm, vitals_model=vit, labs_model=labs,
                                 fused=False, device="cpu")
    want = fused.predict_batch(windows)
    assert_close(unfused.predict_batch(windows), want)
    assert_close(unfused.predict_batch(_refs(ta, windows, device="cpu")),
                 want)
    assert unfused.dispatch_count == 2 * 3 * len(tm)
    costs = unfused.measured_costs(reps=1)
    assert len(costs) == len(tm) and min(costs) > 0
    fused.warmup(batch_sizes=(1, 2))
    unfused.warmup()


def test_stale_ref_refused_by_the_flush(zoo):
    _, tm = zoo
    svc = tp.EnsembleService(tm, device="cpu")
    windows = _windows(np.random.default_rng(5), 1, side=False)
    (ref,) = _refs(ta, windows, device="cpu")
    di = ref.ingest
    assert svc.predict(ref) == svc.predict(windows[0])
    for t in (1.0, 2.0):                         # 500 more > cap 512 - 250
        di.ingest(t, 0, "ecg", np.zeros((3, 250), np.float32))
    with pytest.raises(ValueError, match="stale"):
        svc.predict(ref)
    with pytest.raises(ValueError, match="stale"):
        tp.EnsembleService(tm, fused=False, device="cpu").predict(ref)


def test_refs_reject_legacy_and_mixed_ingest(zoo):
    _, tm = zoo
    windows = _windows(np.random.default_rng(6), 2, side=False)
    a = _refs(ta, windows[:1], device="cpu")
    b = _refs(ta, windows[1:], device="cpu")
    with pytest.raises(ValueError):
        tp.EnsembleService(tm, marshal="legacy", device="cpu") \
            .predict_batch(a)
    with pytest.raises(ValueError):
        tp.EnsembleService(tm, device="cpu").predict_batch(a + b)
    with pytest.raises(ValueError):
        tp.EnsembleService(tm, marshal="nope", device="cpu")


def _full_rate_feed(rng, n_patients=2, n_windows=3, chunk=25, drop=()):
    """Aligned feed (as in tests/test_device_ingest.py): ``chunk``-sample
    ECG bursts every chunk/250 s per patient from t=0, so every window
    closes on its boundary."""
    feed = []
    for j in range(n_windows * (250 // chunk) + 1):
        for p in range(n_patients):
            if (p, j) not in drop:
                feed.append((j * chunk / 250.0, p, "ecg", rng.standard_normal(
                    (3, chunk)).astype(np.float32)))
    return feed


def _drive(pipe, feed):
    return [r.score for r in filter(None, (
        pipe.feed(t, p, m, s) for (t, p, m, s) in feed))]


@pytest.mark.parametrize("drop", [(), ((0, 3), (0, 4), (1, 6))],
                         ids=["full", "dropout"])
def test_streaming_pipeline_matches_jax_and_host_path(zoo, drop):
    jm, tm = zoo
    feed = _full_rate_feed(np.random.default_rng(7), drop=set(drop))
    want = _drive(jp.StreamingPipeline(jp.EnsembleService(jm), 2, 1.0,
                                       device_ingest=True), feed)
    tsvc = tp.EnsembleService(tm, device="cpu")
    dev = tp.StreamingPipeline(tsvc, 2, 1.0, device_ingest=True,
                               device="cpu")
    got = _drive(dev, feed)
    host = _drive(tp.StreamingPipeline(tsvc, 2, 1.0, device="cpu"), feed)
    assert len(got) == len(want) == 2 * 3
    assert_close(got, want)
    assert_bitwise(np.asarray(got), np.asarray(host))
    assert int(dev.device_ingest.fed["ecg"][0]) > \
        dev.device_ingest.states["ecg"].buf.shape[-1]     # the ring wrapped
    assert len(dev.latencies()) == 6


def test_pipeline_labs_side_channel_and_tracing(zoo, side_models):
    _, tm = zoo
    vit, labs = side_models
    svc = tp.EnsembleService(tm, vitals_model=vit, labs_model=labs,
                             device="cpu")
    pipe = tp.StreamingPipeline(svc, 1, 1.0, device_ingest=True,
                                trace_stages=True, device="cpu")
    rng = np.random.default_rng(8)
    pipe.feed(0.0, 0, "labs", rng.standard_normal(8).astype(np.float32))
    recs = _drive(pipe, [(j * 0.1, 0, "ecg", rng.standard_normal(
        (3, 25)).astype(np.float32)) for j in range(11)]
        + [(1.05, 0, "vitals", np.zeros((7, 1), np.float32))])
    assert len(recs) == 1 and 0.0 <= recs[0] <= 1.0
    assert set(pipe.records[0].stages) >= {"marshal", "dispatch",
                                           "gather"}


def test_server_serves_every_query(zoo):
    _, tm = zoo
    svc = tp.EnsembleService(tm, device="cpu")
    windows = _windows(np.random.default_rng(9), 6, side=False)
    refs = _refs(ta, windows, device="cpu")
    srv = tserver.EnsembleServer(batch_handler=svc.predict_batch,
                                 n_workers=2, max_batch=4).start()
    for p, r in enumerate(refs):
        assert srv.submit(p, r)
    stats = srv.stop()
    got = {p: s for p, s, _, _ in srv.results()}
    assert stats.served == 6 and stats.failed == 0 and not srv.leaked
    assert sorted(got) == list(range(6))
    assert_close([got[p] for p in range(6)], svc.predict_batch(refs))


def test_server_counts_match_jax_server():
    """Same submissions, same deterministic handler (one poisoned
    query): both servers retire every query once, with the same scores
    and conservation counts."""
    def handler(ws):
        if any(w["x"] < 0 for w in ws):
            raise ValueError("poison")
        return [float(w["x"]) * 0.5 for w in ws]

    out = []
    for mod in (jserver, tserver):
        srv = mod.EnsembleServer(batch_handler=handler, n_workers=2,
                                 max_batch=3, max_queue=64).start()
        for p in range(10):
            srv.submit(p, {"x": -1.0 if p == 4 else float(p)})
        stats = srv.stop()
        res = sorted((p, s) for p, s, _, _ in srv.results())
        out.append((stats.served, stats.failed, stats.shed,
                    stats.n_latencies, [p for p, _ in res],
                    [s for _, s in res if s == s]))
    assert out[0] == out[1]
    assert out[1][:2] == (10, 1)


def test_engines_and_placement_not_ported_yet(zoo):
    """Placement is not ported yet; the slot engine is, and these calls
    now fail its argument checks (``test_torch_slots.py``)."""
    _, tm = zoo
    with pytest.raises(ValueError, match="slot_engine"):
        tserver.EnsembleServer(batch_handler=len, engine="slots")
    with pytest.raises(ValueError, match="device_ingest"):
        tp.StreamingPipeline(None, 1, engine="slots", device="cpu")
    with pytest.raises(NotImplementedError, match="placement"):
        tp.EnsembleService(tm, placement=object(), device="cpu")


@pytest.mark.parametrize("fused", [True, False])
def test_empty_zoo_serves_cpu_models_only(side_models, fused):
    vit, labs = side_models
    w = _windows(np.random.default_rng(13), 2)
    want = jp.EnsembleService([], vitals_model=vit, labs_model=labs,
                              fused=fused).predict_batch(w)
    got = tp.EnsembleService([], vitals_model=vit, labs_model=labs,
                             fused=fused, device="cpu").predict_batch(w)
    assert_close(got, want)
    assert tp.EnsembleService([], device="cpu").predict_batch([]) == []


def test_tier_router_routes_by_tier(zoo):
    _, tm = zoo
    a = tp.EnsembleService(tm[:3], device="cpu")
    b = tp.EnsembleService(tm[3:], device="cpu")
    router = tp.TierRouter({"critical": a, "stable": b})
    w = _windows(np.random.default_rng(10), 2, side=False)
    assert router.predict_batch(w, "stable") == b.predict_batch(w)
    assert router.predict(w[0], "unknown") == a.predict(w[0])
    with pytest.raises(ValueError):
        tp.TierRouter({})


def test_cpu_serving_launches_no_kernel(zoo):
    _, tm = zoo
    before = (kgather.launches.value, kconv.launches_stacked.value)
    svc = tp.EnsembleService(tm, device="cpu")
    svc.predict_batch(_refs(ta, _windows(np.random.default_rng(11), 2,
                                         side=False), device="cpu"))
    assert (kgather.launches.value, kconv.launches_stacked.value) == before


def test_copied_cpu_models_and_sketch_match_originals():
    rng = np.random.default_rng(12)
    X = rng.standard_normal((30, 7, 5))
    y = rng.integers(0, 2, 30)
    jv = jtab.VitalsForest(7, n_trees=3, seed=1).fit(X, y)
    tv = ttab.VitalsForest(7, n_trees=3, seed=1).fit(X, y)
    assert_bitwise(tv.predict_proba(X), jv.predict_proba(X))
    Z = rng.standard_normal((30, 8))
    assert_bitwise(ttab.LogisticRegression(steps=20).fit(Z, y)
                   .predict_proba(Z),
                   jtab.LogisticRegression(steps=20).fit(Z, y)
                   .predict_proba(Z))
    lat = rng.exponential(0.05, 500)
    counts_j = np.zeros(jsketch.N_BINS, np.int64)
    counts_t = np.zeros(tsketch.N_BINS, np.int64)
    for v in lat:
        counts_j[jsketch.bin_index(v)] += 1
        counts_t[tsketch.bin_index(v)] += 1
    assert_bitwise(counts_t, counts_j)
    for q in (50, 95, 99):
        assert tsketch.quantile_from_counts(counts_t, q) == \
            jsketch.quantile_from_counts(counts_j, q)
