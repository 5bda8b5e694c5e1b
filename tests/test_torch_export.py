"""The port's export plane (``repro_torch/obs/export.py``) against the
JAX package's, on the CPU.

* For the same telemetry (exact and sketch, fleet and tiered),
  controller (adaptive and tiered), tracer, service and tier state, the
  port's Prometheus text is the reference's, line for line: the same
  metric names (``holmes_*``, ``holmes_lane_rung`` and
  ``holmes_lane_members`` included), labels, HELP/TYPE lines and
  values.
* Behind a live server of each package, the same lines, with the values
  that depend on wall time masked.
* The HTTP endpoint on ``127.0.0.1:0`` (200 on ``/metrics``, 404
  elsewhere) with a bounded shutdown, and the JSONL span dump, which is
  the reference's byte for byte.
"""
import json
import threading
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from repro.control import controller as jctl
from repro.control import swap as jswap
from repro.control import telemetry as jtel
from repro.obs import export as jexp
from repro.obs import spans as jspans
from repro.serving import server as jserver
from repro_torch.configs.ecg_zoo import zoo_specs
from repro_torch.control import controller as tctl
from repro_torch.control import swap as tswap
from repro_torch.control import telemetry as ttel
from repro_torch.control.tiers import TIER_ORDER, TieredEnsemble
from repro_torch.models.ecg_resnext import init_ecg
from repro_torch.obs import export as texp
from repro_torch.obs import spans as tspans
from repro_torch.serving import pipeline as tp
from repro_torch.serving import server as tserver

torch.set_num_threads(1)
JOIN_S = 5.0
REF = types.SimpleNamespace(ctl=jctl, swap=jswap, tel=jtel, exp=jexp,
                            spans=jspans, server=jserver)
PORT = types.SimpleNamespace(ctl=tctl, swap=tswap, tel=ttel, exp=texp,
                             spans=tspans, server=tserver)
TIERS = TIER_ORDER


def _sel(n, idx):
    b = np.zeros(n, np.int8)
    b[list(idx)] = 1
    return b


def _feed(tel, seed, n=400, tiered=False):
    rng = np.random.default_rng(seed)
    for k in range(n):
        t = 0.04 * k + float(rng.uniform(-0.2, 0.0))
        kw = {"patient": int(rng.integers(0, 9))} if tiered else {}
        tel.record_arrival(t, **kw)
        u = rng.uniform()
        if u < 0.85:
            tel.record_served(float(rng.lognormal(-1.2, 0.9)), t, **kw)
        elif u < 0.95:
            tel.record_shed(t, **kw)
        else:
            tel.record_failure(t, **kw)


def _spans(P, n=12):
    rec = P.spans.SpanRecorder()
    for i in range(n):
        t = 1.0 + 0.1 * i
        rec.record(P.spans.SpanRecord(
            patient=i, tier=TIERS[i % 3] if i % 2 else None,
            status=("ok", "failed", "watchdog")[i % 5 % 3], t_submit=t,
            t_dequeue=t + 0.01 * (i % 4), t_flush=t + 0.02 + 0.01 * (i % 3),
            t_retire=t + 0.2 + 0.03 * i, batch_n=1 + i % 4,
            marshal_s=0.001 * i, dispatch_s=0.05, gather_s=0.002 * (i % 2)))
    return rec


def _adaptive(P):
    """A controller driven to SHED, then CLIMB, on an injected clock."""
    rungs = [_sel(4, [0]), _sel(4, [0, 1, 2])]

    class Ladder(P.swap.SelectorLadder):
        def _activate(self, selector):
            pass

    lad = Ladder(rungs[-1])
    lad.set_ladder(rungs)
    t = [100.0]
    drive = P.tel.SloTelemetry(slo_seconds=1.0, window_seconds=30.0,
                               clock=lambda: t[0])
    for k in range(40):
        drive.record_arrival(80.0 + k / 2)
        drive.record_served(2.0, 80.0 + k / 2)
    ctl = P.ctl.AdaptiveController(
        drive, lad, config=P.ctl.ControllerConfig(slo_seconds=1.0,
                                                  cooldown_seconds=5.0),
        sync=True, clock=lambda: t[0])
    ctl.step()
    t[0] = 140.0
    for k in range(60):
        drive.record_served(0.1, 120.0 + k / 3)
        drive.record_arrival(120.0 + k / 3)
    ctl.step()
    assert set(ctl.decision_counts()) == {"shed", "climb"}
    return ctl


def _tiered(P, tel):
    fam = [_sel(6, range(k + 1)) for k in range(3)]

    class Ladder(P.swap.SelectorLadder):
        def _activate(self, selector):
            pass

    swappers = {}
    for t in TIERS:
        swappers[t] = Ladder(fam[2])
        swappers[t].set_ladder(fam)
    ctl = P.ctl.TieredController(
        tel, swappers, tier_order=TIERS,
        config=P.ctl.TieredControllerConfig(slo_seconds=tel.slo,
                                            cooldown_seconds=0.0,
                                            min_samples=1),
        cost_fn=lambda s: 0.01 * float(np.sum(s)), n_devices=1)
    for k in range(4):
        ctl.step(now=20.0 + k)
    assert ctl.log
    return ctl


TIER_METRICS = {"stable": {"rung": 0.0, "n_members": 1.0},
                "elevated": {"rung": 1.0, "n_members": 3.0},
                "critical": {"rung": 2.0, "n_members": float("nan")}}


def _render(P, tiered, exact):
    clock = lambda: 16.5                              # noqa: E731
    if tiered:
        tel = P.tel.TieredTelemetry(lambda p: TIERS[p % 3], TIERS,
                                    slo_seconds=0.5, window_seconds=10.0,
                                    clock=clock, exact=exact)
    else:
        tel = P.tel.SloTelemetry(0.5, 10.0, clock=clock, exact=exact)
    _feed(tel, 3, tiered=tiered)
    ctl = _tiered(P, tel) if tiered else _adaptive(P)
    service = types.SimpleNamespace(dispatch_count=17, h2d_bytes=123456,
                                    marshal_seconds=0.25)
    tiers = types.SimpleNamespace(lane_metrics=lambda: TIER_METRICS,
                                  swapper_metrics=lambda: TIER_METRICS)
    exp = P.exp.MetricsExporter(telemetry=tel, controller=ctl,
                                tracer=_spans(P), service=service,
                                tiers=tiers)
    return exp.render(), exp.summary()


@pytest.mark.parametrize("tiered", [False, True])
@pytest.mark.parametrize("exact", [False, True])
def test_render_identical_line_for_line(tiered, exact):
    ref, ref_sum = _render(REF, tiered, exact)
    port, port_sum = _render(PORT, tiered, exact)
    assert port.splitlines() == ref.splitlines()
    assert str(port_sum) == str(ref_sum)
    names = {l.split()[2] for l in port.splitlines()
             if l.startswith("# TYPE")}
    assert {"holmes_lane_rung", "holmes_lane_members",
            "holmes_controller_decisions_total", "holmes_window_p99",
            "holmes_span_coverage", "holmes_dispatches_total"} <= names
    assert ("holmes_latency_seconds" in names) == (not exact)
    if tiered:
        assert 'holmes_window_p99{tier="critical"}' in port


def _served(P, tel, rec, n=6):
    srv = P.server.EnsembleServer(
        batch_handler=lambda b: [0.5] * len(b), n_workers=1, max_batch=1,
        max_wait_ms=0.5, telemetry=tel, tracer=rec).start()
    for p in range(n):
        assert srv.submit(p, {})
    srv.drain(timeout=JOIN_S)
    srv.stop()
    assert not srv.leaked
    return srv


# values that depend on the wall clock: rates, latencies and stage times
TIMED = ("holmes_window_arrival_rate", "holmes_window_violation_rate",
         "holmes_window_p50", "holmes_window_p99",
         "holmes_latency_seconds_bucket", "holmes_slo_violations_total",
         "holmes_span_stage_seconds_total", "holmes_span_coverage")


def _masked(text):
    out = []
    for line in text.splitlines():
        if line and not line.startswith("#") \
                and line.split("{")[0].split(" ")[0] in TIMED:
            line = line.rpartition(" ")[0] + " <timed>"
        out.append(line)
    return out


def test_server_exporter_matches_reference():
    texts = []
    for P in (REF, PORT):
        tel = P.tel.SloTelemetry(1.0, 60.0)
        rec = P.spans.SpanRecorder()
        srv = _served(P, tel, rec)
        exp = P.exp.MetricsExporter(server=srv, telemetry=tel, tracer=rec)
        texts.append(exp.render())
    assert _masked(texts[1]) == _masked(texts[0])
    lines = texts[1].splitlines()
    assert "holmes_served_total 6.0" in lines
    assert "holmes_batch_flushes_total 6.0" in lines
    assert 'holmes_spans_total{status="ok"} 6.0' in lines
    for line in lines:                         # "name value", parseable
        if line and not line.startswith("#"):
            name, _, val = line.rpartition(" ")
            assert name and (val == "NaN" or float(val) == float(val))


def test_http_endpoint_and_bounded_shutdown():
    tel = ttel.SloTelemetry(1.0, 60.0)
    srv = _served(PORT, tel, None)
    httpd = texp.start_metrics_server(
        texp.MetricsExporter(server=srv, telemetry=tel), port=0)
    serving = [t for t in threading.enumerate()
               if t.name == "repro-metrics"]
    try:
        base = f"http://127.0.0.1:{httpd.server_port}"
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            assert r.status == 200
            assert r.headers["Content-Type"].startswith("text/plain")
            body = r.read().decode()
        assert "holmes_served_total 6.0" in body.splitlines()
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(base + "/nope", timeout=10)
        assert err.value.code == 404
    finally:
        stopper = threading.Thread(target=httpd.shutdown, daemon=True)
        stopper.start()
        stopper.join(JOIN_S)
        httpd.server_close()
    assert not stopper.is_alive()
    for t in serving:
        t.join(JOIN_S)
        assert not t.is_alive()


def test_jsonl_round_trip_matches_reference(tmp_path):
    paths = []
    for tag, P in (("ref", REF), ("port", PORT)):
        path = tmp_path / f"{tag}.jsonl"
        assert P.exp.write_spans_jsonl(_spans(P), str(path)) == 12
        paths.append(path)
    assert paths[1].read_bytes() == paths[0].read_bytes()
    rows = [json.loads(l) for l in paths[1].read_text().splitlines()]
    assert [r["patient"] for r in rows] == list(range(12))
    for r in rows:
        assert r["e2e_s"] >= r["queue"] >= 0.0


def test_tiered_ensemble_feeds_the_lane_gauges():
    """A real ``TieredEnsemble``'s ``swapper_metrics`` renders as the
    reference's ``holmes_lane_rung`` / ``holmes_lane_members``."""
    specs = zoo_specs(reduced=True, input_len=250, blocks=(2,))
    pool = [tp.ZooMember(s, init_ecg(s, torch.Generator().manual_seed(i)))
            for i, s in enumerate(specs)]
    n = len(pool)
    fam = [_sel(n, [0]), _sel(n, range(0, n, 2)), _sel(n, range(n))]
    te = TieredEnsemble(pool, initial=dict(zip(TIERS, fam)),
                        warmup_batch_sizes=(1,), device="cpu")
    te.set_ladder(fam)
    te.swapper("critical").shed()
    lines = texp.MetricsExporter(tiers=te).render().splitlines()
    assert lines[:2] == ["# HELP holmes_lane_rung Ladder rung per tier lane",
                         "# TYPE holmes_lane_rung gauge"]
    assert 'holmes_lane_rung{tier="critical"} 1.0' in lines
    assert 'holmes_lane_rung{tier="stable"} 0.0' in lines
    assert f'holmes_lane_members{{tier="elevated"}} ' \
        f'{float(fam[1].sum())!r}' in lines
