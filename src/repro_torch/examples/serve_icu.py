"""End-to-end ICU serving demo (the port of ``examples/serve_icu.py``):
a 64-bed discrete-event simulation of the served ensemble (Fig. 10
conditions) + real wall-clock fused serving on the card (bucketed
stacked passes + cross-patient micro-batching through the batch-aware
``EnsembleServer``), from host windows and from device-resident ingest.

``--metrics`` attaches the observability plane to the fused server:
per-stage span attribution, a live ``/metrics`` scrape (127.0.0.1) and
a JSONL span dump.

``--chaos`` runs a fault drill against the live fused server: a
deterministic ``FaultPlane`` schedule injects a transient device loss,
a worker stall, and a backpressure episode; the drill prints how each
fault was absorbed — served late, NaN-failed by the watchdog, or
counted rejected — with full query conservation.

``--tiered`` runs the per-acuity-tier control plane over the DES, and
``--adaptive`` the online control plane against a census spike (beds
tripling mid-run): per-epoch telemetry drives the controller (shed /
warm-started recompose / climb) with the trained zoo and its measured
member costs, then a real hot-swap segment swaps selectors mid-stream
with zero dropped queries.

    python -m repro_torch.examples.serve_icu [--beds 64] [--adaptive]
    PYTHONPATH=src python -m repro_torch.examples.serve_icu \\
        --device cpu --beds 8 --minutes 1

``--devices`` is the simulated devices of the DES and the server's
workers, as in the reference; ``--device`` is where the zoo runs
(default ``cuda:0``).  Each section is a function that takes the
service or members it serves and returns the numbers it prints;
``main`` calls them in the reference's order and returns their results
by section name.  ``main(observe=)`` takes a context-manager factory
entered around each section with its name (``chip_smoke.py`` resets
and reads the kernels' launch counters there).
"""
import argparse
import contextlib
import tempfile
import threading
import time
import urllib.request
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.benchmarks.adaptive_bench import (run_adaptive_sim,
                                                   run_tiered_sim,
                                                   wallclock_hot_swap)
from repro_torch.benchmarks.zoo_setup import (binding_budget, build_zoo,
                                              make_profilers)
from repro_torch.configs.ecg_zoo import ECG_HZ, ECG_LEADS
from repro_torch.control.faults import FaultEvent, FaultPlane
from repro_torch.control.telemetry import SloTelemetry
from repro_torch.core.composer import ComposerParams, compose
from repro_torch.core.profiles import SystemConfig
from repro_torch.device import lanes, resolve_device
from repro_torch.obs.export import (MetricsExporter, start_metrics_server,
                                    write_spans_jsonl)
from repro_torch.obs.spans import SpanRecorder
from repro_torch.serving.aggregator import DeviceIngest, ModalitySpec
from repro_torch.serving.latency import queueing_bound
from repro_torch.serving.pipeline import EnsembleService, ZooMember
from repro_torch.serving.server import EnsembleServer
from repro_torch.serving.simulator import SimConfig, simulate
from repro_torch.training.data import ecg_clip, sample_patient

WARMUP_BATCH_SIZES = (1, 2, 4, 8)      # the server's flush rungs


def clip_seconds(members: Sequence[ZooMember]) -> int:
    """Seconds of ECG a window of these members holds (3 for the
    reduced zoo, 30 for the full one)."""
    return max(m.spec.input_len for m in members) // ECG_HZ


def census_spike(beds: int) -> List:
    """The control-plane demos' schedule: (epochs, census) phases, the
    census tripling for the middle four epochs."""
    return [(3, beds), (4, 3 * beds), (3, beds)]


def members_of(zoo, extras, idx) -> List[ZooMember]:
    return [ZooMember(extras["specs"][i],
                      extras["params"][zoo.profiles[i].name]) for i in idx]


def compose_section(zoo, extras, beds: int, n_devices: int) -> Dict:
    """Compose the ensemble under the binding budget at this census."""
    sysconf = SystemConfig(n_devices=n_devices, n_patients=beds)
    f_a, f_l = make_profilers(zoo, sysconf, extras)
    budget = binding_budget(zoo, f_l)
    res = compose(len(zoo), f_a, f_l, budget,
                  ComposerParams(N=8, K=6, seed=0))
    sel = np.flatnonzero(res.b_star)
    names = [zoo.profiles[i].name for i in sel]
    print(f"ensemble: {names}")
    print(f"predicted latency {res.latency * 1000:.1f} ms "
          f"(budget {budget * 1000:.1f} ms)")
    return {"result": res, "selected": sel.tolist(), "names": names,
            "costs": [extras["measured_costs"][i] for i in sel],
            "budget_s": budget, "latency_s": res.latency, "f_a": f_a}


def des_report(costs: Sequence[float], beds: int, n_devices: int,
               minutes: float) -> Dict:
    """The served ensemble's members in the discrete-event simulation
    at ``beds`` beds, with the network-calculus bound beside it."""
    cfg = SimConfig(n_patients=beds, n_devices=n_devices,
                    duration_seconds=minutes * 60, window_seconds=30.0)
    r = simulate(costs, cfg)
    mu = n_devices / sum(costs)
    tq = queueing_bound(r.arrivals, mu, max(costs))
    out = {"queries": len(r.queries), "tq_bound_s": tq}
    print(f"\n{beds}-bed simulation, {minutes:.0f} min, "
          f"{beds * 250} qps ingest:")
    print(f"  queries served     : {len(r.queries)}")
    if len(r.queries):
        out.update(p50_s=r.p(50), p95_s=r.p(95),
                   max_s=float(r.latencies().max()),
                   utilization=r.utilization,
                   max_tq_s=float(r.queue_delays().max()),
                   sub_second_p95=bool(r.p(95) < 1.0))
        print(f"  p50 / p95 / max    : {out['p50_s'] * 1000:.1f} / "
              f"{out['p95_s'] * 1000:.1f} / {out['max_s'] * 1000:.1f} ms")
        print(f"  device utilization : {r.utilization:.2%}")
        print(f"  empirical max Tq   : {out['max_tq_s'] * 1000:.1f} ms"
              f"  (network-calculus bound {tq * 1000:.1f} ms)")
        print(f"  sub-second p95     : {out['sub_second_p95']}")
    else:
        print("  (duration shorter than one observation window — "
              "no sim queries)")
    return out


def _flushes(svc: EnsembleService, passes: int) -> int:
    return passes // max(svc.n_buckets, 1)


def serve_fused(svc: EnsembleService, n_beds: int, n_workers: int,
                rng: np.random.Generator, metrics: bool = False) -> Dict:
    """Real wall-clock fused serving: the composed ensemble behind the
    batch-aware server, windows from many beds coalesced per flush.
    With ``metrics`` the server carries a span tracer and an SLO
    telemetry tap (returned for ``metrics_report``)."""
    tracer = telem = None
    if metrics:
        tracer = SpanRecorder()
        telem = SloTelemetry(slo_seconds=1.0, window_seconds=30.0)
    srv = EnsembleServer(batch_handler=svc.predict_batch,
                         n_workers=n_workers, max_batch=8,
                         max_wait_ms=2.0, telemetry=telem,
                         tracer=tracer).start()
    seconds = clip_seconds(svc.members)
    d0 = svc.dispatch_count
    for bed in range(n_beds):
        pp = sample_patient(rng, bed % 2)
        srv.submit(bed, {"ecg": ecg_clip(rng, pp, seconds=seconds)})
    stats = srv.stop()
    passes = svc.dispatch_count - d0
    out = {"submitted": n_beds, "served": stats.served,
           "failed": stats.failed, "p50_s": stats.p(50),
           "p95_s": stats.p(95), "zoo_passes": passes,
           "flushes": _flushes(svc, passes),
           "mean_batch": srv.batcher.stats.mean_batch,
           "leaked": list(srv.leaked), "server": srv, "tracer": tracer,
           "telemetry": telem}
    print(f"\nfused wall-clock serving ({len(svc.members)} members -> "
          f"{svc.n_buckets} buckets, {n_beds} beds):")
    print(f"  served             : {stats.served}")
    print(f"  p50 / p95          : {out['p50_s'] * 1000:.1f} / "
          f"{out['p95_s'] * 1000:.1f} ms")
    print(f"  zoo passes         : {passes} "
          f"({passes / max(stats.served, 1):.2f}/query; "
          f"{out['flushes']} flushes, mean batch "
          f"{out['mean_batch']:.1f})")
    return out


def metrics_report(srv: EnsembleServer, tracer: SpanRecorder,
                   telem: SloTelemetry, svc: EnsembleService) -> Dict:
    """Where did each query's latency go?  The span recorder attributed
    every retired query across queue / coalesce / marshal / dispatch /
    gather, and the exporter publishes the same numbers as Prometheus
    text (scraped once over 127.0.0.1) + JSONL traces."""
    att = tracer.attribution()
    stage_ms = {k: 1e3 * v / max(att["n_spans"], 1)
                for k, v in att["stage_seconds"].items()}
    print(f"\nobservability plane ({att['n_spans']} spans, "
          f"coverage {att['coverage']:.3f}):")
    print("  per-query stage ms : "
          + "  ".join(f"{k} {v:.2f}" for k, v in stage_ms.items()))
    exporter = MetricsExporter(server=srv, telemetry=telem,
                               tracer=tracer, service=svc)
    httpd = start_metrics_server(exporter, port=0)
    url = f"http://127.0.0.1:{httpd.server_port}/metrics"
    with contextlib.ExitStack() as stop:
        stop.callback(httpd.server_close)
        stop.callback(httpd.shutdown)
        with urllib.request.urlopen(url, timeout=10) as resp:
            body = resp.read().decode()
    series = [ln for ln in body.splitlines()
              if ln and not ln.startswith("#")]
    served = [float(ln.split()[-1]) for ln in series
              if ln.split()[0] == "holmes_served_total"]
    print(f"  /metrics scrape    : {len(series)} series from {url}")
    with tempfile.NamedTemporaryFile(suffix=".jsonl", delete=False) as f:
        n = write_spans_jsonl(tracer, f.name)
    print(f"  JSONL span dump    : {n} spans -> {f.name}")
    return {"n_spans": att["n_spans"], "coverage": att["coverage"],
            "stage_ms": stage_ms, "n_series": len(series),
            "served_total": served[0] if served else None,
            "spans_dumped": n, "spans_path": f.name}


def serve_ingest(svc: EnsembleService, n_beds: int, n_workers: int,
                 rng: np.random.Generator) -> Dict:
    """Device-resident ingest: the same beds stream 250-sample chunks
    into ring buffers on the service's device; a closed window is
    submitted as a ``DeviceWindowRef`` (three host ints) and the flush
    gathers + lead-expands it on the device — no per-member H2D
    marshaling at all.  Returns each bed's clip and served score."""
    clip_len = max(m.spec.input_len for m in svc.members)
    lens = tuple(sorted({m.spec.input_len for m in svc.members}))
    di = DeviceIngest([ModalitySpec("ecg", float(clip_len), ECG_LEADS)],
                      n_patients=n_beds, window_seconds=1.0,
                      device=svc.device)
    di.warm_gather(lens=lens, batch_sizes=WARMUP_BATCH_SIZES)
    h0, q0 = svc.h2d_bytes, svc.dispatch_count
    srv = EnsembleServer(batch_handler=svc.predict_batch,
                         n_workers=n_workers, max_batch=8,
                         max_wait_ms=2.0).start()
    seconds = clip_seconds(svc.members)
    windows = {}
    for bed in range(n_beds):
        pp = sample_patient(rng, bed % 2)
        ecg = ecg_clip(rng, pp, seconds=seconds)
        windows[bed] = ecg
        for off in range(0, ecg.shape[-1], 250):
            di.ingest(off / 250.0, bed, "ecg", ecg[:, off:off + 250])
        srv.submit(bed, di.close_window(bed, 1.0))
    stats = srv.stop()
    passes = svc.dispatch_count - q0
    scores = {p: s for p, s, _, _ in srv.results()}
    h2d = (svc.h2d_bytes - h0) / max(stats.served, 1)
    out = {"submitted": n_beds, "served": stats.served,
           "failed": stats.failed, "p50_s": stats.p(50),
           "p95_s": stats.p(95), "zoo_passes": passes,
           "flushes": _flushes(svc, passes),
           "gathers_per_flush": len(lens),
           "warmup_gathers": len(lens) * len(WARMUP_BATCH_SIZES),
           "h2d_bytes_per_query": h2d, "leaked": list(srv.leaked),
           "windows": windows, "scores": scores}
    print(f"\ndevice-resident ingest ({n_beds} beds, ring-buffered "
          f"250 Hz chunks, on-device lead-gather):")
    print(f"  served             : {stats.served}")
    print(f"  p50 / p95          : {out['p50_s'] * 1000:.1f} / "
          f"{out['p95_s'] * 1000:.1f} ms")
    print(f"  zoo passes         : {passes} "
          f"({passes / max(stats.served, 1):.2f}/query; "
          f"{out['flushes']} flushes)")
    print(f"  flush H2D          : {h2d:.0f} B/query"
          f" (vs {ECG_LEADS * clip_len * 4} B/query packed, "
          f"{len(svc.members) * clip_len * 4} B/query pre-refactor)")
    return out


class _CountedGuard:
    """A dispatch guard that counts the stacked passes it lets through,
    by bucket position: a flush calls the guard before each of its
    bucket passes in order, and a raise ends the flush, so a thread's
    next call after a raise is a new flush's first pass."""

    def __init__(self, guard: Callable, n_buckets: int):
        self.guard = guard
        self.passes = [0] * n_buckets
        self._pos = threading.local()
        self._lock = threading.Lock()

    def __call__(self, device) -> None:
        i = getattr(self._pos, "i", 0)
        self._pos.i = 0
        self.guard(device)
        with self._lock:
            self.passes[i] += 1
        self._pos.i = (i + 1) % len(self.passes)


def chaos_drill(svc: EnsembleService, n_beds: int,
                rng: np.random.Generator) -> Dict:
    """The same fused service behind a watchdogged, priority-bounded
    server, with a seeded fault schedule fired against it.  The
    transient device loss is ridden out by the protect() retry loop
    (queries served LATE, heart-beating so the watchdog knows they are
    alive); the injected stall never heart-beats, so the watchdog
    NaN-fails that co-batch and respawns the worker; the backpressure
    episode floods stable beds and the priority queue sheds them
    first.  ``passes`` counts the stacked passes the plane let through
    by bucket position (a loss that lands mid-flush ends it part way)."""
    schedule = [
        FaultEvent(t=0.2, kind="device_loss", target=0, duration=0.6),
        FaultEvent(t=1.0, kind="worker_stall", duration=0.8),
        FaultEvent(t=1.6, kind="backpressure", duration=0.5),
    ]
    plane = FaultPlane(schedule)
    guarded = plane.protect(lambda ws, *_tier: svc.predict_batch(ws),
                            heartbeat=lambda: srv.heartbeat())
    srv = EnsembleServer(
        batch_handler=guarded, n_workers=2, max_batch=4,
        max_wait_ms=2.0, max_queue=8,
        tier_of=lambda bed: "critical" if bed % 4 == 0 else "stable",
        tier_priority={"critical": 1.0, "stable": 0.0},
        deadline_seconds=0.5).start()
    counted = _CountedGuard(plane.guard, svc.n_buckets)
    svc.dispatch_guard = counted
    # an unsharded service calls its guard with None, which the plane
    # maps to lane 0: the one lane of the service's own device
    plane.arm(devices=lanes(1, svc.device))  # clock starts AFTER warm-up
    seconds = clip_seconds(svc.members)
    d0 = svc.dispatch_count
    submitted = 0
    while plane.now() < 2.5 or not plane.done():
        bed = submitted % n_beds
        pp = sample_patient(rng, bed % 2)
        win = {"ecg": ecg_clip(rng, pp, seconds=seconds)}
        srv.submit(bed, win)
        submitted += 1
        if plane.backpressure_active():   # overrun the stable tier
            for b in range(n_beds):
                if b % 4 != 0:
                    srv.submit(b, win)
                    submitted += 1
        time.sleep(0.03)
    stats = srv.stop(join_timeout=5.0)
    svc.dispatch_guard = None
    passes = svc.dispatch_count - d0
    rej = sum(stats.rejected.values())
    out = {"submitted": submitted, "served": stats.served,
           "shed": stats.shed, "failed": stats.failed,
           "stalls": stats.stalls, "rejected": rej,
           "rejected_by_tier": {str(k): v
                                for k, v in stats.rejected.items()},
           "conservation": stats.served + stats.shed == submitted,
           "recoveries": list(plane.recoveries),
           "leaked": list(srv.leaked), "p50_s": stats.p(50),
           "p95_s": stats.p(95), "zoo_passes": passes,
           "flushes": _flushes(svc, passes),
           "passes": list(counted.passes)}
    print("\nchaos drill (transient device loss, worker stall, "
          "backpressure):")
    print(f"  submitted / served : {submitted} / {stats.served}")
    print(f"  NaN-failed (stall) : {stats.failed}  "
          f"(watchdog stalls {stats.stalls})")
    print(f"  rejected           : {rej} "
          f"(critical {stats.rejected.get('critical', 0)}, "
          f"stable {stats.rejected.get('stable', 0)})")
    print(f"  conservation       : {out['conservation']} "
          f"(served + shed == submitted)")
    for r in plane.recoveries:
        print(f"  recovery           : t={r['t']:.2f}s "
              f"{r['kind']} device {r['target']}")
    print(f"  stacked passes run : {sum(counted.passes)} "
          f"({out['flushes']} whole flushes)")
    print(f"  leaked threads     : {srv.leaked or 'none'}")
    return out


def tiered_demo(zoo, costs: Sequence[float], f_a, budget: float,
                beds: int, n_devices: int) -> Dict:
    """Per-acuity-tier degradation over the DES: the census spike, but
    the unit of actuation is a TIER — stable beds shed first (and climb
    last), critical beds keep the composed rich ensemble."""
    schedule = census_spike(beds)
    print(f"\ntiered control plane (census "
          f"{' -> '.join(str(c) for _, c in schedule)}, "
          f"SLO {budget * 1000:.0f} ms):")
    td = run_tiered_sim(zoo=zoo, costs=costs, f_a=f_a, slo=budget,
                        schedule=schedule, n_devices=n_devices,
                        verbose=True)
    tiers = list(td["tier_fracs"])
    for name, t in (("critical", tiers[-1]), ("stable  ", tiers[0])):
        pt = td["per_tier"][t]
        print(f"  {name}: viol {pt['violation_rate']:.2f}  "
              f"acc {pt['mean_accuracy']:.3f}  "
              f"min rung {pt['min_rung']}")
    return td


def adaptive_demo(zoo, costs: Sequence[float], f_a, budget: float,
                  beds: int, n_devices: int) -> Dict:
    """The closed loop of ``benchmarks.adaptive_bench`` with the TRAINED
    zoo and its measured per-member costs: the census triples mid-run,
    the static selector stays frozen, the adaptive one sheds /
    recomposes / climbs."""
    schedule = census_spike(beds)
    print(f"\nadaptive control plane (census "
          f"{' -> '.join(str(c) for _, c in schedule)}, "
          f"SLO {budget * 1000:.0f} ms):")
    common = dict(zoo=zoo, costs=costs, f_a=f_a, slo=budget,
                  schedule=schedule, n_devices=n_devices, verbose=True)
    st = run_adaptive_sim(adaptive=False, **common)
    ad = run_adaptive_sim(adaptive=True, **common)
    print(f"  static  : viol {st['violation_rate']:.2f}  "
          f"p99@spike {st['p99_final_spike_s'] * 1000:.0f} ms")
    print(f"  adaptive: viol {ad['violation_rate']:.2f}  "
          f"p99@spike {ad['p99_final_spike_s'] * 1000:.0f} ms  "
          f"({ad['n_recomposes']} recomposes)")
    return {"schedule": schedule, "static": st, "adaptive": ad}


def hot_swap_demo(pool: Sequence[ZooMember], selector: np.ndarray,
                  costs: Sequence[float], n_beds: int, n_workers: int,
                  device) -> Dict:
    """Real hot-swap mid-stream on the trained members: the full zoo is
    the pool, selectors toggle between the composed ensemble and its
    cheapest member; every submitted query is served across the
    swaps."""
    cheap = np.zeros(len(pool), np.int8)
    cheap[int(np.argmin(costs))] = 1
    seconds = clip_seconds(pool)
    swap = wallclock_hot_swap(
        n_queries=3 * n_beds, n_swaps=2, pool=pool,
        sel_a=selector, sel_b=cheap, n_workers=n_workers,
        window_fn=lambda r_, i: {"ecg": ecg_clip(
            r_, sample_patient(r_, i % 2), seconds=seconds)},
        verbose=False, device=device)
    print(f"  hot-swap mid-stream: {swap['served']}/{swap['submitted']} "
          f"served across {swap['swaps']} swaps "
          f"({swap['dropped']} dropped)")
    return swap


def main(argv=None, observe: Optional[Callable] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--beds", type=int, default=64)
    ap.add_argument("--devices", type=int, default=2,
                    help="simulated devices of the DES, and the "
                         "server's workers")
    ap.add_argument("--minutes", type=float, default=3.0)
    ap.add_argument("--device", default=None,
                    help="where the zoo runs: default cuda:0; 'cpu' "
                         "runs the plain versions")
    ap.add_argument("--adaptive", action="store_true",
                    help="run the online control plane against a "
                         "census spike (beds tripling mid-run)")
    ap.add_argument("--tiered", action="store_true",
                    help="run the per-acuity-tier control plane: "
                         "stable beds shed first under the spike, "
                         "critical beds hold the rich ensemble")
    ap.add_argument("--chaos", action="store_true",
                    help="run a deterministic fault drill against the "
                         "live server: transient device loss, worker "
                         "stall, backpressure — every query accounted")
    ap.add_argument("--metrics", action="store_true",
                    help="attach the observability plane to the fused "
                         "serving demo: per-stage span attribution, a "
                         "live /metrics scrape, and a JSONL span dump")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)         # raises before any build
    section = observe or (lambda name: contextlib.nullcontext())
    out: Dict[str, Dict] = {}

    zoo, extras = build_zoo(n_patients=16, clips=8, steps=120, device=dev)
    costs = extras["measured_costs"]
    with section("compose"):
        comp = out["compose"] = compose_section(zoo, extras, args.beds,
                                                args.devices)
    with section("des"):
        out["des"] = des_report(comp["costs"], args.beds, args.devices,
                                args.minutes)

    svc = EnsembleService(members_of(zoo, extras, comp["selected"]),
                          device=dev)
    svc.warmup(batch_sizes=WARMUP_BATCH_SIZES)
    out["service"] = svc
    rng = np.random.default_rng(0)
    n_demo = min(args.beds, 16)
    with section("fused"):
        fused = out["fused"] = serve_fused(svc, n_demo, args.devices, rng,
                                           metrics=args.metrics)
    if args.metrics:
        with section("metrics"):
            out["metrics"] = metrics_report(fused["server"],
                                            fused["tracer"],
                                            fused["telemetry"], svc)
    with section("ingest"):
        out["ingest"] = serve_ingest(svc, n_demo, args.devices, rng)
    if args.chaos:
        with section("chaos"):
            out["chaos"] = chaos_drill(svc, n_demo, rng)
    if args.tiered:
        with section("tiered"):
            out["tiered"] = tiered_demo(zoo, costs, comp["f_a"],
                                        comp["budget_s"], args.beds,
                                        args.devices)
    if args.adaptive:
        with section("adaptive"):
            out["adaptive"] = adaptive_demo(zoo, costs, comp["f_a"],
                                            comp["budget_s"], args.beds,
                                            args.devices)
        with section("hot_swap"):
            out["hot_swap"] = hot_swap_demo(
                members_of(zoo, extras, range(len(zoo))),
                comp["result"].b_star, costs, n_demo, args.devices, dev)
    return out


if __name__ == "__main__":
    main()
