#!/usr/bin/env python3
"""Readings of the program's spans that no cell reports yet, and a
witness of what keeps a flush's issuing worker off the CPU.

    python3 bench/probe_spans.py --workload zoo12-steady --seed 7 \\
        --seconds 51 --witness 40 --out chiprun_out/probe_zoo12.json

No cell runs this helper and ``BENCHMARK.json`` names none of what it
prints.  It is where a later harness change can start from.

It makes two readings on a card:

1. **A traced run of the cell** through ``bench.harness.runner.run``,
   with three additions that the runner itself does not make: it gives
   the cell's ``DeviceIngest`` a ``SpanRecorder`` of its own as
   ``tracer``, it keeps the loaded chrome-trace events, and it keeps the
   readers' ``obs``.  From these it reads ``dispatch_idle_share``,
   ``ingest_offcpu_us`` and ``ingest_lock_wait_us``, plus how far each
   flush's span lies from its ``holmes.flush`` range on the trace's
   clock.  The run's own per-layer metrics are printed beside them.
   Tracing the ingest costs each call two spans, so this run's
   ``ingest_host_us`` reads a little high.
2. **A witness** (``--witness K``) of the dispatch's off-CPU share.  It
   serves K flushes of one query, one after another on one thread,
   under three conditions:

   - ``alone``: no other thread in the process does any work.
   - ``beside_ingest``: a thread replays the cell's ingest on the card
     at its rate, two calls a bed a second, to beds the flushes do not
     read.
   - ``beside_cpu_ingest``: the same replay into rings on the CPU, with
     the same Python and GIL traffic but no CUDA driver call.
   - ``beside_flushes``: a second thread serves the same flush back to
     back, as the server's second worker would.

   ``alone`` gives the floor that the GIL cannot explain: descheduling
   and driver calls that sleep.  What ``beside_cpu_ingest`` adds is
   other Python threads (the GIL).  What ``beside_ingest`` adds beyond
   that is the driver's work or locks.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

ROOT = Path(__file__).resolve().parents[1]
DISPATCH = "holmes.flush.dispatch"
FLUSH = "holmes.flush"
EDGE_US = 100.0          # a whole range starts and ends this far inside


def _overlap(a: Sequence, b: Sequence) -> float:
    """Length of the intersection of two sorted, disjoint interval
    lists."""
    i = j = 0
    out = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def dispatch_idle_share(events: List[Dict]) -> Optional[float]:
    """1 - (device-op union clipped to the dispatch ranges) / (union of
    those ranges), in %, over the ``holmes.flush.dispatch`` ranges that
    the slice holds whole.  ``None`` when it holds none."""
    from bench.harness.stats import merge
    from bench.harness.trace import DEVICE_CATS
    if not events:
        return None
    t0 = min(float(e["ts"]) for e in events)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in events)
    ranges, dev = [], []
    for e in events:
        s, d = float(e["ts"]), float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            dev.append((s, s + d))
        elif e.get("name") == DISPATCH and s > t0 + EDGE_US \
                and s + d < t1 - EDGE_US:
            ranges.append((s, s + d))
    ranges = merge(ranges)
    total = sum(e - s for s, e in ranges)
    if total <= 0:
        return None
    return 100.0 * (1.0 - _overlap(merge(dev), ranges) / total)


def ingest_readings(trees: Sequence, lo: float, hi: float,
                    dropped: int) -> Optional[Dict[str, float]]:
    """Mean wall, thread CPU, off-CPU and ``ingest.lock`` µs of the
    ``holmes.ingest`` trees whose root starts in ``[lo, hi)``.  ``None``
    when the recorder dropped any ingest tree, or none lies there."""
    if dropped:
        return None
    roots, locks = [], []
    for t in trees:
        if lo <= t.root.t0 < hi:
            roots.append(t.root)
            locks.append(sum(s.wall_s for s in t.named("ingest.lock")))
    if not roots:
        return None
    n = len(roots)
    return {"n": n,
            "wall_us": 1e6 * sum(r.wall_s for r in roots) / n,
            "cpu_us": 1e6 * sum(r.cpu_s for r in roots) / n,
            "ingest_offcpu_us": 1e6 * sum(r.wall_s - r.cpu_s
                                          for r in roots) / n,
            "ingest_lock_wait_us": 1e6 * sum(locks) / n}


def offcpu(spans: Sequence) -> Dict[str, float]:
    """Mean wall ms and the off-CPU share (%) of ``spans``."""
    wall = sum(s.wall_s for s in spans)
    return {"n": len(spans), "wall_ms": 1e3 * wall / max(len(spans), 1),
            "offcpu_share": (100.0 * sum(s.wall_s - s.cpu_s for s in spans)
                             / wall if wall > 0 else None)}


def _clock_offsets(anchor, base_ns: int, trees, events) -> List[float]:
    """|trace range start - span start mapped through ``anchor``| (µs),
    one a flush whose ``holmes.flush`` range the trace holds."""
    mono, unix = anchor
    starts = sorted(float(e["ts"]) for e in events if e.get("name") == FLUSH)
    out = []
    for t in trees:
        us = (round(t.root.t0 * 1e9) - mono + unix - base_ns) / 1e3
        near = min(starts, key=lambda s: abs(s - us), default=None)
        if near is not None and abs(near - us) < 1e4:
            out.append(abs(near - us))
    return out


@contextlib.contextmanager
def _patched(runner, rec, keep: Dict):
    """The runner's ingest traced into ``rec``; its own recorder, its
    loaded trace events, the trace's base time and the readers' ``obs``
    kept in ``keep``."""
    import repro_torch.obs.spans as sp
    import repro_torch.serving.aggregator as agg
    from bench.harness import trace
    orig = (agg.DeviceIngest, sp.SpanRecorder, trace.load_events,
            runner.reader)

    class TracedIngest(orig[0]):
        def __init__(self, *a, **kw):
            kw.setdefault("tracer", rec)
            super().__init__(*a, **kw)

    class KeptRecorder(orig[1]):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            keep["recorder"] = self

    def load(path):
        with open(path) as f:
            keep["base_ns"] = int(json.load(f).get("baseTimeNanoseconds", 0))
        keep["events"] = orig[2](path)
        return keep["events"]

    def reader(name):
        r = orig[3](name)

        def read(obs):
            keep["obs"] = obs
            return r(obs)
        return read
    agg.DeviceIngest, sp.SpanRecorder, trace.load_events, \
        runner.reader = TracedIngest, KeptRecorder, load, reader
    try:
        yield
    finally:
        agg.DeviceIngest, sp.SpanRecorder, trace.load_events, \
            runner.reader = orig


def traced_run(cell, seed: int, seconds: float, device) -> Dict:
    from bench.harness import runner
    from repro_torch.obs.spans import SpanRecorder
    rec = SpanRecorder(keep=2 * cell.n_beds * int(seconds + 90) + 4096)
    keep: Dict = {}
    anchor = (time.monotonic_ns(), time.time_ns())
    with _patched(runner, rec, keep):
        out = runner.run(cell, seed, seconds, True, device, time.monotonic())
    obs = keep.get("obs", {})
    spans = obs.get("spans") or []
    trees = list({id(s.flush): s.flush for s in spans
                  if getattr(s, "flush", None) is not None}.values())
    lo = min((s.t_submit for s in spans), default=0.0)
    hi = max((s.t_submit for s in spans), default=0.0)
    events = keep.get("events") or []
    every = keep["recorder"].spans()        # the slice lies after the window
    offs = _clock_offsets(anchor, keep.get("base_ns", 0), list(
        {id(s.flush): s.flush for s in every if s.flush is not None}.values()),
        events)
    return {
        "correct": out["correct"],
        "metrics": {k: v for k, (v, _) in out["metrics"].items()},
        "dispatch_idle_share": dispatch_idle_share(events),
        "ingest": ingest_readings(rec.ingests(), lo, hi,
                                  rec.dropped["ingest"]),
        "dispatch": offcpu([s for t in trees
                            for s in t.named("flush.dispatch")]),
        "clock_offset_us": ({"n": len(offs), "median": statistics.median(offs),
                             "max": max(offs)} if offs else None),
        "idle_gaps": out.get("breakdown", {}).get("idle_gaps"),
        "busy_s": out.get("busy_s"), "window_s": out.get("window_s"),
    }


def _replay(di, pool, beds: range, stop: threading.Event,
            rate: List[float]):
    """Two ingest calls a bed a second, round the beds, until ``stop``;
    the calls a second it kept up goes to ``rate``."""
    period = 1.0 / (2 * len(beds))
    t_start = t_next = time.monotonic()
    i = 0
    while not stop.is_set():
        bed = beds[i % len(beds)]
        row = i % len(pool.ecg)
        di.ingest(float(i), bed, "ecg" if i % 2 == 0 else "vitals",
                  (pool.ecg if i % 2 == 0 else pool.vitals)[row])
        i += 1
        t_next += period
        wait = t_next - time.monotonic()
        if wait > 0:
            time.sleep(wait)
    rate.append(i / (time.monotonic() - t_start))


def _flush_loop(svc, refs, stop: threading.Event, rate: List[float]):
    """Flushes back to back until ``stop``; flushes a second to ``rate``."""
    t_start = time.monotonic()
    i = 0
    while not stop.is_set():
        svc.predict_batch(refs)
        i += 1
    rate.append(i / (time.monotonic() - t_start))


def witness(cell, seed: int, flushes: int, device) -> Dict:
    """The dispatch's off-CPU share of ``flushes`` one-query flushes on
    one thread, alone and beside a replay of the cell's ingest."""
    import numpy as np
    import torch
    from bench.harness import runner
    from bench.harness import traffic as tr
    from bench.harness.weights import make_params, side_data
    from repro_torch.obs import spans as sp
    from repro_torch.serving.aggregator import DeviceIngest
    from repro_torch.serving.pipeline import EnsembleService, ZooMember

    config, mix = cell.config, cell.traffic
    members = cell.members
    params = make_params(members, seed, device)
    vit, labs = runner._side_models(config, seed, side_data(config, seed))
    svc = EnsembleService([ZooMember(s, p) for s, p
                           in zip(runner._specs(members), params)],
                          vitals_model=vit, labs_model=labs, device=device)
    svc.warmup(batch_sizes=(1,))
    pool = tr.make_pool(mix, config, seed)
    ws = float(config["window_seconds"])
    prefill = int(round(ws / mix["chunk_seconds"]))
    n = max(cell.n_beds, 9)
    rings = {dev: DeviceIngest(runner._modalities(config), n, ws, device=dev)
             for dev in (device, torch.device("cpu"))}
    di = rings[device]
    rows = np.arange(prefill) % len(pool.ecg)
    di.ingest(0.0, 0, "ecg", np.concatenate(pool.ecg[rows], axis=-1))
    di.ingest(0.0, 0, "vitals", np.concatenate(pool.vitals[rows], axis=-1))
    refs = [di.close_window(0, 0.0, extra={"labs": pool.labs[0]})]
    for _ in range(3):
        svc.predict_batch(refs)
    out = {"switch_interval_s": sys.getswitchinterval()}
    beside = {"alone": None,
              "beside_ingest": (_replay, (di, pool, range(8, n))),
              "beside_cpu_ingest": (_replay, (rings[torch.device("cpu")],
                                              pool, range(8, n))),
              "beside_flushes": (_flush_loop, (svc, refs))}
    for name, other in beside.items():
        stop, rate = threading.Event(), []
        th = None
        if other is not None:
            th = threading.Thread(target=other[0], daemon=True,
                                  args=(*other[1], stop, rate))
            th.start()
            time.sleep(1.0)
        disp, whole = [], []
        for _ in range(flushes):
            with sp.collect("flush") as tree:
                svc.predict_batch(refs)
            disp += tree.named("flush.dispatch")
            whole.append(tree.root)
        stop.set()
        if th is not None:
            th.join(10.0)
        out[name] = {"dispatch": offcpu(disp), "flush": offcpu(whole),
                     "beside_per_s": rate[0] if rate else 0.0}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--witness", type=int, default=0,
                    help="flushes a witness condition (0: no witness)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):     # as bench/run.py
        os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch
    from bench.harness.cells import load_cell
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    res = {"workload": args.workload, "seed": args.seed,
           "card": torch.cuda.get_device_name(dev),
           "run": traced_run(load_cell(args.workload), args.seed,
                             args.seconds, dev)}
    if args.witness:
        res["witness"] = witness(load_cell(args.workload), args.seed,
                                 args.witness, dev)
    line = json.dumps(res)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
