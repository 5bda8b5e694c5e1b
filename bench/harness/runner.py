"""One run of a cell: set-up, open-loop census traffic through the port's
serving path, the measured window, and the check of every score due in
it against the plain reference.

The entry the window drives is the port's own: ``DeviceIngest.ingest``
for every chunk, ``close_window`` and ``EnsembleServer.submit`` for every
closed window, with ``EnsembleService.predict_batch`` as the server's
batch handler and every server setting at the program's default.  A
query's latency runs from the instant it was due on the schedule to the
instant ``predict_batch`` handed back its score, both on the harness's
clock: the server's own latencies serve only as a cross-check.
"""
from __future__ import annotations

import contextlib
import gc
import json
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from bench.counts.peaks import TF32_FLOP_S
from bench.harness import traffic as tr
from bench.harness.cells import Cell, reader
from bench.harness.stats import percentile
from bench.harness.trace import ProfiledSlice
from bench.harness.weights import make_params, side_data
from bench.reference import side as ref_side
from bench.reference.ensemble import BLOCK, eq5, member_probs

RUNGS = (1, 2, 4, 8)      # the server's flush sizes (max_batch 8, pow2 pads)
TRACE_AFTER_S = 1.0       # the profiled slice starts at the first window
                          # closing this long after the measured one
RESULT_POLL_S = 0.25      # how often the generator collects retired scores
ANSWER_WAIT_S = 60.0      # how long past the window a score may still come


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _specs(members: List[Dict]):
    from repro_torch.configs.ecg_zoo import EcgModelSpec
    return [EcgModelSpec(name=m["name"], lead=m["lead"], width=m["width"],
                         blocks=m["blocks"], input_len=m["input_len"],
                         cardinality=m["cardinality"],
                         kernel_size=m["kernel_size"]) for m in members]


def _side_models(config: Dict, seed: int, data: Dict):
    """The program's vitals forest and labs regression, fitted on the
    seeded data."""
    from repro_torch.models.tabular import LogisticRegression, VitalsForest
    s = int(seed) % 2 ** 31
    vit = VitalsForest(n_channels=config["vitals_channels"],
                       n_trees=config["vitals_trees"], seed=s)
    vit.fit(data["vitals"], data["vitals_y"])
    labs = LogisticRegression(steps=config["labs_steps"], seed=s)
    labs.fit(data["labs"], data["labs_y"])
    return vit, labs


def _ref_side_models(config: Dict, seed: int, data: Dict):
    s = int(seed) % 2 ** 31
    vit = ref_side.VitalsForest(config["vitals_channels"],
                                config["vitals_trees"], s)
    vit.fit(data["vitals"], data["vitals_y"])
    labs = ref_side.LogisticRegression(config["labs_steps"], s)
    labs.fit(data["labs"], data["labs_y"])
    return vit, labs


def _modalities(config: Dict):
    from repro_torch.serving.aggregator import ModalitySpec
    return [ModalitySpec("ecg", float(config["ecg_hz"]), config["ecg_leads"]),
            ModalitySpec("vitals", float(config["vitals_hz"]),
                         config["vitals_channels"])]


def _warm_flushes(svc, config: Dict, pool: tr.Pool, prefill: int,
                  device: torch.device) -> None:
    """Serve one flush of real ring refs at every rung, over a scratch
    ingest of ``max(RUNGS)`` beds: the whole ``predict_batch`` path (ring
    gathers, vitals readback, side models, combine) runs once at every
    shape the window will use."""
    from repro_torch.serving.aggregator import DeviceIngest
    n = max(RUNGS)
    di = DeviceIngest(_modalities(config), n, float(config["window_seconds"]),
                      device=device)
    rows = np.arange(prefill) % len(pool.ecg)
    for bed in range(n):
        di.ingest(0.0, bed, "ecg", np.concatenate(pool.ecg[rows], axis=-1))
        di.ingest(0.0, bed, "vitals",
                  np.concatenate(pool.vitals[rows], axis=-1))
    for p in RUNGS:
        refs = [di.close_window(bed, 0.0, extra={"labs": pool.labs[bed]})
                for bed in range(p)]
        for bed in range(p):            # keep the next rung's refs full
            di.mark["ecg"][bed] = 0
            di.mark["vitals"][bed] = 0
        svc.predict_batch(refs)
    del di


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float, beds: Optional[int] = None
        ) -> Dict:
    """One run, as the runner contract of ``bench/harness/cells.py``
    has it; besides, ``latency_ms`` (each window query's latency, in due
    order) and ``score_p50_ms``."""
    from repro_torch.obs.spans import SpanRecorder
    from repro_torch.serving.aggregator import DeviceIngest
    from repro_torch.serving.pipeline import EnsembleService, ZooMember
    from repro_torch.serving.server import EnsembleServer

    config, mix = cell.config, cell.traffic
    members = cell.members
    schedule = tr.make_schedule(mix, config, seed, beds)
    n_beds = schedule.n_beds
    pool = tr.make_pool(mix, config, seed)
    rows = len(pool.ecg)
    L = members[0]["input_len"]
    W = int(round(config["vitals_hz"] * config["window_seconds"]))
    prefill = int(round(config["window_seconds"] / mix["chunk_seconds"]))
    pre, drain = float(mix["pre_seconds"]), float(mix["drain_seconds"])
    cuda = device.type == "cuda"

    # ---- set-up: weights, side models, service, rings, server
    params = make_params(members, seed, device)
    fit = side_data(config, seed)
    vit, labs = _side_models(config, seed, fit)
    svc = EnsembleService([ZooMember(s, p) for s, p
                           in zip(_specs(members), params)],
                          vitals_model=vit, labs_model=labs, device=device)
    svc.warmup(batch_sizes=RUNGS)
    di = DeviceIngest(_modalities(config), n_beds,
                      float(config["window_seconds"]), device=device)
    di.warm_gather((L,), RUNGS)
    di.warm_gather((W,), RUNGS, modality="vitals")
    book = tr.FeedBook(schedule, rows, prefill)
    for bed in range(n_beds):
        r = book.rows_of(bed, 0, prefill)
        di.ingest(0.0, bed, "ecg", np.concatenate(pool.ecg[r], axis=-1))
        di.ingest(0.0, bed, "vitals", np.concatenate(pool.vitals[r], axis=-1))
    _warm_flushes(svc, config, pool, prefill, device)
    prof = None
    tracer = None
    annotate: Callable = lambda name: contextlib.nullcontext()
    if trace:
        from torch.profiler import record_function
        prof = ProfiledSlice(device, float(mix["trace_seconds"]))
        tracer = SpanRecorder(keep=4 * n_beds + 4096)
        annotate = record_function
    scored_at: Dict[int, float] = {}    # qid -> when its score came back

    def handler(batch, _f=svc.predict_batch):
        with annotate(f"bench.flush.{1 << (len(batch) - 1).bit_length()}"):
            scores = _f(batch)
        t = time.monotonic()
        for ref in batch:
            scored_at[ref.extra["qid"]] = t
        return scores
    if cuda:
        torch.cuda.synchronize(device)
    srv = EnsembleServer(batch_handler=handler, tracer=tracer).start()

    # ---- open loop
    T0 = time.monotonic()
    w0, w1 = T0 + pre, T0 + pre + seconds
    setup_s = w0 - t_start
    answers: Dict[int, tuple] = {}
    shed: List[int] = []
    late: List[float] = []
    ingest_s: List[float] = []
    window_qids: List[int] = []
    backlog = {}
    batch0 = batch1 = None
    next_poll = T0

    def collect():
        for _, score, lat, ref in srv.results():
            answers[ref.extra["qid"]] = (score, lat)

    for t, kind, bed in schedule.events():
        due = T0 + t
        now = time.monotonic()
        if due > now:
            time.sleep(due - now)
            now = time.monotonic()
        if batch0 is None and now >= w0:
            batch0 = srv.batcher.stats_snapshot()
            backlog["start"] = srv.q.unfinished_tasks
        if batch1 is None and now >= w1:
            batch1 = srv.batcher.stats_snapshot()
            backlog["end"] = srv.q.unfinished_tasks
        if prof is not None:
            if not prof.started and kind == tr.CLOSE \
                    and due >= w1 + TRACE_AFTER_S:
                prof.start()
            elif prof.due_to_stop(now):
                prof.stop()
        in_window = w0 <= due < w1
        if in_window:
            late.append(now - due)
        if kind == tr.CHUNK:
            row = book.chunk(bed)
            if trace and in_window:
                with annotate("bench.ingest"):
                    a = time.perf_counter()
                    di.ingest(t, bed, "ecg", pool.ecg[row])
                    b = time.perf_counter()
                    di.ingest(t, bed, "vitals", pool.vitals[row])
                    c = time.perf_counter()
                ingest_s += [b - a, c - b]
            else:
                di.ingest(t, bed, "ecg", pool.ecg[row])
                di.ingest(t, bed, "vitals", pool.vitals[row])
        else:
            q = book.close(bed, t)
            ref = di.close_window(bed, t, extra={
                "labs": pool.labs[q.labs_row], "qid": q.qid})
            if in_window:
                window_qids.append(q.qid)
            if not srv.submit(bed, ref, t_window=due):
                shed.append(q.qid)
        if now >= next_poll:
            collect()
            next_poll = now + RESULT_POLL_S
            if now >= w1 and (prof is None or prof.stopped):
                done = all(i in answers or i in shed for i in window_qids)
                if done or now >= w1 + drain:
                    break
    if prof is not None:
        prof.stop()
    memory_peak = (torch.cuda.max_memory_allocated(device) if cuda else 0)
    stats = srv.stop()
    deadline = time.monotonic() + ANSWER_WAIT_S
    collect()
    while (any(i not in answers and i not in shed for i in window_qids)
           and time.monotonic() < deadline):
        time.sleep(RESULT_POLL_S)
        collect()
    leaked = list(srv.leaked)

    # ---- what the window saw
    lat, n_ok, n_nan, missing, gap = [], 0, 0, 0, 0.0
    for i in window_qids:
        due = T0 + book.queries[i].due
        score, server_lat = answers.get(i, (None, None))
        ok = (score is not None and np.isfinite(score) and i in scored_at
              and scored_at[i] <= w1 + drain)
        if ok:
            lat.append(scored_at[i] - due)
            gap = max(gap, abs(server_lat - lat[-1]))
            n_ok += 1
        else:
            lat.append(w1 + drain - due)
        if score is None:
            missing += 1
        elif not np.isfinite(score):
            n_nan += 1
    attempted = len(window_qids)
    load = {
        "beds": n_beds, "offered_per_s": n_beds / schedule.period,
        "late_p50_ms": 1e3 * percentile(late, 50),
        "late_p95_ms": 1e3 * percentile(late, 95),
        "late_max_ms": 1e3 * max(late),
        "backlog_start": backlog.get("start"),
        "backlog_end": backlog.get("end"),
        "p50_first_third_ms": 1e3 * percentile(lat[:max(1, len(lat) // 3)], 50),
        "p50_last_third_ms": 1e3 * percentile(lat[-max(1, len(lat) // 3):], 50),
        "server_latency_gap_ms": 1e3 * gap,
        "shed": len(shed), "server_served": stats.served,
        "server_failed": stats.failed, "leaked_threads": leaked,
    }
    obs = {"seconds": seconds, "setup_s": setup_s, "latency_s": lat,
           "scored": n_ok, "members": members, "peak_flop_s": TF32_FLOP_S}
    if trace:
        summary = prof.summary()
        if summary is not None:
            ops = sorted(f["ops"] for f in summary["flushes"])
            log(f"trace: {prof.t1 - prof.t0:.3f} s profiled, "
                f"{len(ops)} whole flushes, device ops a flush "
                f"{ops[:1]}..{ops[-1:]}, rungs "
                f"{sorted(f['ppad'] for f in summary['flushes'])}")
        obs.update({
            "spans": [s for s in tracer.spans() if w0 <= s.t_submit < w1],
            "ingest_s": ingest_s,
            "batcher": {"items": batch1.n_items - batch0.n_items,
                        "flushes": batch1.n_flushes - batch0.n_flushes},
            "trace": summary})

    # ---- free the program's state, then the reference
    del prof
    served = {i: answers[i][0] for i in window_qids
              if i in answers and np.isfinite(answers[i][0])}
    del srv, svc, di, handler, vit, labs
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    err, worst = check(cell, book, pool, params, fit, seed, served, device)
    checks = judged(config, err, missing, n_nan, len(leaked))
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = reader(m["name"])(obs)
        if v is not None:
            metrics[m["name"]] = (v, m["unit"])
    load.update(checked=len(served),
                check_seconds=time.perf_counter() - t_check,
                worst_query=worst, setup_s=setup_s,
                score_p50_ms=1e3 * percentile(lat, 50),
                score_p95_ms=1e3 * percentile(lat, 95))
    return {
        "correct": bool(correct), "attempted": attempted,
        "failed": attempted - n_ok, "metrics": metrics,
        "memory_peak_bytes": int(memory_peak), "load": load,
        "checks": checks, "setup_s": setup_s,
        "latency_ms": [1e3 * x for x in lat],
        "score_p50_ms": load["score_p50_ms"],
        **ProfiledSlice.fields(obs.get("trace")),
    }


def describe(out: Dict) -> List[str]:
    """The census the run offered, how late the generator ran, the
    backlog and shed queries, then every window query's latency."""
    load = out["load"]
    return [
        f"load: {load['beds']} beds, {load['offered_per_s']:.3f} windows/s; "
        f"generator late p50 {load['late_p50_ms']:.3f} ms, p95 "
        f"{load['late_p95_ms']:.3f} ms, max {load['late_max_ms']:.3f} ms; "
        f"backlog {load['backlog_start']} -> {load['backlog_end']}; "
        f"shed {load['shed']}",
        "latencies_ms (due order) " + json.dumps(
            [round(x, 3) for x in out["latency_ms"]])]


def reference_scores(cell: Cell, book: tr.FeedBook, pool: tr.Pool,
                     params: List[Dict], fit: Dict, seed: int,
                     queries: List[tr.Query], device: torch.device,
                     tf32: bool = False) -> np.ndarray:
    """The plain reference's score of each query, from the windows the
    harness fed, the harness's weights, and side models refitted from
    the same seeded data."""
    config, members = cell.config, cell.members
    L = members[0]["input_len"]
    W = int(round(config["vitals_hz"] * config["window_seconds"]))
    vit, labs = _ref_side_models(config, seed, fit)
    out = np.zeros(len(queries))
    for s in range(0, len(queries), BLOCK):
        qs = queries[s:s + BLOCK]
        ecg = torch.from_numpy(np.stack(
            [tr.window(book, pool.ecg, q, L) for q in qs])).to(device)
        probs = member_probs(members, params, ecg, tf32=tf32)
        vw = np.stack([tr.window(book, pool.vitals, q, W) for q in qs])
        lw = np.stack([pool.labs[q.labs_row] for q in qs])
        out[s:s + BLOCK] = eq5(probs, vw, lw, vit, labs)
    return out


def judged(config: Dict, err: float, missing: int, n_nan: int,
           leaked: int) -> Dict:
    """Every number the check compares, beside its limit."""
    return {
        "max_abs_err": {"value": err, "limit": config["score_abs_limit"]},
        "unanswered": {"value": missing, "limit": 0},
        "nan_scores": {"value": n_nan, "limit": 0},
        "leaked_threads": {"value": leaked, "limit": 0},
    }


def check(cell: Cell, book: tr.FeedBook, pool: tr.Pool, params, fit: Dict,
          seed: int, served: Dict[int, float], device: torch.device):
    """Widest gap between a served score and the reference's, and the
    query that gave it."""
    if not served:
        return float("inf"), None
    qids = sorted(served)
    queries = [book.queries[i] for i in qids]
    ref = reference_scores(cell, book, pool, params, fit, seed, queries,
                           device)
    gap = np.abs(np.array([served[i] for i in qids]) - ref)
    j = int(np.argmax(gap))
    return float(gap[j]), {"qid": qids[j], "bed": queries[j].bed,
                           "served": served[qids[j]],
                           "reference": float(ref[j])}


def control_reading(cell: Cell, seed: int, seconds: float,
                    device: torch.device, beds: Optional[int] = None
                    ) -> Dict:
    """The check's control: the reference put in the program's place and
    computed in TF32 (the precision below the configuration's float32
    with TF32 off), its scores handed as the served ones to the run's
    own ``check`` over the queries a run of ``seconds`` compares.  It
    has to come out not correct; its widest gap is the check's upper
    reading."""
    config, mix = cell.config, cell.traffic
    schedule = tr.make_schedule(mix, config, seed, beds)
    pool = tr.make_pool(mix, config, seed)
    prefill = int(round(config["window_seconds"] / mix["chunk_seconds"]))
    pre = float(mix["pre_seconds"])
    book, queries = tr.offline_queries(schedule, len(pool.ecg), prefill,
                                       pre, pre + seconds)
    params = make_params(cell.members, seed, device)
    fit = side_data(config, seed)
    got = reference_scores(cell, book, pool, params, fit, seed, queries,
                           device, tf32=True)
    served = {q.qid: float(x) for q, x in zip(queries, got)
              if np.isfinite(x)}
    err, worst = check(cell, book, pool, params, fit, seed, served, device)
    checks = judged(config, err, 0, len(queries) - len(served), 0)
    return {"seed": seed, "queries": len(queries),
            "correct": all(c["value"] <= c["limit"]
                           for c in checks.values()),
            "worst_query": worst, "checks": checks}
