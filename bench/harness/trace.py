"""A ``torch.profiler`` slice of a run (``ProfiledSlice``), and the
reduction of its chrome trace to what the per-layer metrics and the
``breakdown`` read.

Device operations are the trace's ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events.  Each is tied to the host call that launched it
through its ``correlation`` id, and so to the harness's
``bench.flush.<rung>`` annotation open on that thread at the launch: a
flush whose annotation the trace holds whole had all its operations
traced (it ends in the score copy, which waits for them).  A flush the
slice's start or end cuts through is left out."""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional

from bench.harness.stats import gaps as _gaps
from bench.harness.stats import union_length

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
API = "cuda_"          # the CUDA API calls: runtime and lower-level
FLUSH = "bench.flush."
TOP = 10
EDGE_US = 100.0      # a whole flush starts and ends this far inside


def _all_threads() -> Dict:
    """Profiler options that record every thread of the process, those
    started before the profiler too, where this PyTorch has the option."""
    try:
        from torch._C._profiler import _ExperimentalConfig
        return {"experimental_config": _ExperimentalConfig(
            profile_all_threads=True)}
    except (ImportError, TypeError):
        return {}


class ProfiledSlice:
    """One ``torch.profiler`` slice of every thread, started and stopped
    at the instants the runner chooses.  Made in set-up: the profiler's
    own start-up runs then, once, outside the window."""

    def __init__(self, device, seconds: float):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.cuda = device.type == "cuda"
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if self.cuda else [])
        kw = _all_threads()
        with profile(activities=acts, **kw):    # the profiler's start-up
            torch.zeros(1, device=device).add_(1)
        self.prof = profile(activities=acts, **kw)
        self.seconds = seconds
        self.t0 = self.t1 = 0.0

    @property
    def started(self) -> bool:
        return bool(self.t0)

    @property
    def stopped(self) -> bool:
        return bool(self.t1)

    def start(self) -> None:
        self.prof.start()
        self.t0 = time.monotonic()

    def due_to_stop(self, now: float) -> bool:
        """Started, not stopped, and ``seconds`` past the start."""
        return self.started and not self.stopped \
            and now >= self.t0 + self.seconds

    def stop(self) -> None:
        if self.started and not self.stopped:
            self.prof.stop()
            self.t1 = time.monotonic()

    def summary(self) -> Optional[Dict]:
        """``summarize`` of the slice's chrome trace, through a temporary
        file freed at once; ``None`` without a device trace."""
        if not (self.cuda and self.stopped):
            return None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            return summarize(load_events(path))
        finally:
            os.remove(path)

    @staticmethod
    def fields(summary: Optional[Dict]) -> Dict:
        """A runner's ``busy_s``, ``window_s`` and ``breakdown`` from a
        ``summary``; nothing without one."""
        if summary is None:
            return {}
        return {"busy_s": summary["busy_s"], "window_s": summary["window_s"],
                "breakdown": {"device_ops": summary["device_ops"],
                              "idle_gaps": summary["idle_gaps"]}}


def load_events(path: str) -> List[Dict]:
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"]
                if e.get("ph") == "X" and "dur" in e]


def summarize(events: List[Dict]) -> Optional[Dict]:
    """The traced slice's length and device busy time (seconds), the
    operations and kernel seconds of each whole flush, the device
    operations that took most time, and the idle time by what the host
    was doing."""
    dev, host = [], defaultdict(list)
    launch = {}
    flushes = defaultdict(list)
    t0, t1 = float("inf"), float("-inf")
    for e in events:
        cat, ts, dur = e.get("cat", ""), float(e["ts"]), float(e["dur"])
        t0, t1 = min(t0, ts), max(t1, ts + dur)
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur, e["name"],
                        e.get("args", {}).get("correlation")))
        elif cat in HOST_CATS or cat.startswith(API):
            tid = e.get("tid")
            host[tid].append((ts, ts + dur, e["name"], cat))
            if cat.startswith(API):
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launch[corr] = (tid, ts)
            if cat == "user_annotation" and e["name"].startswith(FLUSH):
                flushes[tid].append((ts, ts + dur,
                                     int(e["name"][len(FLUSH):])))
    if not dev:
        return None
    for tid in list(flushes):
        flushes[tid] = sorted(f for f in flushes[tid] if f[0] > t0 + EDGE_US
                              and f[1] < t1 - EDGE_US)
    starts = {tid: [f[0] for f in fs] for tid, fs in flushes.items()}
    thread = _thread_map(launch, host)
    per_flush: Dict = {}
    by_name: Dict[str, float] = defaultdict(float)
    for s, e, name, corr in dev:
        by_name[name] += (e - s) * 1e-6
        where = launch.get(corr)
        if where is None:
            continue
        tid, ts = thread.get(where[0], where[0]), where[1]
        if tid not in flushes:
            continue
        i = bisect.bisect_right(starts[tid], ts) - 1
        if i < 0 or ts > flushes[tid][i][1]:
            continue
        rec = per_flush.setdefault((tid, i), {
            "ppad": flushes[tid][i][2], "ops": 0, "kernel_s": defaultdict(float)})
        rec["ops"] += 1
        rec["kernel_s"][name] += (e - s) * 1e-6
    intervals = [(s, e) for s, e, _, _ in dev]
    idle = _gaps(intervals, t0, t1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": (t1 - t0) * 1e-6,
        "busy_s": union_length(intervals) * 1e-6,
        "flushes": [{"ppad": r["ppad"], "ops": r["ops"],
                     "kernel_s": dict(r["kernel_s"])}
                    for r in per_flush.values()],
        "device_ops": [[n[:120], s] for n, s in top],
        "idle_gaps": _label_idle(idle, host),
    }


def _thread_map(launch: Dict, host: Dict) -> Dict:
    """Host thread of each launching thread id.  The trace may name a
    thread differently in its runtime events and in its PyTorch events;
    a runtime call then falls inside that thread's PyTorch events, so
    each runtime id maps to the thread whose events hold most of its
    calls (an id the PyTorch events also use maps to itself)."""
    spans = {}
    for tid, evs in host.items():
        top, end = [], float("-inf")
        for s, e, _, cat in sorted(evs):
            if cat in ("cpu_op", "user_annotation") and s >= end:
                top.append((s, e))
                end = e
        spans[tid] = top
    by_rt = defaultdict(list)
    for tid, ts in launch.values():
        by_rt[tid].append(ts)
    out = {}
    for rt, times in by_rt.items():
        if spans.get(rt):
            out[rt] = rt
            continue
        votes = defaultdict(int)
        for ts in times[::max(1, len(times) // 500)]:
            for tid, top in spans.items():
                i = bisect.bisect_right(top, (ts, float("inf"))) - 1
                if i >= 0 and top[i][1] >= ts:
                    votes[tid] += 1
        if votes:
            out[rt] = max(votes, key=votes.get)
    return out


def _label_idle(idle, host) -> List[List]:
    """Idle seconds by what the host was doing at each gap's middle: the
    innermost traced host event on the thread inside a harness
    annotation (a flush before an ingest), summed by label."""
    mids = sorted(((s + e) / 2, i) for i, (s, e) in enumerate(idle))
    label = ["no traced host op"] * len(idle)
    rank = [-1] * len(idle)
    for evs in host.values():
        evs.sort(key=lambda x: (x[0], -x[1]))
        stack, k = [], 0
        for m, gi in mids:
            while k < len(evs) and evs[k][0] <= m:
                while stack and stack[-1][1] <= evs[k][0]:
                    stack.pop()
                stack.append(evs[k])
                k += 1
            while stack and stack[-1][1] <= m:
                stack.pop()
            if not stack:
                continue
            outer = next((x[2] for x in stack if x[3] == "user_annotation"
                          and x[2].startswith("bench.")), None)
            r = 0 if outer is None else (2 if outer.startswith(FLUSH) else 1)
            if r > rank[gi]:
                rank[gi] = r
                kind = "host" if outer is None else outer.split(".")[1]
                inner = stack[-1][2]
                if inner == outer:
                    inner = "python between ops"
                label[gi] = f"{kind}: {inner}"[:120]
    total: Dict[str, float] = defaultdict(float)
    for (s, e), lab in zip(idle, label):
        total[lab] += (e - s) * 1e-6
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]
