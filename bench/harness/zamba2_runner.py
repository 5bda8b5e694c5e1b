"""One run of a decode cell of the published Zamba2 (``"runner":
"zamba2_runner"``): the port's ``Zamba2Config`` served through its own
LM path, open loop, lock step, and every logit the window produced held
to the plain reference.  It runs that model only: ``program_config``
reads the Zamba2 keys of the configuration file and the reference is
``bench/reference/zamba2.py``, so another LM needs a runner of its own.

Set-up draws the weights on the card from the seed (``make_params``, in
the program's layout), allocates one cache for every session at the
configuration's ``max_position_embeddings`` and a buffer for every
step's logits, and prefills the sessions' prompts (token ids uniform
over the vocabulary, from the seed) in groups of ``prefill_group`` into
that cache (``prefill(..., cache=, rows=)``).  Then step n of every
session is due at ``t0 + n / step_rate``; each step is one
``launch.serve.greedy_step`` of the whole batch, the port's own decode
loop, and each session's part of it is one request, retired when its
greedy token is on the host.  The steps due in the ``pre_seconds``
before the window warm every shape and count as set-up.  A request's
latency runs from its step's due instant to its retirement, both on the
harness's clock; a step runs at once when it is late, and a plain run
stops offering steps once the window's drain limit has passed.

The check runs after the window with the program's cache freed: the
plain reference (``bench/reference/zamba2.py``), teacher-forced on each
session's prompt and the tokens the program generated, gives the logits
at the last prompt position and at every position the program decoded
in the window.  ``logit_err`` is the largest over those positions of
``max |program - reference| / RMS(reference)``.

A traced run keeps each window step's span tree (``lm.step`` and its
children, with its ``kv_positions`` and ``launches`` counters).  Past
the window it offers the steps due over ``TRACE_AFTER_S +
trace_seconds`` more and profiles a slice of ``trace_seconds`` of them,
starting at the first step due a second after the window; then it runs
the last set-up prefill group again, profiled (the window holds no
prefill; the rows it rewrites are not read again).  Nothing of the
profiler runs before the window ends: it slows the host several-fold
while it records, and its stop takes seconds.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import gc
import math
import os
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from bench.counts.peaks import HBM_BYTES_S, TF32_FLOP_S
from bench.harness import trace as tr
from bench.harness.cells import Cell, reader
from bench.harness.stats import percentile
from bench.reference.zamba2 import Zamba2

TRACE_AFTER_S = 1.0     # the profiled slice starts this long after the
                        # window, at the first step due then
STEP = "holmes.lm.step"
SHARED = "holmes.lm.shared"
DECODE_KERNELS = ("decode_split_kernel", "decode_mma_kernel",
                  "decode_combine_kernel")
FLASH_KERNEL = "flash_prefill_kernel"


# ------------------------------------------------------------------ set-up
def program_config(config: Dict):
    """The program's configuration of the cell's model: the registry's
    ``config["arch"]`` with the sizes of the configuration file (so a cut
    of the file is a cut of the model); the scan's chunk is the ``ssd``
    kernel's tile, a blocking of the same recurrence."""
    from repro_torch.configs.base import SSMConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.ssd import MAX_CHUNK
    c = config
    if int(c["attention_hidden_size"]) != int(c["num_attention_heads"]) \
            * int(c["attention_head_dim"]):
        raise ValueError("attention_hidden_size is not heads x head dim")
    return dataclasses.replace(
        get_config(c["arch"]), num_layers=int(c["num_hidden_layers"]),
        d_model=int(c["hidden_size"]), n_heads=int(c["num_attention_heads"]),
        n_kv_heads=int(c["num_key_value_heads"]),
        head_dim=int(c["attention_head_dim"]),
        d_ff=int(c["intermediate_size"]), vocab_size=int(c["vocab_size"]),
        rope_theta=float(c["rope_theta"]), norm_eps=float(c["rms_norm_eps"]),
        ssm=SSMConfig(d_state=int(c["mamba_d_state"]),
                      head_dim=int(c["mamba_headdim"]),
                      expand=int(c["mamba_expand"]),
                      conv_width=int(c["mamba_d_conv"]),
                      n_groups=int(c["mamba_ngroups"]),
                      chunk=min(int(c["chunk_size"]), MAX_CHUNK)),
        hybrid_layer_ids=tuple(int(i) for i in c["hybrid_layer_ids"]),
        num_mem_blocks=int(c["num_mem_blocks"]),
        adapter_rank=int(c["adapter_rank"]))


def _draw(g: torch.Generator, shape: Sequence[int], kind: str,
          device: torch.device) -> torch.Tensor:
    """One leaf, drawn on ``device``: weights ``N(0, 1)`` clipped at
    +-2 over the square root of their fan-in (a matrix's input width,
    a conv's taps, the table's width); norm scales and ``D`` ``1 + 0.1
    n``; conv biases ``0.1 n``; ``A_log = log U(1, 16)``; ``dt_bias``
    the inverse softplus of ``dt = exp U(log 1e-3, log 1e-1)``, at least
    1e-4."""
    if kind in ("A_log", "dt_bias"):
        u = torch.rand(tuple(shape), generator=g, device=device)
        if kind == "A_log":
            return u.mul_(15.0).add_(1.0).log_()
        dt = u.mul_(math.log(100.0)).add_(math.log(1e-3)).exp_().clamp_(
            min=1e-4)
        return dt + torch.log(-torch.expm1(-dt))
    n = torch.randn(tuple(shape), generator=g, device=device).clamp_(-2, 2)
    fan = {"w": -2, "conv": -3, "table": -1}.get(kind)
    if fan is not None:
        return n.mul_(shape[fan] ** -0.5)
    n.mul_(0.1)
    return n.add_(1.0) if kind in ("norm", "D") else n


def make_params(pcfg, seed: int, device: torch.device) -> Dict:
    """Every leaf of the program's params tree (``models/zamba2.py``
    ``layout``), drawn on ``device`` from one generator seeded with
    ``seed``."""
    from repro_torch.models.zamba2 import layout
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2 ** 63)
    params: Dict = {}
    for path, shape, kind in layout(pcfg):
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = _draw(g, shape, kind, device)
    return params


def make_prompts(mix: Dict, config: Dict, seed: int) -> np.ndarray:
    """``[sessions, prompt_tokens]`` token ids, uniform over the
    vocabulary, from the seed."""
    rng = np.random.default_rng([int(seed) % 2 ** 63, 7])
    return rng.integers(0, int(config["vocab_size"]),
                        (int(mix["sessions"]), int(mix["prompt_tokens"])),
                        dtype=np.int64).astype(np.int32)


def offered_steps(mix: Dict, seconds: float, trace: bool = False) -> int:
    """Steps due before the window ends, n = 1, 2, ... with ``n /
    step_rate < pre_seconds + seconds``; with ``trace`` also those due
    before the profiled slice after the window ends (``TRACE_AFTER_S +
    trace_seconds`` more)."""
    rate = float(mix["step_rate"])
    end = float(mix["pre_seconds"]) + seconds
    if trace:
        end += TRACE_AFTER_S + float(mix["trace_seconds"])
    return math.ceil(end * rate) - 1


# ------------------------------------------------------------------ trace
def _profile(prof: tr.ProfiledSlice) -> Optional[List[Dict]]:
    """The chrome trace's complete events of a stopped slice (through a
    temporary file freed at once); None without a device trace."""
    if not (prof.cuda and prof.stopped):
        return None
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.prof.export_chrome_trace(path)
        return tr.load_events(path)
    finally:
        os.remove(path)


def step_trace(events: List[Dict]) -> Dict:
    """Device operations and seconds of the ``holmes.lm.step`` ranges
    the slice holds whole (operations counted by the instant they were
    launched), the part launched inside ``holmes.lm.shared``, and the
    ``decode_attention`` kernels' calls and seconds there."""
    t0 = min(float(e["ts"]) for e in events)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in events)
    steps, shared, launch, dev = [], [], {}, []
    for e in events:
        cat, ts, dur = e.get("cat", ""), float(e["ts"]), float(e["dur"])
        if cat == "user_annotation" and e["name"] == STEP \
                and ts > t0 + tr.EDGE_US and ts + dur < t1 - tr.EDGE_US:
            steps.append((ts, ts + dur))
        elif cat == "user_annotation" and e["name"] == SHARED:
            shared.append((ts, ts + dur))
        elif cat.startswith(tr.API):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch[corr] = ts
        elif cat in tr.DEVICE_CATS:
            dev.append((e["name"], dur * 1e-6,
                        e.get("args", {}).get("correlation")))

    steps.sort()
    shared.sort()

    def inside(ts, ranges):             # ranges sorted and disjoint
        i = bisect.bisect_right(ranges, (ts, float("inf"))) - 1
        return i >= 0 and ranges[i][1] >= ts

    out = {"steps": len(steps), "ops": 0, "step_device_s": 0.0,
           "shared_device_s": 0.0, "decode_calls": 0, "decode_s": 0.0}
    for name, sec, corr in dev:
        ts = launch.get(corr)
        if ts is None or not inside(ts, steps):
            continue
        out["ops"] += 1
        out["step_device_s"] += sec
        if inside(ts, shared):
            out["shared_device_s"] += sec
        if any(k in name for k in DECODE_KERNELS):
            out["decode_s"] += sec
            out["decode_calls"] += "combine" not in name
    return out


def prefill_trace(events: List[Dict], D: int, Dv: int) -> Dict:
    """The ``flash_attention`` kernels of one profiled prefill group at
    head dims ``(D, Dv)``: their calls and device seconds."""
    tag = f"{FLASH_KERNEL}<{D}, {Dv}>"
    secs = [float(e["dur"]) * 1e-6 for e in events
            if e.get("cat") == "kernel" and tag in e["name"]]
    return {"calls": len(secs), "device_s": sum(secs)}


# -------------------------------------------------------------------- run
def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float, beds: Optional[int] = None
        ) -> Dict:
    """One run, as the runner contract of ``bench/harness/cells.py``
    has it; besides, ``step_latency_ms`` (each window step's latency, in
    due order)."""
    if beds is not None:
        raise ValueError(f"{cell.name}: an LM decode cell has no census "
                         "(--beds)")
    config, mix = cell.config, cell.traffic
    pcfg = program_config(config)
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import greedy_step
    from repro_torch.models.api import get_model
    from repro_torch.models.runtime import RuntimeOptions
    from repro_torch.obs.spans import collect

    n_sess, S = int(mix["sessions"]), int(mix["prompt_tokens"])
    M = int(config["max_position_embeddings"])
    rate = float(mix["step_rate"])
    pre, drain = float(mix["pre_seconds"]), float(mix["drain_seconds"])
    n_max = offered_steps(mix, seconds, trace)
    if S + n_max > M:
        raise ValueError(f"{cell.name}: {S} prompt positions and {n_max} "
                         f"steps exceed the {M} positions of the cache")
    cuda = device.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _build.LIBRARY.get()
    rt = RuntimeOptions()
    model = get_model(pcfg)

    # ---- set-up: weights, prompts, cache, logits buffer, prefill
    t = time.perf_counter()
    params = make_params(pcfg, seed, device)
    prompts = make_prompts(mix, config, seed)
    cache = model.init_cache(pcfg, rt, n_sess, M, device)
    logits = torch.empty((n_max + 1, n_sess, pcfg.padded_vocab),
                         device=device)
    weights_s = time.perf_counter() - t
    group = int(mix["prefill_group"])
    tok_dev = torch.from_numpy(prompts).to(device)
    sink = (lambda kind, ident: collect(kind, ident)) if trace else \
        (lambda kind, ident: contextlib.nullcontext())
    t = time.perf_counter()
    for g0 in range(0, n_sess, group):
        rows = slice(g0, min(n_sess, g0 + group))
        with sink("lm.prefill", g0):
            lg, cache = model.prefill(params, tok_dev[rows], pcfg, rt,
                                      cache=cache, rows=rows)
        logits[0, rows] = lg
    del lg
    tok = torch.argmax(logits[0], -1).to(torch.int32)
    out_tokens = [tok.cpu().numpy()]
    prefill_s = time.perf_counter() - t

    # ---- open loop
    step_prof = None
    T0 = time.monotonic()
    w0, w1 = T0 + pre, T0 + pre + seconds
    setup_s = w0 - t_start
    due_of = [T0 + n / rate for n in range(n_max + 1)]
    window = [n for n in range(1, n_max + 1) if w0 <= due_of[n] < w1]
    retired: Dict[int, float] = {}
    finite: Dict[int, np.ndarray] = {}
    late: List[float] = []
    steps, traced = [], []
    backlog_end = None
    for n in range(1, n_max + 1):
        now = time.monotonic()
        if due_of[n] > now:
            time.sleep(due_of[n] - now)
            now = time.monotonic()
        if now >= w1 + drain and not trace:
            break                   # a traced run goes on to its slice
        if backlog_end is None and now >= w1:
            backlog_end = sum(1 for m in window if m >= n)
        if trace and step_prof is None and due_of[n] >= w1:
            step_prof = tr.ProfiledSlice(device,
                                         float(mix["trace_seconds"]))
        if step_prof is not None:
            if not step_prof.started and due_of[n] >= w1 + TRACE_AFTER_S:
                step_prof.start()
            elif step_prof.due_to_stop(now):
                step_prof.stop()
        in_window = w0 <= due_of[n] < w1
        if in_window:
            late.append(now - due_of[n])
        recording = step_prof is not None and step_prof.started \
            and not step_prof.stopped
        trees = None
        if trace:                   # a pre-window step's tree is dropped
            trees = traced if recording else steps if in_window else []
        lg, tok, cache = greedy_step(model, params, cache, tok, pcfg, rt,
                                     trees=trees)
        logits[n].copy_(lg)
        host = torch.cat([tok, torch.isfinite(lg).all(-1).to(torch.int32)]
                         ).cpu().numpy()
        retired[n] = time.monotonic()
        out_tokens.append(host[:n_sess])
        finite[n] = host[n_sess:].astype(bool)
    if backlog_end is None:
        backlog_end = 0
    events = None
    if step_prof is not None:
        step_prof.stop()
        # read before another profiler runs: read after one, its device
        # times came out 0 on the card
        events = _profile(step_prof)
        del step_prof
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    positions_end = cache["idx"]
    steps_traced = len(traced)
    pre_events = None
    if trace:                   # the last prefill group again, profiled
        pre_prof = tr.ProfiledSlice(device, 0.0)
        pre_prof.start()
        model.prefill(params, tok_dev[rows], pcfg, rt, cache=cache,
                      rows=rows)
        if cuda:
            torch.cuda.synchronize(device)
        pre_prof.stop()
        pre_events = _profile(pre_prof)
        del pre_prof
    del tok_dev

    # ---- what the window saw
    lat, step_lat, n_ok, missing = [], [], 0, 0
    for n in window:
        if n in retired and retired[n] <= w1 + drain:
            x = retired[n] - due_of[n]
            n_ok += int(finite[n].sum())
        else:
            x = w1 + drain - due_of[n]
            missing += n_sess
        step_lat.append(x)
        lat += [x] * n_sess
    nan_rows = sum(int((~finite[n]).sum()) for n in window if n in finite)
    attempted = n_sess * len(window)
    obs = {"seconds": seconds, "setup_s": setup_s, "latency_s": lat,
           "scored": n_ok, "config": config, "sessions": n_sess,
           "peak_flop_s": TF32_FLOP_S, "hbm_bytes_s": HBM_BYTES_S}
    if trace:
        summary = tr.summarize(events) if events else None
        obs.update({"steps": steps, "traced_steps": traced,
                    "step_trace": step_trace(events) if events else None,
                    "prefill_trace": None if pre_events is None else dict(
                        prefill_trace(pre_events, pcfg.head_dim,
                                      pcfg.head_dim),
                        batch=rows.stop - rows.start, S=S),
                    "trace": summary})

    # ---- free the program's state, then the reference
    decoded = sorted(retired)
    seqs = np.concatenate([prompts, np.stack(out_tokens[:len(decoded)], 1)],
                          axis=1)
    del cache, model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    compare = [0] + [n for n in window if n in retired]
    err, worst = check(config, params, seqs, S, logits, compare, device)
    checks = judged(config, err, missing, nan_rows + int(
        (~torch.isfinite(logits[0]).all(-1)).sum()))
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = reader(m["name"])(obs)
        if v is not None:
            metrics[m["name"]] = (v, m["unit"])
    load = {
        "sessions": n_sess, "prompt_tokens": S, "step_rate": rate,
        "offered_tokens_per_s": n_sess * rate, "window_steps": len(window),
        "steps_run": len(decoded), "positions_end": positions_end,
        "late_p50_ms": 1e3 * percentile(late, 50) if late else None,
        "late_p95_ms": 1e3 * percentile(late, 95) if late else None,
        "late_max_ms": 1e3 * max(late) if late else None,
        "backlog_end": backlog_end, "weights_s": weights_s,
        "prefill_s": prefill_s, "setup_s": setup_s,
        "token_p50_ms": 1e3 * percentile(lat, 50),
        "token_p95_ms": 1e3 * percentile(lat, 95),
        "p50_first_third_ms": 1e3 * percentile(
            step_lat[:max(1, len(step_lat) // 3)], 50),
        "p50_last_third_ms": 1e3 * percentile(
            step_lat[-max(1, len(step_lat) // 3):], 50),
        "steps_traced": steps_traced if trace else None,
        "device_ops_per_step": (
            obs["step_trace"]["ops"] / obs["step_trace"]["steps"]
            if trace and obs["step_trace"] and obs["step_trace"]["steps"]
            else None),
        "checked_positions": len(compare) * n_sess,
        "check_seconds": time.perf_counter() - t_check,
        "worst_position": worst,
    }
    return {
        "correct": bool(correct), "attempted": attempted,
        "failed": attempted - n_ok, "metrics": metrics,
        "memory_peak_bytes": int(memory_peak), "load": load,
        "checks": checks, "setup_s": setup_s,
        "step_latency_ms": [1e3 * x for x in step_lat],
        **tr.ProfiledSlice.fields(obs.get("trace")),
    }


def describe(out: Dict) -> List[str]:
    """What the run offered, how late its steps started, the backlog at
    the window's end, then every window step's latency."""
    ld = out["load"]
    fmt = (lambda v: "-" if v is None else f"{v:.3f}")
    return [
        f"load: {ld['sessions']} sessions at {ld['prompt_tokens']} prompt "
        f"tokens, {ld['step_rate']} steps/s ({ld['offered_tokens_per_s']} "
        f"tokens/s); {ld['window_steps']} window steps, {ld['steps_run']} "
        f"run, positions at the end {ld['positions_end']}; steps late p50 "
        f"{fmt(ld['late_p50_ms'])} ms, p95 {fmt(ld['late_p95_ms'])} ms, max "
        f"{fmt(ld['late_max_ms'])} ms; backlog at the window's end "
        f"{ld['backlog_end']}; set-up: weights {ld['weights_s']:.2f} s, "
        f"prefill {ld['prefill_s']:.2f} s",
        "step_latencies_ms (due order) " + str(
            [round(x, 3) for x in out["step_latency_ms"]])]


# ------------------------------------------------------------------ check
def judged(config: Dict, err: float, missing: int, n_nan: int) -> Dict:
    """Every number the check compares, beside its limit."""
    return {
        "logit_err": {"value": err, "limit": config["logit_err_limit"]},
        "unanswered": {"value": missing, "limit": 0},
        "nan_logits": {"value": n_nan, "limit": 0},
    }


def check(config: Dict, params: Dict, seqs: np.ndarray, S: int,
          logits: torch.Tensor, compare: Sequence[int],
          device: torch.device, tf32: bool = False):
    """``logit_err`` of ``logits[n]`` (step n's, at position ``S - 1 +
    n``) for every n in ``compare``, against the reference teacher-forced
    on ``seqs`` (each session's prompt and generated tokens); and where
    the worst was."""
    if not compare:
        return float("inf"), None
    ref = Zamba2(config, params, tf32=tf32)
    err, worst = 0.0, None
    for s in range(seqs.shape[0]):
        T = S + max(compare)
        toks = torch.from_numpy(seqs[s, :T].astype(np.int64)).to(device)
        want = ref.logits(toks, [S - 1 + n for n in compare])
        got = logits[list(compare), s].to(want.device)
        rms = want.square().mean(-1).sqrt()
        e = ((got - want).abs().amax(-1) / rms).nan_to_num(float("inf"))
        i = int(torch.argmax(e))
        if float(e[i]) > err or worst is None:
            err = max(err, float(e[i]))
            worst = {"session": s, "position": S - 1 + compare[i],
                     "rms": float(rms[i])}
        del want
    return err, worst


def control_reading(cell: Cell, seed: int, seconds: float,
                    device: torch.device) -> Dict:
    """The check's control: the reference computed in TF32 (every
    operand of every product rounded: the precision below the
    configuration's float32) put in the program's place, teacher-forced
    on the prompts and seeded continuations as long as a run of
    ``seconds`` decodes, and judged by the run's own ``check`` at the
    positions such a run compares.  It has to come out not correct; its
    ``logit_err`` is the check's upper reading."""
    config, mix = cell.config, cell.traffic
    pcfg = program_config(config)
    S = int(mix["prompt_tokens"])
    n_max = offered_steps(mix, seconds)
    rate, pre = float(mix["step_rate"]), float(mix["pre_seconds"])
    compare = [0] + [n for n in range(1, n_max + 1)
                     if pre <= n / rate < pre + seconds]
    params = make_params(pcfg, seed, device)
    prompts = make_prompts(mix, config, seed)
    rng = np.random.default_rng([int(seed) % 2 ** 63, 11])
    cont = rng.integers(0, int(config["vocab_size"]),
                        (prompts.shape[0], n_max)).astype(np.int32)
    seqs = np.concatenate([prompts, cont], axis=1)
    ref = Zamba2(config, params, tf32=True)
    logits = torch.empty((n_max + 1, prompts.shape[0], pcfg.padded_vocab),
                         device=device)
    for s in range(prompts.shape[0]):
        toks = torch.from_numpy(seqs[s, :S + n_max].astype(np.int64)).to(
            device)
        logits[compare, s] = ref.logits(toks, [S - 1 + n for n in compare])
    err, worst = check(config, params, seqs, S, logits, compare, device)
    checks = judged(config, err, 0, int(
        (~torch.isfinite(logits[compare]).all(-1)).sum()))
    return {"seed": seed, "positions": len(compare) * prompts.shape[0],
            "correct": all(c["value"] <= c["limit"]
                           for c in checks.values()),
            "worst_position": worst, "checks": checks}
