#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (or
another sm_90a card), ``nvcc`` and PyTorch built for CUDA.  It imports
nothing of JAX or of the JAX package (``src/repro``).  Phases:

1. environment: versions, the card's name and power limit, the build of
   every CUDA kernel from ``src/repro_torch/kernels/csrc``;
2. each kernel against its plain PyTorch version at the main path's
   shapes (``window_gather`` bitwise; both conv entry points within
   rtol = atol = 1e-4 with TF32 off), with its time, the plain
   version's time, the time of one library call where one computes the
   same function, and the least time the card could take (bound);
3. the main path at full width: the 60-member full zoo (30-s windows)
   behind ``StreamingPipeline(device_ingest=True)`` and an
   ``EnsembleServer`` over ``DeviceWindowRef``s, with the launch
   counters reset just before and read just after; then the flush
   latency at P=8 and P=64 and checks against the plain versions;
4. a ``kernels`` JSON line, and the last line
   ``{"ok": true, "device": {...}}``.

``--profile`` adds one traced flush at P=8 and at P=64 after phase 3
(``torch.profiler``): device time by kernel and the card's idle share
of the flush.

Any failed check raises, so the exit code is non-zero and no result line
is printed.  Details (per-shape timings, the nvcc log) go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
TOL = 1e-4                  # rtol = atol for float compute (testing.py)
HBM_BYTES_S = 3.35e12       # H100 SXM device memory rate
FP32_FLOP_S = 67e12         # H100 SXM fp32 outside the tensor cores


def _time_ms(torch, fn, reps: int = 5) -> float:
    """Mean device time of one call, CUDA events around ``reps`` calls
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _conv_calls(spec, inner_width, conv_padding):
    """Every conv of one member's forward pass, in order, as
    ``(layer, L_in, Cin, Cout, K, groups, stride)``."""
    W, K, card = spec.width, spec.kernel_size, spec.cardinality
    inner = inner_width(spec)
    L = spec.input_len
    calls = [("stem", L, 1, W, K, 1, 2)]
    L = conv_padding(L, K, 2, "SAME")[2]
    for i in range(spec.blocks):
        s = 2 if i % 2 == 0 else 1
        calls.append(("reduce", L, W, inner, 1, 1, 1))
        calls.append(("stripe", L, inner, inner, K, card, s))
        L = conv_padding(L, K, s, "SAME")[2]
        calls.append(("expand", L, inner, W, 1, 1, 1))
    return calls


def _conv_bound(np, conv_padding, M, B, L, Cin, Cout, K, groups, stride):
    """(seconds if bytes bound, seconds if fp32 operations bound) for one
    conv: each input read once and the output written once; the FMAs
    that land inside [0, L) (padding taps do no work)."""
    lo, _, L_out = conv_padding(L, K, stride, "SAME")
    li = np.arange(L_out)[:, None] * stride + np.arange(K)[None, :] - lo
    taps = int(((li >= 0) & (li < L)).sum())
    cin_g = Cin // groups
    flops = 2.0 * M * B * Cout * cin_g * taps
    nbytes = 4.0 * (M * B * L * Cin + M * K * cin_g * Cout + M * Cout
                    + M * B * L_out * Cout)
    return nbytes / HBM_BYTES_S, flops / FP32_FLOP_S


def phase_conv(torch, np, F, specs, record):
    """Both conv entry points against the plain version at every conv
    shape of the full zoo; times summed over the calls of one flush."""
    from repro_torch.kernels import conv1d_stripe as kconv
    from repro_torch.kernels import ref
    from repro_torch.kernels.ref import conv_padding
    from repro_torch.models.ecg_resnext import inner_width
    from repro_torch.configs.ecg_zoo import bucket_zoo

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    count = {}                 # shape -> calls in one stacked flush
    for idx in bucket_zoo(specs).values():
        for c in _conv_calls(specs[idx[0]], inner_width, conv_padding):
            count[c[1:]] = count.get(c[1:], 0) + 1
    out = {}
    # (entry point, M, B): the stacked flush at P=8 and P=64, and the
    # per-member oracle pass (M=1, B=1) for the 3-D entry point
    for name, M, B in (("conv1d_stripe_stacked", 3, 8),
                       ("conv1d_stripe_stacked", 3, 64),
                       ("conv1d_stripe", 1, 1)):
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "bytes_s": 0.0, "ops_s": 0.0, "bound_s": 0.0,
               "max_abs_err": 0.0, "calls": 0}
        rows = []
        for (L, Cin, Cout, K, groups, stride), n in sorted(count.items()):
            if name == "conv1d_stripe":
                n *= 3                      # every member of the bucket
            cin_g = Cin // groups
            x = torch.randn((M, B, L, Cin), device=dev, generator=gen)
            w = torch.randn((M, K, cin_g, Cout), device=dev,
                            generator=gen) / math.sqrt(K * cin_g)
            b = torch.randn((M, Cout), device=dev, generator=gen)
            if name == "conv1d_stripe":
                run = lambda: kconv.conv1d_stripe(x[0], w[0], b[0], stride,
                                                  groups)
                plain = lambda: ref.conv1d_stripe(x[0], w[0], b[0], stride,
                                                  groups)
            else:
                run = lambda: kconv.conv1d_stripe_stacked(x, w, b, stride,
                                                          groups)
                plain = lambda: ref.conv1d_stripe_stacked(x, w, b, stride,
                                                          groups)
            y, r = run(), plain()
            torch.cuda.synchronize()
            err = float((y.reshape(r.shape) - r).abs().max())
            if not torch.allclose(y.reshape(r.shape), r, rtol=TOL,
                                  atol=TOL):
                raise AssertionError(
                    f"{name} M={M} B={B} L={L} Cin={Cin} Cout={Cout} "
                    f"K={K} groups={groups} stride={stride}: max abs err "
                    f"{err} beyond rtol=atol={TOL}")
            # library yardstick: one cuDNN grouped conv over the
            # pre-padded, channels-first member-folded input
            lo, hi, _ = conv_padding(L, K, stride, "SAME")
            xp = F.pad(x.permute(1, 0, 3, 2).reshape(B, M * Cin, L),
                       (lo, hi)).contiguous()
            wl = w.permute(0, 3, 2, 1).reshape(M * Cout, cin_g, K) \
                .contiguous()
            lib = lambda: F.conv1d(xp, wl, None, stride, 0, 1, M * groups)
            ms, pms, lms = (_time_ms(torch, run), _time_ms(torch, plain),
                            _time_ms(torch, lib))
            bs, os_ = _conv_bound(np, conv_padding, M, B, L, Cin, Cout, K,
                                  groups, stride)
            rows.append({"L": L, "Cin": Cin, "Cout": Cout, "K": K,
                         "groups": groups, "stride": stride, "calls": n,
                         "ms": ms, "plain_ms": pms, "library_ms": lms,
                         "bound_ms": 1e3 * max(bs, os_),
                         "max_abs_err": err})
            tot["ms"] += n * ms
            tot["plain_ms"] += n * pms
            tot["library_ms"] += n * lms
            tot["bytes_s"] += n * bs
            tot["ops_s"] += n * os_
            tot["bound_s"] += n * max(bs, os_)
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            tot["calls"] += n
            del x, w, b, y, r, xp, wl
        print(f"  {name:22s} M={M} B={B:2d}: {len(rows)} shapes, "
              f"{tot['calls']} calls/flush, max abs err "
              f"{tot['max_abs_err']:.3g}; per flush kernel "
              f"{tot['ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms, "
              f"cuDNN {tot['library_ms']:.3f} ms, bound "
              f"{1e3 * tot['bound_s']:.3f} ms", flush=True)
        out[(name, B)] = tot
        record[f"{name}_M{M}_B{B}"] = {"total": tot, "shapes": rows}
    torch.cuda.empty_cache()
    return out


def phase_gather(torch, np, record):
    """``window_gather`` bitwise against the plain version on the ECG
    ring (P=64, L=7500: wraparound, ends < L, partial and zero valid)
    and on the vitals ring (L=30)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import window_gather as kgather

    dev = torch.device("cuda:0")
    rng = np.random.default_rng(SEED)
    out = {}
    for label, C, cap, L in (("ecg", 3, 16384, 7500), ("vitals", 7, 64, 30)):
        N, P = 64, 64
        buf = torch.from_numpy(rng.standard_normal(
            (N, C, cap)).astype(np.float32)).to(dev)
        patients = rng.permutation(N)[:P]
        ends = rng.integers(0, cap, P)
        ends[:8] = rng.integers(0, L, 8)                 # ends < L: wraps
        ends[8:16] = cap - rng.integers(0, L // 2 + 1, 8)  # run wraps
        valid = np.full(P, L)
        valid[16:32] = rng.integers(1, L, 16)            # partial windows
        valid[32:40] = 0                                 # batch padding
        idx = torch.from_numpy(np.stack([patients, ends, valid])
                               .astype(np.int32)).to(dev)
        run = lambda: kgather.window_gather(buf, idx[0], idx[1], idx[2], L)
        plain = lambda: ref.window_gather(buf, idx[0], idx[1], idx[2], L)
        y, r = run(), plain()
        torch.cuda.synchronize()
        if not torch.equal(y, r):
            raise AssertionError(f"window_gather ({label}) differs from "
                                 "the plain version")
        if float(y[32:40].abs().sum()) != 0.0:
            raise AssertionError("window_gather padding rows not zero")
        nbytes = 4.0 * (C * np.minimum(valid, L).sum() + P * C * L
                        + 3 * P)
        rec = {"ms": _time_ms(torch, run, 20),
               "plain_ms": _time_ms(torch, plain, 20),
               "bound_ms": 1e3 * nbytes / HBM_BYTES_S,
               "max_abs_err": float((y - r).abs().max()),
               "P": P, "C": C, "cap": cap, "L": L}
        print(f"  window_gather {label:6s} [{N},{C},{cap}] P={P} L={L}: "
              f"bitwise equal; kernel {rec['ms']:.4f} ms, plain "
              f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms",
              flush=True)
        out[label] = rec
        record[f"window_gather_{label}"] = rec
    return out


def phase_profile(torch, svc, refs, lat, record):
    """Device time by kernel over one traced flush at P=8 and P=64, and
    the idle share of the untraced flush's wall time (p50, phase 3)."""
    from torch.profiler import ProfilerActivity, profile

    for P in (8, 64):
        svc.predict_batch(refs[:P])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            svc.predict_batch(refs[:P])
            torch.cuda.synchronize()
        by_kernel = {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
                by_kernel[e.key] = (us / 1e3, e.count)
        busy = sum(ms for ms, _ in by_kernel.values())
        wall = lat[P]["p50_ms"]
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:8]
        print(f"  profile P={P}: device busy {busy:.2f} ms of a "
              f"{wall:.2f} ms flush (p50) -> idle share "
              f"{(1 - busy / wall if busy else float('nan')):.3f}; "
              f"{sum(n for _, n in by_kernel.values())} device ops",
              flush=True)
        for name, (ms, n) in top:
            print(f"    {ms:9.3f} ms  x{n:5d}  {name[:90]}", flush=True)
        record[f"profile_P{P}"] = {
            "device_busy_ms": busy, "flush_p50_ms": wall,
            "by_kernel": {k: {"ms": ms, "count": n}
                          for k, (ms, n) in by_kernel.items()}}


def phase_main(torch, np, specs, record, card, profile=False):
    """The port's main path at full width, then its measurements."""
    from repro_torch.kernels import conv1d_stripe as kconv
    from repro_torch.kernels import window_gather as kgather
    from repro_torch.models.ecg_resnext import init_ecg
    from repro_torch.models.tabular import LogisticRegression, VitalsForest
    from repro_torch.obs import spans as _spans
    from repro_torch.configs.ecg_zoo import ECG_HZ, N_LABS, N_VITALS
    from repro_torch.serving.pipeline import (EnsembleService,
                                              StreamingPipeline, ZooMember)
    from repro_torch.serving.server import EnsembleServer

    dev = torch.device("cuda:0")
    rng = np.random.default_rng(SEED)
    members = [ZooMember(s, init_ecg(
        s, torch.Generator().manual_seed(SEED + i), dev))
        for i, s in enumerate(specs)]
    y = rng.integers(0, 2, 64)
    vitals = VitalsForest(N_VITALS, n_trees=10).fit(
        rng.standard_normal((64, N_VITALS, 30)), y)
    labs = LogisticRegression().fit(rng.standard_normal((64, N_LABS)), y)
    svc = EnsembleService(members, vitals_model=vitals, labs_model=labs,
                          device=dev)
    t0 = time.perf_counter()
    svc.warmup(batch_sizes=(1, 8, 64))
    print(f"  full zoo: {len(members)} members, {svc.n_buckets} buckets, "
          f"input_len {specs[0].input_len}; warm-up "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    counters = (kgather.launches, kconv.launches_stacked, kconv.launches)

    def feed_window(pipe_or_ingest, beds, t_start, seconds=30):
        """1-s chunks of 250 Hz ECG and 1 Hz vitals for ``beds``."""
        out = []
        for s in range(seconds + 1):
            t = float(t_start + s)
            for bed in beds:
                ecg = rng.standard_normal((3, ECG_HZ)).astype(np.float32)
                vit = rng.standard_normal((N_VITALS, 1)).astype(np.float32)
                out.append(pipe_or_ingest.feed(t, bed, "ecg", ecg))
                out.append(pipe_or_ingest.feed(t, bed, "vitals", vit))
        return [r for r in out if r is not None]

    # ---- the main path: counters at zero just before, read just after
    for c in counters:
        c.reset()
    t_main = time.perf_counter()
    pipe = StreamingPipeline(svc, n_patients=16, device_ingest=True,
                             device=dev)
    for bed in range(16):
        pipe.feed(0.0, bed, "labs",
                  rng.standard_normal(N_LABS).astype(np.float32))
    recs = feed_window(pipe, range(16), 0) + feed_window(pipe, range(16), 31)
    scores = np.array([r.score for r in recs])
    if len(recs) != 32 or not np.all(np.isfinite(scores)) \
            or scores.min() < 0 or scores.max() > 1:
        raise AssertionError(f"pipeline served {len(recs)} windows "
                             f"(want 32), scores {scores}")
    di = pipe.device_ingest
    di.grow(64)                                  # the census grows
    for bed in range(64):
        for s in range(30):
            di.ingest(62.0 + s, bed, "ecg", rng.standard_normal(
                (3, ECG_HZ)).astype(np.float32))
            di.ingest(62.0 + s, bed, "vitals", rng.standard_normal(
                (N_VITALS, 1)).astype(np.float32))
    refs = [di.close_window(bed, 92.0, extra={
        "labs": rng.standard_normal(N_LABS).astype(np.float32)})
        for bed in range(64)]
    srv = EnsembleServer(batch_handler=svc.predict_batch, n_workers=2,
                         max_batch=8).start()
    for bed, r in enumerate(refs):
        if not srv.submit(bed, r):
            raise AssertionError(f"server shed bed {bed}")
    stats = srv.stop()
    served = srv.results()
    if srv.leaked:
        raise AssertionError(f"server threads left running: {srv.leaked}")
    srv_scores = np.array([s for _, s, _, _ in served])
    if stats.served != 64 or stats.failed or len(served) != 64 \
            or not np.all(np.isfinite(srv_scores)) \
            or srv_scores.min() < 0 or srv_scores.max() > 1:
        raise AssertionError(f"server: served {stats.served}, failed "
                             f"{stats.failed}, scores {srv_scores}")
    # the per-member oracle path (fused=False) on one ref
    oracle = EnsembleService(members, vitals_model=vitals, labs_model=labs,
                             fused=False, device=dev)
    s_unfused = oracle.predict(refs[0])
    main_s = time.perf_counter() - t_main
    launches = {c.name: c.value for c in counters}
    print(f"  main path: {len(recs)} pipeline windows + {stats.served} "
          f"server queries (mean batch "
          f"{srv.batcher.stats.mean_batch:.2f}) + 1 per-member oracle "
          f"query in {main_s:.2f} s; launches {launches}", flush=True)
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")

    # ---- checks and measurements after the counted run
    s_fused = svc.predict(refs[0])
    if abs(s_fused - s_unfused) > TOL:
        raise AssertionError(f"fused {s_fused} vs per-member {s_unfused}")
    plain = EnsembleService(members, vitals_model=vitals, labs_model=labs,
                            impl="torch", device=dev)
    got = np.array(svc.predict_batch(refs[:8]))
    want = np.array(plain.predict_batch(refs[:8]))
    flush_err = float(np.abs(got - want).max())
    if flush_err > TOL:
        raise AssertionError(f"flush vs plain versions: {flush_err}")
    before = kconv.launches_stacked.value
    svc.predict_batch(refs[:8])
    conv_per_flush = kconv.launches_stacked.value - before
    lat = {}
    for P in (8, 64):
        torch.cuda.reset_peak_memory_stats(dev)
        ts, stages = [], []
        for _ in range(10):
            with _spans.collect() as acc:      # the pipeline's own spans
                t0 = time.perf_counter()
                out = svc.predict_batch(refs[:P])
                ts.append(time.perf_counter() - t0)
            stages.append(dict(acc))
        if len(out) != P or not np.all(np.isfinite(out)):
            raise AssertionError(f"P={P} flush: {out}")
        # host view of one flush: ring-gather launches (marshal), issuing
        # every bucket's ops (dispatch), waiting for the card and the
        # score copy (gather), and the rest: the vitals readback, the
        # CPU-side models and the Eq. 5 combine
        host = {k: 1e3 * float(np.mean([st.get(k, 0.0) for st in stages]))
                for k in ("marshal", "dispatch", "gather")}
        host["side_and_combine"] = 1e3 * float(np.mean(ts)) \
            - sum(host.values())
        lat[P] = {"p50_ms": 1e3 * float(np.percentile(ts, 50)),
                  "p95_ms": 1e3 * float(np.percentile(ts, 95)),
                  "host_stages_mean_ms": host,
                  "peak_mem_gib": torch.cuda.max_memory_allocated(dev)
                  / 2 ** 30}
        print(f"  P={P} flush host stages (mean ms): "
              + ", ".join(f"{k} {v:.2f}" for k, v in host.items()),
              flush=True)
    print(f"  flush latency on {card}: P=8 p50 {lat[8]['p50_ms']:.2f} ms "
          f"p95 {lat[8]['p95_ms']:.2f} ms; P=64 p50 "
          f"{lat[64]['p50_ms']:.2f} ms p95 {lat[64]['p95_ms']:.2f} ms; "
          f"conv launches/flush {conv_per_flush}; peak memory P=8 "
          f"{lat[8]['peak_mem_gib']:.3f} GiB, P=64 "
          f"{lat[64]['peak_mem_gib']:.3f} GiB; fused vs plain max abs "
          f"err {flush_err:.3g}", flush=True)
    if profile:
        phase_profile(torch, svc, refs, lat, record)
    record["main"] = {"launches": launches, "latency": lat,
                      "conv_launches_per_flush": conv_per_flush,
                      "flush_vs_plain_max_abs_err": flush_err,
                      "fused_vs_unfused_abs_err": abs(s_fused - s_unfused),
                      "main_path_seconds": main_s}
    return launches, conv_per_flush


def phase_small_reference(torch, np):
    """The reduced zoo at 1-s windows on the card against the same
    service on the CPU (plain versions): the scores must agree."""
    from repro_torch.configs.ecg_zoo import zoo_specs
    from repro_torch.models.ecg_resnext import init_ecg
    from repro_torch.serving.pipeline import EnsembleService, ZooMember

    specs = zoo_specs(reduced=True, input_len=250)
    members = [ZooMember(s, init_ecg(s, torch.Generator().manual_seed(i)))
               for i, s in enumerate(specs)]
    rng = np.random.default_rng(SEED)
    wins = [{"ecg": rng.standard_normal((3, 250)).astype(np.float32)}
            for _ in range(5)]
    cpu = EnsembleService(members, device="cpu").predict_batch(wins)
    gpu = EnsembleService(members, device="cuda:0").predict_batch(wins)
    err = float(np.abs(np.array(cpu) - np.array(gpu)).max())
    if err > TOL:
        raise AssertionError(f"reduced zoo card vs CPU: {err}")
    print(f"  reduced zoo (12 members, L=250): card vs CPU max abs err "
          f"{err:.3g}", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.configs.ecg_zoo import zoo_specs

    t_start = time.perf_counter()
    # the plain conv runs through cuDNN: keep it (and matmuls) in fp32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("phase 1: environment", flush=True)
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, cudnn.allow_tf32 "
          f"{torch.backends.cudnn.allow_tf32}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    lib = _build.LIBRARY
    lib.get()
    print(f"  kernels built in {lib.build_seconds:.2f} s from "
          f"{[s.name for s in lib.sources()]} -> {lib.path.name}",
          flush=True)
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:" + line.split("ptxas info", 1)[-1], flush=True)
    record = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "nvcc_log": lib.log,
              "build_seconds": lib.build_seconds}

    specs = zoo_specs(reduced=False)
    print("phase 2: kernels against their plain versions", flush=True)
    gather = phase_gather(torch, np, record)
    conv = phase_conv(torch, np, F, specs, record)

    print("phase 3: main path (full zoo)", flush=True)
    launches, conv_per_flush = phase_main(torch, np, specs, record, card,
                                          profile="--profile" in sys.argv)
    if conv_per_flush != conv[("conv1d_stripe_stacked", 64)]["calls"]:
        raise AssertionError(
            f"a flush launched {conv_per_flush} convs, the shape table "
            f"counts {conv[('conv1d_stripe_stacked', 64)]['calls']}")
    phase_small_reference(torch, np)

    def conv_row(name, key, replaces):
        t = conv[key]
        return {"name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/conv1d_stripe.cu",
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": max(v["max_abs_err"] for k, v in conv.items()
                                   if k[0] == name),
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": 1e3 * t["bound_s"],
                "bound_by": ("operations" if t["ops_s"] >= t["bytes_s"]
                             else "bytes"),
                "library_ms": t["library_ms"]}

    g = gather["ecg"]
    kernels = [
        {"name": "window_gather", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/window_gather.cu",
         "replaces": "src/repro/kernels/window_gather.py:55",
         "launches": launches["window_gather"],
         "max_abs_err": max(v["max_abs_err"] for v in gather.values()),
         "ms": g["ms"], "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
         "bound_by": "bytes", "library_ms": None},
        conv_row("conv1d_stripe_stacked", ("conv1d_stripe_stacked", 64),
                 "src/repro/kernels/conv1d_stripe.py:99"),
        conv_row("conv1d_stripe", ("conv1d_stripe", 1),
                 "src/repro/kernels/conv1d_stripe.py:62"),
    ]
    record["kernels"] = kernels
    record["seconds"] = time.perf_counter() - t_start
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(f"  done in {record['seconds']:.1f} s; details in "
          f"chiprun_out/chip_smoke.json", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
