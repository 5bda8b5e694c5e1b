#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (or
another sm_90a card), ``nvcc`` and PyTorch built for CUDA.  It imports
nothing of JAX or of the JAX package (``src/repro``).  Phases:

1. environment: versions, the card's name and power limit, the build of
   every CUDA kernel from ``src/repro_torch/kernels/csrc``;
2. each kernel against its plain PyTorch version at the paths' shapes
   (``window_gather`` bitwise; both conv entry points,
   ``flash_attention``, ``decode_attention``, ``ssd`` and ``moe_gmm``
   within rtol = atol = 1e-4 with TF32 off), with its time, the plain
   version's time, the time of one library call where one computes the
   same function, and the least time the card could take (bound);
3. the ECG main path at full width: the 60-member full zoo (30-s
   windows) behind ``StreamingPipeline(device_ingest=True)`` and an
   ``EnsembleServer`` over ``DeviceWindowRef``s, with the launch
   counters reset just before and read just after; then the flush
   latency at P=8 and P=64 and checks against the plain versions;
3b. the slot engine over the same zoo and models: ``DeviceIngest``
   timed per 1-s chunk on the card (64 beds), 10 counted rounds of
   "close all 64 windows, tick" (exactly 1 + 1 ``window_gather`` and
   the flush's 470 ``conv1d_stripe_stacked`` launches a tick, 20 bucket
   passes a tick, none a read), the tick's wall time and device busy
   time; the tick bitwise equal to the flush at 64 of 64 and 40 of 64
   slots and at rung 128 (a flush padded to 128), within 1e-4 of a tick
   over the plain versions and of the rung-64 flush; the slot server
   (64 of 64 served, no thread left, its scores the engine's reads) and
   the slot pipeline against the flush pipeline on one feed (rung 16
   against rung 1: within 1e-4, whether bitwise recorded) and bitwise
   against a flush of the same refs at rung 16;
3c. placement over 4 lanes of ``cuda:0`` (``repro_torch.device.lanes``)
   on the same zoo, ingest and refs: the LPT plan from the 20 bucket
   costs measured at ``PLAN_BATCH``; the 4-lane flush at P=8 and P=64
   and a 64-bed tick bitwise equal to the unsharded ones with the same
   counted launches; p50s, dispatch spans and device busy of phase 3's
   service, a fresh unsharded one, one over the members in plan order
   and the 4-lane one (its flushes also with the retire clocks on the
   host), timed in turns;
   a ``HotSwapper`` behind an ``EnsembleServer`` over the 64 refs
   through a permanent loss of lane 2 under ``FaultPlane.protect`` (64/64 served, 3 lanes left,
   bitwise the unsharded oracle, seconds from the loss to the first
   correct score), a ``re_place`` from the live costs, and the same
   loss mid-tick under ``protect_engine``;
3d. the closed control loop on the same zoo, models and refs: (a) a
   ``HotSwapper`` over three bucket-granular rungs (cheap, mid, full)
   behind an ``EnsembleServer`` tapped by an ``SloTelemetry``, the SLO at
   the geometric mean of a 64-bed round's p99 at full and at cheap, and
   ``wire_controller`` stepped by hand: SHED under 64-bed rounds, CLIMB
   back to full under 8-bed ones, the exporter's ``holmes_served_total``
   and decision counters equal to the server's and the controller's;
   (b) RE-PLACE from the retire drift of lane 0 of two (a 20 ms sleep in
   its guard), the slowed lane's buckets split; (c) a ``TieredEnsemble``
   over one staging cache under a ``TieredController``, overloaded: the
   tiers' rungs monotone after every step, the critical tier held until
   the others are floored, each pair staged once; every served score
   bitwise an unsharded flush of the same refs by its selector, and the
   launches of ``window_gather`` and ``conv1d_stripe_stacked`` counted;
4. the dense-LM serving path through ``repro_torch.launch.serve``:
   qwen3-4b at full width and depth (36 layers; batch 4, prompt 2048,
   32 new tokens), counters reset just before and read just after (36
   ``flash_attention`` and 36 x 32 ``decode_attention`` launches),
   prefill logits against the plain versions and cached decode against
   the teacher-forced forward; then smollm-360m at the launcher's
   defaults;
5. the pure-SSM path: mamba2-2.7b at full width and depth (64 layers;
   the same traffic), exactly 64 ``ssd`` and 192 ``conv1d_stripe``
   launches (decode launches no kernel, as in the reference), the same
   checks as phase 4;
6. the MoE path: phi3.5-moe-42b-a6.6b at full width, depth cut to 10
   of its 32 layers (fp32 weights of all 32 are 166 GB), the same
   traffic at capacity factor 1.25, exactly 10 ``flash_attention``, 320
   ``decode_attention`` and 330 ``moe_gmm`` launches; routing compared
   kernel against plain (near-tie flips reported), each MoE layer held
   kernel against plain on the same input, dropped choices counted, one
   more served decode step held kernel against plain, and the cached
   decode against the teacher-forced forward at a capacity that drops
   nothing;
7. the MLA path: deepseek-v2-lite-16b at full width and depth (27
   layers, 58.5 GiB of fp32 weights), the same traffic, materialized
   (the launcher's default): exactly 27 ``flash_attention``, 864
   ``decode_attention`` and 858 ``moe_gmm`` launches and phase 6's
   checks; then the absorbed form from the same post-prefill cache: 864
   more ``decode_attention`` launches, its logits against the
   materialized ones (2e-3), one absorbed step against plain (1e-4),
   both forms against the teacher-forced forward on a 512-token prompt,
   and both decode times;
8. a ``kernels`` JSON line (the seven ported kernels), and the last line
   ``{"ok": true, "device": {...}}``.

Phase 2 also holds ``ssd`` (y and hT) and ``moe_gmm`` against their
plain versions at the served shapes and at ragged ones (``moe_gmm``'s
decode shapes both with every row filled and routed, as a served step
fills them), and the 3-D conv at the mamba short-conv shapes; the convs,
``decode_attention``, ``ssd`` and ``moe_gmm`` must be bitwise
repeatable, the convs are timed on their direct path too, and the small
conv calls, every ``decode_attention`` shape and ``ssd`` get each call's
device time (a CUDA graph) and host time beside the event-timed figure
(``decode_attention`` and ``ssd`` with their plan and scratch bytes).
``--only=gather,flash`` runs phase 2 for the named kernels alone
(``--only=flush``: phase 3 alone, its flush times and host stages) and
prints no result line.  ``--profile`` adds one traced flush at P=8 and at P=64 after phase 3 and
one traced prefill and decode step of qwen3-4b, mamba2-2.7b, phi3.5-moe
and deepseek-v2-lite (and one absorbed step) (``torch.profiler``):
device time by kernel and the card's idle share.

Any failed check raises, so the exit code is non-zero and no result line
is printed.  Details (per-shape timings, the nvcc log) go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import dataclasses
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
TF32_FLOP_S = 495e12        # H100 SXM TF32 on the tensor cores, dense


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


def _host_ms(torch, fn, reps: int = 20) -> float:
    """Host time of one call: the wall time of issuing ``reps`` calls
    back to back (no sync between them; the queue stays short) over
    ``reps``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * t / reps


def _device_ms(torch, fn, reps: int = 20) -> float:
    """Device time of one call without the host: ``reps`` calls captured
    in one CUDA graph, the graph's replay timed by CUDA events, over
    ``reps``."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps
    del g
    return ms


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


def _conv_bound(np, conv_padding, M, B, L, Cin, Cout, K, groups, stride,
                padding="SAME"):
    """(seconds if bytes bound, seconds if fp32 operations bound) for one
    conv: each input read once and the output written once; the FMAs
    that land inside [0, L) (padding taps do no work)."""
    lo, _, L_out = conv_padding(L, K, stride, padding)
    li = np.arange(L_out)[:, None] * stride + np.arange(K)[None, :] - lo
    taps = int(((li >= 0) & (li < L)).sum())
    cin_g = Cin // groups
    flops = 2.0 * M * B * Cout * cin_g * taps
    nbytes = 4.0 * (M * B * L * Cin + M * K * cin_g * Cout + M * Cout
                    + M * B * L_out * Cout)
    return nbytes / HBM_BYTES_S, flops / FP32_FLOP_S


def phase_conv(torch, np, F, specs, record):
    """Both conv entry points against the plain version at every conv
    shape of the full zoo, bitwise repeatable; times summed over the calls
    of one flush: the kernel as the wrapper routes it, its direct path
    (the first version) on the same inputs, the plain version and one
    cuDNN call (CUDA events over 5 calls; 20 for the per-member oracle
    pass, M=1 and B=1, whose calls are host-bound).  For that pass also
    each call's device time (a CUDA graph of 20 calls) and host time
    (issuing 20 calls), for the kernel and for cuDNN."""
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
        split = name == "conv1d_stripe"
        keys = ["ms", "direct_ms", "plain_ms", "library_ms"] + (
            ["device_ms", "host_ms", "library_device_ms",
             "library_host_ms"] if split else [])
        tot = {k: 0.0 for k in keys}
        tot.update({"bytes_s": 0.0, "ops_s": 0.0, "bound_s": 0.0,
                    "max_abs_err": 0.0, "calls": 0, "calls_by_path": {}})
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
                x0, w0, b0 = x[0], w[0], b[0]
                run = lambda: kconv.conv1d_stripe(x0, w0, b0, stride, groups)
                direct = lambda: kconv.conv1d_stripe(x0, w0, b0, stride,
                                                     groups,
                                                     force_direct=True)
                plain = lambda: ref.conv1d_stripe(x0, w0, b0, stride, groups)
                path = kconv.path(x0.shape, w0.shape, stride, groups)
            else:
                run = lambda: kconv.conv1d_stripe_stacked(x, w, b, stride,
                                                          groups)
                direct = lambda: kconv.conv1d_stripe_stacked(
                    x, w, b, stride, groups, force_direct=True)
                plain = lambda: ref.conv1d_stripe_stacked(x, w, b, stride,
                                                          groups)
                path = kconv.path(x.shape, w.shape, stride, groups)
            y, r = run(), plain()
            torch.cuda.synchronize()
            err = float((y.reshape(r.shape) - r).abs().max())
            if not torch.allclose(y.reshape(r.shape), r, rtol=TOL,
                                  atol=TOL):
                raise AssertionError(
                    f"{name} M={M} B={B} L={L} Cin={Cin} Cout={Cout} "
                    f"K={K} groups={groups} stride={stride} ({path}): max "
                    f"abs err {err} beyond rtol=atol={TOL}")
            if not torch.equal(y, run()):
                raise AssertionError(f"{name} M={M} B={B} L={L} Cin={Cin} "
                                     f"Cout={Cout} ({path}): two runs differ")
            # library yardstick: one cuDNN grouped conv over the
            # pre-padded, channels-first member-folded input
            lo, hi, _ = conv_padding(L, K, stride, "SAME")
            xp = F.pad(x.permute(1, 0, 3, 2).reshape(B, M * Cin, L),
                       (lo, hi)).contiguous()
            wl = w.permute(0, 3, 2, 1).reshape(M * Cout, cin_g, K) \
                .contiguous()
            lib = lambda: F.conv1d(xp, wl, None, stride, 0, 1, M * groups)
            reps = 20 if split else 5       # B = 1: host-bound, noisy
            t = {"ms": _time_ms(torch, run, reps),
                 "direct_ms": _time_ms(torch, direct, reps),
                 "plain_ms": _time_ms(torch, plain, reps),
                 "library_ms": _time_ms(torch, lib, reps)}
            if split:
                t.update({"device_ms": _device_ms(torch, run),
                          "host_ms": _host_ms(torch, run),
                          "library_device_ms": _device_ms(torch, lib),
                          "library_host_ms": _host_ms(torch, lib)})
            bs, os_ = _conv_bound(np, conv_padding, M, B, L, Cin, Cout, K,
                                  groups, stride)
            rows.append({"L": L, "Cin": Cin, "Cout": Cout, "K": K,
                         "groups": groups, "stride": stride, "calls": n,
                         "path": path, **t,
                         "bound_ms": 1e3 * max(bs, os_),
                         "max_abs_err": err})
            for k in keys:
                tot[k] += n * t[k]
            tot["bytes_s"] += n * bs
            tot["ops_s"] += n * os_
            tot["bound_s"] += n * max(bs, os_)
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            tot["calls"] += n
            tot["calls_by_path"][path] = tot["calls_by_path"].get(path, 0) + n
            del x, w, b, y, r, xp, wl
        print(f"  {name:22s} M={M} B={B:2d}: {len(rows)} shapes, "
              f"{tot['calls']} calls/flush {tot['calls_by_path']}, max abs "
              f"err {tot['max_abs_err']:.3g}, bitwise repeatable; per flush "
              f"kernel {tot['ms']:.3f} ms (direct path {tot['direct_ms']:.3f}"
              f"), plain {tot['plain_ms']:.3f} ms, cuDNN "
              f"{tot['library_ms']:.3f} ms, bound "
              f"{1e3 * tot['bound_s']:.3f} ms", flush=True)
        if split:
            print(f"    per call (mean of {tot['calls']}): kernel device "
                  f"{1e3 * tot['device_ms'] / tot['calls']:.2f} us, host "
                  f"{1e3 * tot['host_ms'] / tot['calls']:.2f} us, events "
                  f"{1e3 * tot['ms'] / tot['calls']:.2f} us; cuDNN device "
                  f"{1e3 * tot['library_device_ms'] / tot['calls']:.2f} us, "
                  f"host {1e3 * tot['library_host_ms'] / tot['calls']:.2f} "
                  f"us, events {1e3 * tot['library_ms'] / tot['calls']:.2f} "
                  f"us", flush=True)
        out[(name, B)] = tot
        record[f"{name}_M{M}_B{B}"] = {"total": tot, "shapes": rows}
    torch.cuda.empty_cache()
    return out


def phase_gather(torch, np, record):
    """``window_gather`` bitwise against the plain version on the ECG
    ring (P=64, L=7500: wraparound, ends < L, partial and zero valid)
    and on the vitals ring (L=30), with one call's device time (a CUDA
    graph of 20 calls) and host time beside the event-timed figure."""
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
               "device_ms": _device_ms(torch, run),
               "host_ms": _host_ms(torch, run),
               "plain_ms": _time_ms(torch, plain, 20),
               "bound_ms": 1e3 * nbytes / HBM_BYTES_S,
               "max_abs_err": float((y - r).abs().max()),
               "P": P, "C": C, "cap": cap, "L": L}
        print(f"  window_gather {label:6s} [{N},{C},{cap}] P={P} L={L}: "
              f"bitwise equal; kernel {rec['ms']:.4f} ms (one call: device "
              f"{rec['device_ms']:.4f}, host {rec['host_ms']:.4f}), plain "
              f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms",
              flush=True)
        out[label] = rec
        record[f"window_gather_{label}"] = rec
    return out


def _flash_cases(np):
    """The LM path's prefill attention calls at full width, as
    ``(label, B, Hq, Hkv, D, Dv, window, qpos, kpos)``: qwen3-4b's prefill
    (B=4, 2048 tokens, causal), the same under a 512-token window,
    smollm-360m's at the launcher's defaults (D=64, g=3), and the
    materialized MLA prefill of deepseek-v2-lite-16b (16 heads, q and k
    of width 192, v of width 128)."""
    ar = np.arange
    return [
        ("qwen3-4b prefill", 4, 32, 8, 128, 128, 0, ar(2048), ar(2048)),
        ("qwen3-4b prefill window=512", 4, 32, 8, 128, 128, 512, ar(2048),
         ar(2048)),
        ("smollm-360m prefill", 4, 15, 5, 64, 64, 0, ar(64), ar(64)),
        ("deepseek MLA prefill", 4, 16, 16, 192, 128, 0, ar(2048),
         ar(2048)),
    ]


def _decode_cases(np):
    """The LM path's decode steps at full width, as ``(label, B, Hq, Hkv,
    D, Dv, window, qpos, kpos, absorbed)``: qwen3-4b mid-generation (the
    2081-slot ring, 2065 slots filled, ``kpos = -1`` tail), its
    512-token window over the ring ``fit_kv_cache`` builds for a
    2080-token prompt (rolled by 2080 % 512, then the step's own slot
    written), smollm-360m at the launcher's defaults; deepseek-v2-lite's
    materialized MLA step (16 KV heads, 192 / 128) and its absorbed step
    (16 query heads on the one latent head, 576 / 512, v the first 512
    columns of k's rows, scale 1/sqrt(192)) on the same ring; a ring
    filled to 300 of 2081 slots (most pieces empty); and a query that
    sees no key at all (zeros by design; the plain version gives the
    mean of v)."""
    ar = np.arange
    ring = np.where(ar(2081) < 2065, ar(2081), -1)
    win = np.roll(ar(2080 - 512, 2080), 2080 % 512)
    win[2080 % 512] = 2080
    small = np.where(ar(97) < 81, ar(97), -1)
    part = np.where(ar(2081) < 300, ar(2081), -1)
    late = ar(2081) + 5000
    q1 = np.array
    return [
        ("qwen3-4b decode", 4, 32, 8, 128, 128, 0, q1([2064]), ring, False),
        ("qwen3-4b decode window=512 ring", 4, 32, 8, 128, 128, 512,
         q1([2080]), win, False),
        ("smollm-360m decode", 4, 15, 5, 64, 64, 0, q1([80]), small, False),
        ("deepseek MLA decode materialized", 4, 16, 16, 192, 128, 0,
         q1([2064]), ring, False),
        ("deepseek MLA decode absorbed", 4, 16, 1, 576, 512, 0, q1([2064]),
         ring, True),
        ("deepseek MLA decode, ring 300 of 2081", 4, 16, 16, 192, 128, 0,
         q1([299]), part, False),
        ("deepseek MLA decode absorbed, no visible key", 4, 16, 1, 576, 512,
         0, q1([2064]), late, True),
    ]


def _attn_bound(B, Hq, Hkv, D, Dv, vis, S, T, v_in_k=False):
    """(bytes s, operations s, visible pairs) of one attention call:
    q and o read and written once, and each K/V row that some query sees
    (a latent row once when v is a prefix of k's rows); 2 (D + Dv) FLOPs
    per visible (q, k) pair and head."""
    pairs = int(vis.sum())
    live = int(vis.any(0).sum())
    row = D if v_in_k else D + Dv
    nbytes = 4.0 * (B * S * Hq * (D + Dv) + B * live * Hkv * row + S + T)
    flops = 2.0 * (D + Dv) * pairs * B * Hq
    return nbytes / HBM_BYTES_S, flops / FP32_FLOP_S, pairs


def phase_flash(torch, np, F, record):
    """``flash_attention`` against the plain version (TF32 off) at the
    LM path's prefill shapes, bitwise repeatable, with its time (and one
    call's device and host time), the plain version's, one
    ``F.scaled_dot_product_attention`` call's (same boolean mask, fp32,
    ``enable_gqa``; v of its own width) and the bound: the larger of the
    bytes and the operations as three TF32 products on the tensor cores
    (``_attn_bound``'s FLOPs x 3 at 495 TFLOP/s, what the kernel's
    3xTF32 can reach), with the fp32 CUDA-core figure beside it."""
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ref

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {}
    for label, B, Hq, Hkv, D, Dv, window, qp_np, kp_np in _flash_cases(np):
        S, T = len(qp_np), len(kp_np)
        q = torch.randn((B, S, Hq, D), device=dev, generator=gen)
        k = torch.randn((B, T, Hkv, D), device=dev, generator=gen)
        v = torch.randn((B, T, Hkv, Dv), device=dev, generator=gen)
        qp = torch.from_numpy(qp_np.astype(np.int32)).to(dev)
        kp = torch.from_numpy(kp_np.astype(np.int32)).to(dev)
        run = lambda: kflash.flash_attention(q, k, v, qp, kp, causal=True,
                                             window=window)
        plain = lambda: ref.attention(q, k, v, qp, kp, causal=True,
                                      window=window)
        y, r = run(), plain()
        y2 = run()
        torch.cuda.synchronize()
        err = float((y - r).abs().max())
        if not torch.allclose(y, r, rtol=TOL, atol=TOL):
            raise AssertionError(f"flash_attention {label}: max abs err "
                                 f"{err} beyond rtol=atol={TOL}")
        if not torch.equal(y, y2):
            raise AssertionError(f"flash_attention {label}: two calls "
                                 "differ (not bitwise repeatable)")
        vis = ref.visible(qp, kp, True, window)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=vis, enable_gqa=True)
        lib_err = float((lib().transpose(1, 2) - r).abs().max())
        bs, os_, pairs = _attn_bound(B, Hq, Hkv, D, Dv, vis, S, T)
        tc = 3 * os_ * FP32_FLOP_S / TF32_FLOP_S      # 3xTF32
        rec = {"B": B, "S": S, "T": T, "Hq": Hq, "Hkv": Hkv, "D": D,
               "Dv": Dv, "window": window, "visible_pairs": pairs,
               "ms": _time_ms(torch, run), "device_ms": _device_ms(
                   torch, run, 5 if S * T >= 2 ** 20 else 20),
               "host_ms": _host_ms(torch, run),
               "plain_ms": _time_ms(torch, plain),
               "library_ms": _time_ms(torch, lib),
               "bound_ms": 1e3 * max(bs, tc),
               "bound_by": "operations" if tc >= bs else "bytes",
               "bytes_ms": 1e3 * bs, "tf32x3_ops_ms": 1e3 * tc,
               "fp32_ops_ms": 1e3 * os_,
               "max_abs_err": err, "library_max_abs_err": lib_err}
        print(f"  flash_attention {label:28s} B={B} S={S} T={T} Hq={Hq} "
              f"Hkv={Hkv} D={D} Dv={Dv}: max abs err {err:.3g}, bitwise "
              f"repeatable; kernel {rec['ms']:.4f} ms (one call: device "
              f"{rec['device_ms']:.4f}, host {rec['host_ms']:.4f}), plain "
              f"{rec['plain_ms']:.4f} ms, SDPA {rec['library_ms']:.4f} ms, "
              f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}; 3xTF32 "
              f"{rec['tf32x3_ops_ms']:.4f}, fp32 CUDA cores "
              f"{rec['fp32_ops_ms']:.4f}, bytes {rec['bytes_ms']:.4f})",
              flush=True)
        out[label] = rec
        del q, k, v, y, y2, r, qt, kt, vt, vis
        torch.cuda.empty_cache()
    record["flash_attention"] = out
    return out


def phase_decode(torch, np, F, record):
    """``decode_attention`` against the plain version (rtol = atol =
    1e-4) at the LM path's decode steps (``_decode_cases``), the absorbed
    step on strided views of one latent buffer; a query with no visible
    key must give zeros; every case bitwise repeatable.  With the path
    and plan (pieces, ring depth, scratch bytes) the wrapper ran
    (``plan_of``), its time, one call's device time (a CUDA graph of 20
    calls) and host time (issuing 20 calls), the plain version's time,
    one ``F.scaled_dot_product_attention`` call's (same mask,
    ``enable_gqa``) and the bound (``_attn_bound``, the latent rows
    counted once).  A shape on the tensor cores is also run and timed
    on the CUDA-core path, with that path's own plan (not counted)."""
    from repro_torch.kernels import decode_attention as kdecode
    from repro_torch.kernels import ref

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {}
    for (label, B, Hq, Hkv, D, Dv, window, qp_np, kp_np,
         absorbed) in _decode_cases(np):
        T = len(kp_np)
        q = torch.randn((B, Hq, D), device=dev, generator=gen)
        if absorbed:                         # k and v: views of the rows
            k = torch.randn((B, T, D), device=dev, generator=gen)[:, :, None]
            v = k[..., :Dv]
            scale = 192 ** -0.5
        else:
            k = torch.randn((B, T, Hkv, D), device=dev, generator=gen)
            v = torch.randn((B, T, Hkv, Dv), device=dev, generator=gen)
            scale = None
        qp = torch.from_numpy(qp_np.astype(np.int32)).to(dev)
        kp = torch.from_numpy(kp_np.astype(np.int32)).to(dev)
        run = lambda: kdecode.decode_attention(q, k, v, kp, qp,
                                               window=window, scale=scale)
        plain = lambda: ref.decode_attention(q, k, v, kp, qp, window=window,
                                             scale=scale)
        y, r = run(), plain()
        torch.cuda.synchronize()
        vis = ref.visible(qp, kp, True, window)
        seen = bool(vis.any())
        want = r if seen else torch.zeros_like(r)
        err = float((y - want).abs().max())
        if not (torch.allclose(y, want, rtol=TOL, atol=TOL) if seen
                else torch.equal(y, want)):
            raise AssertionError(f"decode_attention {label}: max abs err "
                                 f"{err} beyond rtol=atol={TOL}"
                                 + ("" if seen else " (want zeros)"))
        if not torch.equal(y, run()):
            raise AssertionError(f"decode_attention {label}: two runs differ")
        plan = kdecode.plan_of(q, k, v, kp, qp, window=window)
        ts, n_split = plan.ts, plan.n_split
        rec = {"B": B, "T": T, "Hq": Hq, "Hkv": Hkv, "D": D, "Dv": Dv,
               "window": window, "absorbed": absorbed,
               "visible_keys": int(vis.sum()), "max_abs_err": err,
               "path": plan.path,
               "plan": {"ts": ts, "n_split": n_split, "slots": plan.slots,
                        "scratch_bytes": 4 * plan.scratch}}
        if seen:
            qt = q[:, :, None].contiguous()
            kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
            lib = lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=vis, enable_gqa=True, scale=scale)
            lib_err = float((lib()[:, :, 0] - r).abs().max())
            bs, os_, _ = _attn_bound(B, Hq, Hkv, D, Dv, vis, 1, T,
                                     v_in_k=absorbed)
            rec.update({"ms": _time_ms(torch, run, 20),
                        "device_ms": _device_ms(torch, run),
                        "host_ms": _host_ms(torch, run),
                        "plain_ms": _time_ms(torch, plain, 20),
                        "library_ms": _time_ms(torch, lib, 20),
                        "bound_ms": 1e3 * max(bs, os_),
                        "bound_by": "operations" if os_ >= bs else "bytes",
                        "library_max_abs_err": lib_err})
            if plan.path == "tensor_cores" and seen:
                # the CUDA-core path on the same inputs, its own plan
                key = kdecode._key(q, k, v, kp, qp, window, True, 0)
                alt = kdecode._plan(key, q, k, v, kp, qp, "cuda_cores")
                run_alt = lambda: kdecode._launch(alt, q, k, v, kp, qp,
                                                  scale)
                y_alt = run_alt()
                alt_err = float((y_alt - want).abs().max())
                if not torch.allclose(y_alt, want, rtol=TOL, atol=TOL):
                    raise AssertionError(
                        f"decode_attention {label} on the CUDA cores: max "
                        f"abs err {alt_err} beyond rtol=atol={TOL}")
                rec["cuda_cores"] = {
                    "max_abs_err": alt_err, "ms": _time_ms(torch, run_alt, 20),
                    "device_ms": _device_ms(torch, run_alt),
                    "plan": {"ts": alt.ts, "n_split": alt.n_split,
                             "slots": alt.slots,
                             "scratch_bytes": 4 * alt.scratch}}
                c = rec["cuda_cores"]
                print(f"  decode_attention {label:38s} on the CUDA cores: "
                      f"max abs err {alt_err:.3g}; kernel {c['ms']:.4f} ms "
                      f"(device {c['device_ms']:.4f}); {alt.n_split} pieces "
                      f"of {alt.ts} keys, ring {alt.slots}", flush=True)
            print(f"  decode_attention {label:38s} B={B} T={T} Hq={Hq} "
                  f"Hkv={Hkv} D={D} Dv={Dv}: max abs err {err:.3g}, "
                  f"bitwise repeatable; kernel {rec['ms']:.4f} ms (device "
                  f"{rec['device_ms']:.4f}, host {rec['host_ms']:.4f}), "
                  f"plain {rec['plain_ms']:.4f} ms, SDPA "
                  f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} "
                  f"ms ({rec['bound_by']}); {rec['path']}, {n_split} pieces "
                  f"of {ts} keys, ring {plan.slots}, "
                  f"{rec['plan']['scratch_bytes']} bytes of scratch",
                  flush=True)
            del qt, kt, vt
        else:
            print(f"  decode_attention {label:38s}: zeros, as designed (the "
                  f"plain version gives the mean of v)", flush=True)
        out[label] = rec
        del q, k, v, y, r, vis
    record["decode_attention"] = out
    torch.cuda.empty_cache()
    return out


def phase_mamba_conv(torch, np, F, record):
    """The 3-D ``conv1d_stripe`` at the mamba2-2.7b short-conv shapes
    (depthwise, K = 4, CAUSAL: x at 5120 channels, B and C at 128;
    B = 4, L = 2048) against the plain version, bitwise repeatable, with
    its time (and its direct path's), the plain version's and one cuDNN
    depthwise ``F.conv1d``'s (CUDA events over 20 calls), the device and
    host time of one call of the kernel and of cuDNN (as ``phase_conv``)
    and the bound."""
    from repro_torch.kernels import conv1d_stripe as kconv
    from repro_torch.kernels import ref
    from repro_torch.kernels.ref import conv_padding

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {}
    for ch in (5120, 128):
        B, L, K = 4, 2048, 4
        x = torch.randn((B, L, ch), device=dev, generator=gen)
        w = torch.randn((K, 1, ch), device=dev, generator=gen) / math.sqrt(K)
        b = torch.randn((ch,), device=dev, generator=gen)
        run = lambda: kconv.conv1d_stripe(x, w, b, 1, ch, "CAUSAL")
        direct = lambda: kconv.conv1d_stripe(x, w, b, 1, ch, "CAUSAL",
                                             force_direct=True)
        plain = lambda: ref.conv1d_stripe(x, w, b, 1, ch, "CAUSAL")
        y, r = run(), plain()
        torch.cuda.synchronize()
        err = float((y - r).abs().max())
        if not torch.allclose(y, r, rtol=TOL, atol=TOL):
            raise AssertionError(f"conv1d_stripe mamba C={ch}: max abs err "
                                 f"{err} beyond rtol=atol={TOL}")
        if not torch.equal(y, run()):
            raise AssertionError(f"conv1d_stripe mamba C={ch}: two runs "
                                 "differ")
        xp = F.pad(x.transpose(1, 2), (K - 1, 0)).contiguous()
        wl = w.permute(2, 1, 0).contiguous()
        lib = lambda: F.conv1d(xp, wl, b, 1, 0, 1, ch)
        bs, os_ = _conv_bound(np, conv_padding, 1, B, L, ch, ch, K, ch, 1,
                              "CAUSAL")
        rec = {"B": B, "L": L, "C": ch, "K": K,
               "path": kconv.path(x.shape, w.shape, 1, ch, "CAUSAL"),
               "ms": _time_ms(torch, run, 20),
               "direct_ms": _time_ms(torch, direct, 20),
               "plain_ms": _time_ms(torch, plain, 20),
               "library_ms": _time_ms(torch, lib, 20),
               "device_ms": _device_ms(torch, run),
               "host_ms": _host_ms(torch, run),
               "library_device_ms": _device_ms(torch, lib),
               "library_host_ms": _host_ms(torch, lib),
               "bound_ms": 1e3 * max(bs, os_),
               "bound_by": "operations" if os_ >= bs else "bytes",
               "max_abs_err": err}
        print(f"  conv1d_stripe mamba short conv [{B},{L},{ch}] K={K} "
              f"depthwise CAUSAL ({rec['path']}): max abs err {err:.3g}; "
              f"kernel {rec['ms']:.4f} ms (device {rec['device_ms']:.4f}, "
              f"host {rec['host_ms']:.4f}; direct path "
              f"{rec['direct_ms']:.4f}), plain {rec['plain_ms']:.4f} ms, "
              f"cuDNN {rec['library_ms']:.4f} ms (device "
              f"{rec['library_device_ms']:.4f}, host "
              f"{rec['library_host_ms']:.4f}), bound {rec['bound_ms']:.4f} "
              f"ms ({rec['bound_by']})", flush=True)
        out[ch] = rec
        del x, w, b, y, r, xp, wl
    record["conv1d_stripe_mamba"] = out
    torch.cuda.empty_cache()
    return out


def _ssd_bound(B, S, H, P, G, N, chunk, with_h0):
    """(bytes s, fp32 operations s, 3xTF32 operations s) of one ``ssd``
    call: x, dt, B, C, A, D (and h0) read once, y and hT written once;
    per chunk of r rows the causal half of C B^T and of W x (the r (r +
    1) / 2 pairs j <= i: r (r + 1) N and r (r + 1) P FLOPs), 2 r N P (C
    h^T) and 2 r P N (the state update), on the CUDA cores at 67
    TFLOP/s or as three TF32 products at 495 TFLOP/s."""
    nbytes = 4.0 * (2 * B * S * H * P + B * S * H + 2 * B * S * G * N
                    + 2 * H + (2 if with_h0 else 1) * B * H * P * N)
    flops = 0.0
    for s0 in range(0, S, chunk):
        r = min(chunk, S - s0)
        flops += r * (r + 1.0) * (N + P) + 4.0 * r * N * P
    flops *= B * H
    return (nbytes / HBM_BYTES_S, flops / FP32_FLOP_S,
            3 * flops / TF32_FLOP_S)


def phase_ssd(torch, record):
    """``ssd`` against the plain version (y and hT, rtol = atol = 1e-4,
    bitwise repeatable)
    at the mamba2-2.7b prefill shape (B = 4, S = 2048, H = 80, P = 64,
    G = 1, N = 128, chunk 128), at a ragged S = 2000, with a random h0,
    and at G = 2; inputs at unit scale (x, h0 ~ N(0, 1); B ~ N(0, 1),
    C ~ N(0, 1/N) so C B^T is O(1); dt = softplus(N(0, 1)); A = -U(1,
    16), Mamba-2's range)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd as kssd

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {}
    for label, S, G, with_h0 in (("served", 2048, 1, False),
                                 ("ragged S=2000", 2000, 1, False),
                                 ("h0", 2048, 1, True),
                                 ("G=2", 2048, 2, False)):
        B, H, P, N, chunk = 4, 80, 64, 128, 128
        x = torch.randn((B, S, H, P), device=dev, generator=gen)
        dt = torch.nn.functional.softplus(
            torch.randn((B, S, H), device=dev, generator=gen))
        A = -(1 + 15 * torch.rand((H,), device=dev, generator=gen))
        Bm = torch.randn((B, S, G, N), device=dev, generator=gen)
        Cm = torch.randn((B, S, G, N), device=dev, generator=gen) \
            / math.sqrt(N)
        D = torch.randn((H,), device=dev, generator=gen)
        h0 = torch.randn((B, H, P, N), device=dev, generator=gen) \
            if with_h0 else None
        run = lambda: kssd.ssd(x, dt, A, Bm, Cm, D, chunk, h0)
        plain = lambda: ref.ssd_chunked(x, dt, A, Bm, Cm, D, chunk, h0)
        (y, hT), (yr, hr) = run(), plain()
        torch.cuda.synchronize()
        err = max(float((y - yr).abs().max()), float((hT - hr).abs().max()))
        if not (torch.allclose(y, yr, rtol=TOL, atol=TOL)
                and torch.allclose(hT, hr, rtol=TOL, atol=TOL)):
            raise AssertionError(f"ssd {label}: max abs err {err} beyond "
                                 f"rtol=atol={TOL}")
        y2, h2 = run()
        if not (torch.equal(y, y2) and torch.equal(hT, h2)):
            raise AssertionError(f"ssd {label}: two runs differ")
        bs, os_, tc = _ssd_bound(B, S, H, P, G, N, chunk, with_h0)
        rec = {"B": B, "S": S, "H": H, "P": P, "G": G, "N": N,
               "chunk": chunk, "h0": with_h0,
               "y_abs_max": float(yr.abs().max()),
               "ms": _time_ms(torch, run),
               "device_ms": _device_ms(torch, run, 5),
               "host_ms": _host_ms(torch, run, 5),
               "plain_ms": _time_ms(torch, plain),
               "bound_ms": 1e3 * max(bs, os_),
               "bound_by": "operations" if os_ >= bs else "bytes",
               "bytes_ms": 1e3 * bs, "fp32_ops_ms": 1e3 * os_,
               "tf32x3_ops_ms": 1e3 * tc,
               "scratch_bytes": 4 * kssd.scratch_floats(B, S, H, G, P, N,
                                                        chunk),
               "max_abs_err": err}
        print(f"  ssd {label:14s} B={B} S={S} H={H} P={P} G={G} N={N}: max "
              f"abs err {err:.3g} (|y| up to {rec['y_abs_max']:.3g}), "
              f"bitwise repeatable; kernel {rec['ms']:.4f} ms (device "
              f"{rec['device_ms']:.4f}, host {rec['host_ms']:.4f}), plain "
              f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}; bytes {rec['bytes_ms']:.4f}, 3xTF32 "
              f"{rec['tf32x3_ops_ms']:.4f}); 4 launches, "
              f"{rec['scratch_bytes']} bytes of scratch", flush=True)
        out[label] = rec
        del x, dt, Bm, Cm, h0, y, hT, yr, hr
    record["ssd"] = out
    torch.cuda.empty_cache()
    return out


def _gmm_bound(E, C, d, f, experts, rows):
    """(bytes s, fp32 CUDA-core s, 3xTF32 tensor-core s) of one
    ``moe_gmm`` call: x read and y written once, the three weights of
    the ``experts`` that hold a row read once; 6 d f FLOPs for each of
    the ``rows`` that hold a value, on the CUDA cores at 67 TFLOP/s or
    as three TF32 products at 495 TFLOP/s."""
    nbytes = 4.0 * (2 * E * C * d + 3 * experts * d * f)
    flops = 6.0 * rows * d * f
    return (nbytes / HBM_BYTES_S, flops / FP32_FLOP_S,
            3 * flops / TF32_FLOP_S)


def phase_gmm(torch, record):
    """``moe_gmm`` against the plain version (rtol = atol = 1e-4),
    bitwise repeatable, at the phi3.5-moe shapes: prefill (B = 4, prompt
    2048: C = 324 a sequence, [16, 1296, 4096], the tensor-core path),
    decode (B = 4: [16, 16, 4096], the stream); at the deepseek-v2-lite
    shapes (64 experts of f = 1408, top-6: C = 244 a sequence in prefill,
    [64, 976, 2048], and 6 at decode, [64, 24, 2048]); and a C and an f
    off the kernel's tiles ([4, 37, 4096], f = 1000).  The decode shapes
    twice: every row of every expert filled (the worst case) and routed,
    the buffer a served decode step builds (``moe.route`` with a seeded
    router, then ``moe.dispatch``), where most experts hold no token.
    Inputs at unit scale (x ~ N(0, 1), each weight ~ N(0, 1/fan-in of
    its contracted axis)).  Bound (``_gmm_bound``): the larger of the
    bytes and the 3xTF32 operations; the fp32 CUDA-core figure beside
    it."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import moe_gmm as kgmm
    from repro_torch.kernels import ref
    from repro_torch.models import moe as moe_mod

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    phi, ds = "phi3.5-moe-42b-a6.6b", "deepseek-v2-lite-16b"
    out, wts = {}, None
    for label, arch, E, C, d, f, routed in (
            ("prefill", phi, 16, 1296, 4096, 6400, False),
            ("decode", phi, 16, 16, 4096, 6400, False),
            ("routed decode", phi, 16, 16, 4096, 6400, True),
            ("deepseek prefill", ds, 64, 976, 2048, 1408, False),
            ("deepseek decode", ds, 64, 24, 2048, 1408, False),
            ("deepseek routed decode", ds, 64, 24, 2048, 1408, True),
            ("ragged", None, 4, 37, 4096, 1000, False)):
        if wts is None or wts[0] != (E, d, f):
            wts = None
            torch.cuda.empty_cache()
            wts = ((E, d, f), [
                torch.randn((E, d, f), device=dev, generator=gen)
                / math.sqrt(d),
                torch.randn((E, d, f), device=dev, generator=gen)
                / math.sqrt(d),
                torch.randn((E, f, d), device=dev, generator=gen)
                / math.sqrt(f)])
        wg, wu, wd = wts[1]
        if routed:                  # a served decode step's buffer, B = 4
            cfg = get_config(arch)
            router = {"router": torch.randn((d, E), device=dev, generator=gen)
                      / math.sqrt(d)}
            xt = torch.randn((4, 1, d), device=dev, generator=gen)
            r = moe_mod.route(router, xt, cfg, 1.25)
            x = moe_mod.dispatch(xt, r, E).xe.contiguous()
            if tuple(x.shape) != (E, C, d):
                raise AssertionError(f"moe_gmm {label}: dispatched "
                                     f"{tuple(x.shape)}, want {(E, C, d)}")
        else:
            x = torch.randn((E, C, d), device=dev, generator=gen)
        full = (x != 0).any(-1)
        experts, rows = int(full.any(-1).sum()), int(full.sum())
        run = lambda: kgmm.moe_gmm(x, wg, wu, wd)
        plain = lambda: ref.moe_gmm(x, wg, wu, wd)
        y, r = run(), plain()
        torch.cuda.synchronize()
        err = float((y - r).abs().max())
        if not torch.allclose(y, r, rtol=TOL, atol=TOL):
            raise AssertionError(f"moe_gmm {label}: max abs err {err} beyond "
                                 f"rtol=atol={TOL}")
        if not torch.equal(y, run()):
            raise AssertionError(f"moe_gmm {label}: two runs differ")
        bs, fp32_s, tc_s = _gmm_bound(E, C, d, f, experts, rows)
        reps = 3 if "prefill" in label else 10
        rec = {"E": E, "C": C, "d": d, "f": f, "path": kgmm.path(C),
               "occupied_experts": experts, "occupied_rows": rows,
               "ms": _time_ms(torch, run, reps),
               "plain_ms": _time_ms(torch, plain, reps),
               "bound_ms": 1e3 * max(bs, tc_s),
               "bound_by": "operations" if tc_s >= bs else "bytes",
               "bytes_ms": 1e3 * bs, "fp32_ops_ms": 1e3 * fp32_s,
               "tf32x3_ops_ms": 1e3 * tc_s,
               "max_abs_err": err, "y_abs_max": float(r.abs().max())}
        print(f"  moe_gmm {label:22s} [{E},{C},{d}] f={f} ({rec['path']}; "
              f"{experts} experts, {rows} rows hold a token): max abs err "
              f"{err:.3g}, bitwise repeatable; kernel {rec['ms']:.4f} ms, "
              f"plain {rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} "
              f"ms ({rec['bound_by']}; bytes {rec['bytes_ms']:.4f}, 3xTF32 "
              f"{rec['tf32x3_ops_ms']:.4f}, fp32 CUDA cores "
              f"{rec['fp32_ops_ms']:.4f})", flush=True)
        out[label] = rec
        del x, y, r, full
    del wts
    record["moe_gmm"] = out
    torch.cuda.empty_cache()
    return out


def _device_ms_by_kernel(torch, prof):
    """{kernel name: (device ms, count)} of a ``torch.profiler`` run."""
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.key] = (us / 1e3, e.count)
    return out


def phase_llm_profile(torch, r, max_len, absorbed_ms=None):
    """Device time by kernel class over one traced prefill and one traced
    decode step of the served model (and, given the untraced absorbed
    decode's ms/token, one traced absorbed MLA step), and the card's
    idle share of the untraced prefill and mean decode step."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer

    cfg, rt = r["cfg"], r["rt"]
    out = {}
    runs = [("prefill", rt, 1e3 * r["prefill_s"]),
            ("decode", rt, r["decode_ms_per_token"])]
    if absorbed_ms is not None:
        runs.append(("decode absorbed",
                     dataclasses.replace(rt, absorbed_mla=True), absorbed_ms))
    for step, (what, rt_, wall) in enumerate(runs):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if what == "prefill":
                _, cache = transformer.prefill(r["params"], r["tokens"], cfg,
                                               rt_, max_len=max_len)
            else:                                   # the first steps again
                transformer.decode_step(r["params"], cache,
                                        r["generated"][:, step - 1], cfg,
                                        rt_)
            torch.cuda.synchronize()
        by = _device_ms_by_kernel(torch, prof)
        cls = {"flash_attention": 0.0, "decode_attention": 0.0, "ssd": 0.0,
               "moe_gmm": 0.0, "conv1d_stripe": 0.0, "gemm": 0.0,
               "other": 0.0}
        for name, (ms, _) in by.items():
            low = name.lower()
            key = ("flash_attention" if "flash" in name else
                   "decode_attention" if "decode_split" in name
                   or "decode_mma" in name or "decode_combine" in name else
                   "ssd" if "ssd_" in name else
                   "moe_gmm" if "gmm_kernel" in name else
                   "conv1d_stripe" if "conv1d_stripe" in name else
                   "gemm" if "gemm" in low or "gemv" in low else "other")
            cls[key] += ms
        busy = sum(cls.values())
        out[what] = {"wall_ms": wall, "device_busy_ms": busy,
                     "idle_share": 1 - busy / wall, "by_class_ms": cls,
                     "ops": sum(n for _, n in by.values()),
                     "top": sorted(((k, ms, n) for k, (ms, n) in by.items()),
                                   key=lambda t: -t[1])[:8]}
        print(f"  profile {cfg.name} {what}: device busy {busy:.2f} ms of "
              f"{wall:.2f} ms (untraced) -> idle share "
              f"{1 - busy / wall:.3f}; "
              + ", ".join(f"{k} {v:.2f} ms" for k, v in cls.items() if v)
              + f"; {out[what]['ops']} device ops", flush=True)
        for name, ms, n in out[what]["top"]:
            print(f"    {ms:9.3f} ms  x{n:5d}  {name[:90]}", flush=True)
    del cache
    return out


def _serve_counted(torch, argv, counters, expected, cfg=None):
    """Serve one batch through the launcher (``repro_torch.launch.serve``)
    with every launch counter at 0 just before and read just after, and
    hold the counts to ``expected(cfg, args)`` ({kernel: launches}; every
    other kernel 0) and the outputs to their shapes.  Returns (args, the
    run's result, the counts)."""
    from repro_torch.launch import serve

    args = serve.parse_args(argv)
    for c in counters:
        c.reset()
    r = serve.run(args, cfg=cfg)
    launches = {c.name: c.value for c in counters}
    cfg, B, S = r["cfg"], args.batch, args.prompt_len
    want = {c.name: 0 for c in counters}
    want.update(expected(cfg, args))
    print(f"  {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"vocab {cfg.vocab_size}; batch {B}, prompt {S}, "
          f"{args.new_tokens} new tokens; launches {launches}", flush=True)
    if launches != want:
        raise AssertionError(f"{cfg.name}: launches {launches}, want {want}")
    gen = r["generated"]
    if tuple(gen.shape) != (B, args.new_tokens + 1) or int(gen.min()) < 0 \
            or int(gen.max()) >= cfg.padded_vocab:
        raise AssertionError(f"{cfg.name}: generated {tuple(gen.shape)}")
    logits = r["prefill_logits"]
    if tuple(logits.shape) != (B, cfg.padded_vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{cfg.name}: prefill logits "
                             f"{tuple(logits.shape)} not finite")
    return args, r, launches


def _plain_prefill(torch, r, counters, max_len, rt, moe_inputs=None):
    """The prefill again through the plain versions (no kernel may
    launch)."""
    from repro_torch.models import transformer

    before = [c.value for c in counters]
    plain, _ = transformer.prefill(r["params"], r["tokens"], r["cfg"], rt,
                                   max_len=max_len, moe_inputs=moe_inputs)
    if [c.value for c in counters] != before:
        raise AssertionError("the plain prefill launched a kernel")
    return plain


def _check_teacher_forced(torch, name, cached, full, S, rows=None):
    """Cached logits (``cached[t]``, the prefill's then each decode
    step's, at position S - 1 + t) against the teacher-forced forward
    ``full`` on the same tokens, within 2e-3 (the reference's bound,
    ``tests/test_arch_smoke.py:87-93``), on the batch ``rows`` (all by
    default).  Returns the max abs error on those rows."""
    err = 0.0
    rows = list(range(full.shape[0])) if rows is None else rows
    for t, got in enumerate(cached):
        got, want = got[rows], full[rows, S - 1 + t]
        err = max(err, float((got - want).abs().max()))
        if not torch.allclose(got, want, rtol=2e-3, atol=2e-3):
            raise AssertionError(f"{name}: cached logits at position "
                                 f"{S - 1 + t} vs teacher-forced forward: "
                                 f"max abs err {err}")
    return err


def _llm_record(r, args, launches, card, **extra):
    cfg = r["cfg"]
    rec = {"arch": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "batch": args.batch,
           "prompt_len": args.prompt_len, "new_tokens": args.new_tokens,
           "launches": launches, "init_s": r["init_s"],
           "prefill_s": r["prefill_s"],
           "decode_ms_per_token": r["decode_ms_per_token"],
           "decode_tok_per_s": r["decode_tok_per_s"],
           "peak_mem_gib": r["peak_mem_gib"],
           "generated_0_16": r["generated"][0, :16].tolist(), "card": card}
    rec.update(extra)
    print(f"  {cfg.name} on {card}: prefill {rec['prefill_s']:.4f} s, "
          f"decode {rec['decode_ms_per_token']:.3f} ms/token "
          f"({rec['decode_tok_per_s']:.1f} tok/s), peak memory "
          f"{rec['peak_mem_gib']:.3f} GiB, init {rec['init_s']:.2f} s",
          flush=True)
    return rec


def phase_llm(torch, np, record, card, argv, counters, expected,
              profile=False):
    """A dense or pure-SSM LM through its launcher
    (``repro_torch.launch.serve``): prefill, then a greedy decode loop,
    with every launch counter at 0 just before and read just after
    (exactly ``expected``); then the prefill logits against the plain
    versions (1e-4) and the first two decode steps against the
    teacher-forced forward on the same tokens (2e-3), and one more decode
    step under ``set_sync_debug_mode("error")``."""
    from repro_torch.models import transformer
    from repro_torch.models.runtime import RuntimeOptions

    args, r, launches = _serve_counted(torch, argv, counters, expected)
    cfg, S = r["cfg"], args.prompt_len
    logits, gen = r["prefill_logits"], r["generated"]
    max_len = S + args.new_tokens + 1
    plain = _plain_prefill(torch, r, counters, max_len,
                           RuntimeOptions(impl="torch"))
    plain_err = float((logits - plain).abs().max())
    if not torch.allclose(logits, plain, rtol=TOL, atol=TOL):
        raise AssertionError(f"{cfg.name}: prefill logits, kernel vs "
                             f"plain: max abs err {plain_err}")
    del plain
    full, _ = transformer.forward(
        r["params"], torch.cat([r["tokens"], gen[:, :2]], dim=1), cfg,
        r["rt"])
    tf_err = _check_teacher_forced(torch, cfg.name,
                                   [logits, *r["step_logits"][:2]], full, S)
    del full
    # one more step of the served cache: the decode path never stalls
    # the host on the card (a sync would serialise launch and compute)
    torch.cuda.set_sync_debug_mode("error")
    transformer.decode_step(r["params"], r["cache"], gen[:, -1], cfg,
                            r["rt"])
    torch.cuda.set_sync_debug_mode(0)
    rec = _llm_record(r, args, launches, card,
                      prefill_vs_plain_max_abs_err=plain_err,
                      decode_vs_forward_max_abs_err=tf_err)
    print(f"    prefill logits vs plain max abs err {plain_err:.3g}, cached "
          f"vs teacher-forced {tf_err:.3g}", flush=True)
    if profile:
        rec["profile"] = phase_llm_profile(torch, r, max_len)
    record[f"llm_{args.arch}"] = rec
    del r
    torch.cuda.empty_cache()
    return rec


def _routing_flips(p_seg, cfg, cf, h_k, h_p, where, tainted=()):
    """Each MoE layer's routing of the kernel run's input ``h_k[l]``
    against the plain run's ``h_p[l]``: a relative difference of ~1e-6
    between the two can flip a top-k choice at a near-tie, so a flipped
    choice fails unless the two experts' probabilities in the plain run
    differ by less than 1e-5.  Such a flip sends that token through
    another expert, so from the next layer on the two runs differ by
    O(1) at that token and, through causal attention and the
    per-sequence capacity, at the later tokens of its sequence: a flip
    there is downstream of it, reported and not held to the gap.  Each
    flip is reported with its layer, token and gap; every flip in a
    sequence of ``tainted`` (one that diverged before) is downstream.
    Returns (the flips, the choices the capacity dropped in each layer of
    the kernel run)."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer

    if len(h_k) != len(h_p):
        raise AssertionError(f"{where}: captured {len(h_k)} kernel-run and "
                             f"{len(h_p)} plain-run MoE inputs")
    flips, dropped = [], []
    first = {b: 0 for b in tainted}      # batch -> earliest flipped token
    for layer, (hk, hp) in enumerate(zip(h_k, h_p)):
        p_l = transformer._layer(p_seg, layer)["mlp"]
        rk = moe_mod.route(p_l, hk, cfg, cf)
        rp = moe_mod.route(p_l, hp, cfg, cf)
        dropped.append(int((~rk.keep).sum()))
        ek, ep = rk.top_e.sort(-1).values, rp.top_e.sort(-1).values
        this = {}
        for b, s_ in (ek != ep).any(-1).nonzero().tolist():
            only_p = sorted(set(ep[b, s_].tolist()) - set(ek[b, s_].tolist()))
            only_k = sorted(set(ek[b, s_].tolist()) - set(ep[b, s_].tolist()))
            gap = max(abs(float(rp.probs[b, s_, i] - rp.probs[b, s_, j]))
                      for i in only_p for j in only_k)
            downstream = s_ >= first.get(b, math.inf)
            flips.append({"where": where, "layer": layer, "batch": b,
                          "token": s_, "kernel": only_k, "plain": only_p,
                          "gap": gap, "downstream": downstream})
            if len(flips) <= 20:
                print(f"    routing flip ({where}): layer {layer}, batch {b}, "
                      f"token {s_}: kernel {only_k}, plain {only_p}, "
                      f"plain-run probability gap {gap:.3g}"
                      + (" (downstream of a near-tie flip)" if downstream
                         else ""), flush=True)
            if gap >= 1e-5 and not downstream:
                raise AssertionError(f"{where}: routing flip at layer "
                                     f"{layer}, token {s_} with gap {gap} "
                                     f">= 1e-5")
            this[b] = min(this.get(b, math.inf), s_)
        for b, s_ in this.items():
            first[b] = min(first.get(b, math.inf), s_)
    if len(flips) > 20:
        print(f"    ... {len(flips)} flipped choices in all ({where}), "
              f"{sum(f['downstream'] for f in flips)} of them downstream",
              flush=True)
    return flips, dropped


def _hold_untouched_rows(torch, name, got, want, flips):
    """Logits ``[B, V]`` kernel against plain within 1e-4 for every
    sequence no routing flip touched (sequences share nothing: attention
    and the MoE capacity are per sequence); the others are reported.
    Returns (max abs error over all rows, the rows held)."""
    hit = {f["batch"] for f in flips}
    rows = [b for b in range(got.shape[0]) if b not in hit]
    err = float((got - want).abs().max())
    if rows and not torch.allclose(got[rows], want[rows], rtol=TOL,
                                   atol=TOL):
        raise AssertionError(f"{name}: kernel vs plain on the rows no "
                             f"routing flip touched {rows}: max abs err "
                             f"{float((got[rows] - want[rows]).abs().max())}")
    return err, rows


def _clone_cache(cache):
    """A copy of a decode cache (a step advances its cache in place); an
    MLA segment stays one latent buffer with two column views."""
    from repro_torch.models import attention as attn

    segs = []
    for c in cache["segments"]:
        if set(c) == {"ckv", "krope"}:
            segs.append(attn.mla_cache(attn.latent_rows(c).clone(),
                                       c["ckv"].shape[-1]))
        else:
            segs.append({k: v.clone() for k, v in c.items()})
    return {"segments": segs, "pos": cache["pos"].clone(),
            "idx": cache["idx"]}


def _moe_segment(cfg, params):
    """(index, layers, stacked params) of the model's MoE segment."""
    from repro_torch.models import transformer

    (si, n), = [(i, n) for i, (bt, n, _) in
                enumerate(transformer.segments(cfg)) if bt == "attn_moe"]
    return si, n, params["segments"][si]


def _moe_prefill_checks(torch, r, counters, max_len):
    """The served prompt's prefill through the kernels and through the
    plain versions, each MoE layer's input collected: routing compared
    (``_routing_flips``), each MoE layer's ``moe_apply`` kernel against
    plain on the SAME input (the kernel run's) within 1e-4 of the
    output's RMS, and the prefill logits within 1e-4 for the sequences
    no flip touched (``_hold_untouched_rows``).  Returns (flips, dropped
    choices a layer, same-input errors, logits error, the rows held, the
    kernel prefill's cache)."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer

    cfg, rt, params = r["cfg"], r["rt"], r["params"]
    _, n, p_seg = _moe_segment(cfg, params)
    cf = rt.capacity_factor
    h_k, h_p = [], []
    _, cache = transformer.prefill(params, r["tokens"], cfg, rt,
                                   max_len=max_len, moe_inputs=h_k)
    plain = _plain_prefill(torch, r, counters, max_len,
                           dataclasses.replace(rt, impl="torch"),
                           moe_inputs=h_p)
    if len(h_k) != n:
        raise AssertionError(f"captured {len(h_k)} MoE inputs, want {n}")
    flips, dropped = _routing_flips(p_seg, cfg, cf, h_k, h_p, "prefill")
    rel = []
    for layer in range(n):
        p_l = transformer._layer(p_seg, layer)["mlp"]
        yk, _ = moe_mod.moe_apply(p_l, h_k[layer], cfg, capacity_factor=cf)
        yp, _ = moe_mod.moe_apply(p_l, h_k[layer], cfg, capacity_factor=cf,
                                  impl="torch")
        rms = float(yp.square().mean().sqrt())
        rel.append(float((yk - yp).abs().max()) / rms)
        if rel[-1] > TOL:
            raise AssertionError(f"moe_apply layer {layer}, kernel vs plain "
                                 f"on the same input: max abs err / RMS "
                                 f"{rel[-1]} > {TOL} (RMS {rms:.4g})")
        del yk, yp
    del h_k, h_p
    plain_err, rows = _hold_untouched_rows(torch, f"{cfg.name} prefill",
                                           r["prefill_logits"], plain, flips)
    del plain
    torch.cuda.empty_cache()
    return flips, dropped, rel, plain_err, rows, cache


def _moe_step_check(torch, r, cache, tok, rt, where):
    """One decode step from ``cache`` through the kernels (on a copy) and
    through the plain versions (on ``cache`` itself), the logits within
    1e-4 for the sequences no near-tie flip touched.  Returns (flips,
    error, the rows held)."""
    from repro_torch.models import transformer

    cfg, params = r["cfg"], r["params"]
    _, _, p_seg = _moe_segment(cfg, params)
    d_k, d_p = [], []
    lk, _ = transformer.decode_step(params, _clone_cache(cache), tok, cfg,
                                    rt, moe_inputs=d_k)
    lp, _ = transformer.decode_step(params, cache, tok, cfg,
                                    dataclasses.replace(rt, impl="torch"),
                                    moe_inputs=d_p)
    flips, _ = _routing_flips(p_seg, cfg, rt.capacity_factor, d_k, d_p,
                              where)
    err, rows = _hold_untouched_rows(torch, f"{cfg.name} {where}", lk, lp,
                                     flips)
    return flips, err, rows


def _moe_teacher_forced(torch, r, S, forms=((), )):
    """The cached decode against the teacher-forced forward (2e-3) on the
    first ``S + 2`` tokens of the served prompt at ``capacity_factor =
    E / top_k``, where the capacity is at least S and nothing is dropped
    (at 1.25 a prefill at S and a forward at S + 2 drop different
    choices): a prefill of S tokens and two decode steps in each of
    ``forms`` (``RuntimeOptions`` overrides).  The two sides sum in
    other orders, so their routings are compared by ``_routing_flips``
    and a sequence a near-tie flip touched is reported, not held.
    Returns (the max abs error on the rows held, the flips)."""
    from repro_torch.models import transformer

    cfg, params = r["cfg"], r["params"]
    _, _, p_seg = _moe_segment(cfg, params)
    E, k = cfg.moe.n_routed_experts, cfg.moe.top_k
    rt_all = dataclasses.replace(r["rt"], capacity_factor=E / k)
    seq = torch.cat([r["tokens"], r["generated"][:, :2]], dim=1)[:, :S + 2]
    h_full = []
    full, _ = transformer.forward(params, seq, cfg, rt_all,
                                  moe_inputs=h_full)
    err, all_flips = 0.0, []
    for form in forms:
        rt_f = dataclasses.replace(rt_all, **dict(form))
        h_pre, h_steps = [], [[], []]
        got, c_all = transformer.prefill(params, seq[:, :S], cfg, rt_f,
                                         max_len=S + 3, moe_inputs=h_pre)
        cached = [got]
        for t in range(2):
            got, c_all = transformer.decode_step(params, c_all,
                                                 seq[:, S + t], cfg, rt_f,
                                                 moe_inputs=h_steps[t])
            cached.append(got)
        h_cached = [torch.cat([a, b, c], dim=1)
                    for a, b, c in zip(h_pre, *h_steps)]
        flips, _ = _routing_flips(p_seg, cfg, rt_all.capacity_factor,
                                  h_cached, h_full,
                                  f"cached {dict(form) or 'materialized'} "
                                  f"vs teacher-forced")
        hit = {f["batch"] for f in flips}
        rows = [b for b in range(seq.shape[0]) if b not in hit]
        err = max(err, _check_teacher_forced(torch, cfg.name, cached, full,
                                             S, rows))
        all_flips += flips
        del c_all, cached, got, h_pre, h_steps, h_cached
    del full, h_full
    torch.cuda.empty_cache()
    return err, all_flips


def phase_moe(torch, record, card, argv, counters, expected, cfg,
              profile=False):
    """phi3.5-moe through its launcher with the depth-cut ``cfg``, the
    counters held to ``expected``; then, under the near-tie rule of
    ``_routing_flips``: the prefill checks of ``_moe_prefill_checks``
    (routing, each MoE layer kernel vs plain on the same input, the
    logits, the choices the capacity dropped); one more decode step of
    the served cache (capacity factor as served) kernel against plain
    (``_moe_step_check``); and the cached decode against the
    teacher-forced forward at the served prompt, at a capacity that
    drops nothing (``_moe_teacher_forced``)."""
    args, r, launches = _serve_counted(torch, argv, counters, expected,
                                       cfg=cfg)
    cfg, rt, S = r["cfg"], r["rt"], args.prompt_len
    max_len = S + args.new_tokens + 1
    flips, dropped, rel, plain_err, rows, pre = _moe_prefill_checks(
        torch, r, counters, max_len)
    del pre
    d_flips, step_err, d_rows = _moe_step_check(
        torch, r, r.pop("cache"), r["generated"][:, -1], rt, "decode")
    torch.cuda.empty_cache()
    tf_err, tf_flips = _moe_teacher_forced(torch, r, S)
    E, k = cfg.moe.n_routed_experts, cfg.moe.top_k
    n = len(dropped)
    total = args.batch * S * k * n
    print(f"    routing: {len(flips)} flipped choices over "
          f"{args.batch * S * n} prefill routings, {len(d_flips)} over "
          f"{args.batch * n} decode routings; prefill logits vs plain max "
          f"abs err {plain_err:.3g} (held on rows {rows}); moe_apply "
          f"same-input max err/RMS {max(rel):.3g}; capacity dropped "
          f"{sum(dropped)} of {total} routed choices in prefill (per layer "
          f"{dropped}); served decode step vs plain {step_err:.3g} (held on "
          f"rows {d_rows}); cached vs "
          f"teacher-forced (capacity factor {E / k:g}, prompt {S}) "
          f"{tf_err:.3g} ({len(tf_flips)} routing flips)", flush=True)
    rec = _llm_record(r, args, launches, card,
                      prefill_vs_plain_max_abs_err=plain_err,
                      prefill_logits_held_rows=rows,
                      routing_flips=flips + d_flips,
                      moe_same_input_max_err_over_rms=rel,
                      prefill_dropped_choices=dropped,
                      prefill_routed_choices=total,
                      decode_step_vs_plain_max_abs_err=step_err,
                      decode_step_held_rows=d_rows,
                      decode_vs_forward_max_abs_err=tf_err,
                      decode_vs_forward_routing_flips=tf_flips,
                      decode_vs_forward_capacity_factor=E / k)
    if profile:
        rec["profile"] = phase_llm_profile(torch, r, max_len)
    record[f"llm_{args.arch}"] = rec
    del r
    torch.cuda.empty_cache()
    return rec


def _decode_loop(torch, r, cache, rt, moe_inputs=None):
    """Greedy-fed decode from ``cache`` (advanced in place) on the served
    run's tokens: (the logits of every step, ms/token, host clock after
    a sync).  ``moe_inputs`` (a list) receives each step's list of MoE
    layer inputs."""
    from repro_torch.models import transformer

    gen, out = r["generated"], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(gen.shape[1] - 1):
        h = None
        if moe_inputs is not None:
            h = []
            moe_inputs.append(h)
        lg, cache = transformer.decode_step(r["params"], cache, gen[:, t],
                                            r["cfg"], rt, moe_inputs=h)
        out.append(lg)
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0) / (gen.shape[1] - 1)


def phase_mla(torch, record, card, argv, counters, expected, profile=False,
              tf_prompt=512):
    """deepseek-v2-lite-16b at full width and depth through its launcher
    (MLA materialized, the launcher's default), the counters held to
    ``expected``; the prefill checks and one more served step of
    ``phase_moe``; then the absorbed form (``absorbed_mla``) from a copy
    of the post-prefill cache (the same cache in both forms), fed the
    served tokens, with its launches counted: every step's logits against
    the materialized form's from the same cache within 2e-3 (the
    reference's bound, ``tests/test_perf_levers.py:71-82``), and one
    absorbed step against plain within 1e-4; last, the cached decode of
    both forms against the teacher-forced forward on the first
    ``tf_prompt`` tokens of the prompt at a capacity that drops nothing
    (at the served 2048 the capacity buffers of that check do not fit
    beside the 58.5 GiB of weights)."""
    args, r, launches = _serve_counted(torch, argv, counters, expected)
    cfg, rt, S = r["cfg"], r["rt"], args.prompt_len
    max_len = S + args.new_tokens + 1
    flips, dropped, rel, plain_err, rows, pre = _moe_prefill_checks(
        torch, r, counters, max_len)
    served = r.pop("cache")
    tok = r["generated"][:, -1]
    rt_abs = dataclasses.replace(rt, absorbed_mla=True)
    a_flips, a_step_err, a_rows = _moe_step_check(
        torch, r, _clone_cache(served), tok, rt_abs, "absorbed decode")
    d_flips, step_err, d_rows = _moe_step_check(torch, r, served, tok, rt,
                                                "decode")
    del served
    torch.cuda.empty_cache()
    # the absorbed decode, counted, from a copy of the post-prefill cache
    for c in counters:
        c.reset()
    h_abs, h_mat = [], []
    abs_logits, abs_ms = _decode_loop(torch, r, _clone_cache(pre), rt_abs,
                                      h_abs)
    abs_launches = {c.name: c.value for c in counters}
    want = {c.name: 0 for c in counters}
    L, n_new = cfg.num_layers, args.new_tokens
    want.update({"decode_attention": L * n_new,
                 "moe_gmm": len(dropped) * n_new})
    if abs_launches != want:
        raise AssertionError(f"absorbed decode: launches {abs_launches}, "
                             f"want {want}")
    mat_logits, mat_ms = _decode_loop(torch, r, pre, rt, h_mat)
    del pre
    rerun_err = max(float((a - b).abs().max())
                    for a, b in zip(mat_logits, r["step_logits"]))
    # the two forms sum in other orders: a near-tie routing flip between
    # them sends a token through another expert, and that sequence's
    # caches, and so its later steps, part; those rows are reported
    _, _, p_seg = _moe_segment(cfg, r["params"])
    hit, ab_flips, abs_err, held_err = set(), [], 0.0, 0.0
    for t, (a, m) in enumerate(zip(abs_logits, mat_logits)):
        flips_t, _ = _routing_flips(p_seg, cfg, rt.capacity_factor,
                                    h_abs[t], h_mat[t],
                                    f"absorbed vs materialized, step {t}",
                                    tainted=hit)
        ab_flips += flips_t
        hit |= {f["batch"] for f in flips_t}
        keep = [b for b in range(a.shape[0]) if b not in hit]
        abs_err = max(abs_err, float((a - m).abs().max()))
        if keep:
            held_err = max(held_err, float((a[keep] - m[keep]).abs().max()))
        if keep and not torch.allclose(a[keep], m[keep], rtol=2e-3,
                                       atol=2e-3):
            raise AssertionError(f"{cfg.name}: absorbed vs materialized "
                                 f"decode step {t}, rows {keep}: max abs err "
                                 f"{float((a[keep] - m[keep]).abs().max())}")
    ab_rows = [b for b in range(r["generated"].shape[0]) if b not in hit]
    del abs_logits, mat_logits, h_abs, h_mat
    torch.cuda.empty_cache()
    tf_err, tf_flips = _moe_teacher_forced(
        torch, r, tf_prompt, forms=((), (("absorbed_mla", True),)))
    E, k = cfg.moe.n_routed_experts, cfg.moe.top_k
    n = len(dropped)
    total = args.batch * S * k * n
    print(f"    routing: {len(flips)} flipped choices over "
          f"{args.batch * S * n} prefill routings, "
          f"{len(d_flips) + len(a_flips)} over {2 * args.batch * n} decode "
          f"routings; prefill logits vs plain max abs err {plain_err:.3g} "
          f"(held on rows {rows}); moe_apply same-input max err/RMS "
          f"{max(rel):.3g}; capacity dropped {sum(dropped)} of {total} "
          f"routed choices in prefill (per layer {dropped}); served decode "
          f"step vs plain {step_err:.3g} (held on rows {d_rows}), absorbed "
          f"step vs plain {a_step_err:.3g} (held on rows {a_rows})",
          flush=True)
    print(f"    absorbed decode: launches {abs_launches}; {abs_ms:.3f} "
          f"ms/token against {mat_ms:.3f} ms/token materialized from the "
          f"same cache ({r['decode_ms_per_token']:.3f} served); logits vs "
          f"materialized max abs err {held_err:.3g} on the rows held "
          f"{ab_rows} (2e-3; {len(ab_flips)} routing flips, {abs_err:.3g} "
          f"over all rows); materialized rerun vs served steps "
          f"{rerun_err:.3g}; cached vs teacher-forced (capacity factor "
          f"{E / k:g}, prompt {tf_prompt}, both forms) {tf_err:.3g} "
          f"({len(tf_flips)} routing flips)", flush=True)
    rec = _llm_record(r, args, launches, card,
                      prefill_vs_plain_max_abs_err=plain_err,
                      prefill_logits_held_rows=rows,
                      routing_flips=flips + d_flips + a_flips,
                      moe_same_input_max_err_over_rms=rel,
                      prefill_dropped_choices=dropped,
                      prefill_routed_choices=total,
                      decode_step_vs_plain_max_abs_err=step_err,
                      decode_step_held_rows=d_rows,
                      absorbed_step_vs_plain_max_abs_err=a_step_err,
                      absorbed_step_held_rows=a_rows,
                      absorbed_launches=abs_launches,
                      absorbed_decode_ms_per_token=abs_ms,
                      materialized_rerun_decode_ms_per_token=mat_ms,
                      absorbed_vs_materialized_max_abs_err=held_err,
                      absorbed_vs_materialized_held_rows=ab_rows,
                      absorbed_vs_materialized_all_rows_max_abs_err=abs_err,
                      absorbed_vs_materialized_routing_flips=ab_flips,
                      materialized_rerun_vs_served_max_abs_err=rerun_err,
                      decode_vs_forward_max_abs_err=tf_err,
                      decode_vs_forward_routing_flips=tf_flips,
                      decode_vs_forward_prompt=tf_prompt,
                      decode_vs_forward_capacity_factor=E / k)
    if profile:
        rec["profile"] = phase_llm_profile(torch, r, max_len,
                                           absorbed_ms=abs_ms)
    record[f"llm_{args.arch}"] = rec
    del r
    torch.cuda.empty_cache()
    return rec


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
        by_kernel = _device_ms_by_kernel(torch, prof)
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
    ctx = {"dev": dev, "rng": rng, "members": members, "vitals": vitals,
           "labs": labs, "svc": svc, "lat": lat, "refs": refs, "ingest": di}
    return launches, conv_per_flush, ctx


def phase_slots(torch, np, ctx, record, card, conv_per_tick):
    """The slot engine over phase 3's full zoo, its vitals and labs
    models and its device: ingest on the card (64 beds, 1-s chunks),
    10 counted rounds of "close all 64 windows, tick", then the checks
    against the flush and the plain versions, the slot server and the
    slot pipeline.  Every check raises on failure."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.ecg_zoo import (ECG_HZ, ECG_LEADS, N_LABS,
                                             N_VITALS, VITALS_HZ)
    from repro_torch.kernels import conv1d_stripe as kconv
    from repro_torch.kernels import window_gather as kgather
    from repro_torch.serving.aggregator import DeviceIngest, ModalitySpec
    from repro_torch.serving.pipeline import (EnsembleService,
                                              StreamingPipeline)
    from repro_torch.serving.server import EnsembleServer
    from repro_torch.serving.slots import SlotEngine

    dev, rng, svc = ctx["dev"], ctx["rng"], ctx["svc"]
    beds = 64
    mods = [ModalitySpec("ecg", ECG_HZ, ECG_LEADS),
            ModalitySpec("vitals", VITALS_HZ, N_VITALS)]
    counters = (kgather.launches, kconv.launches_stacked, kconv.launches)
    chunk_us = {"ecg": [], "vitals": []}

    def feed(di, t0, seconds=30):
        """``seconds`` 1-s chunks of ECG and vitals for every bed, each
        ``ingest`` call timed on the host; then every bed's window is
        closed (with a labs vector) and its ref returned."""
        for s in range(seconds):
            for bed in range(beds):
                for m, c, k in (("ecg", ECG_LEADS, ECG_HZ),
                                ("vitals", N_VITALS, VITALS_HZ)):
                    x = rng.standard_normal((c, k)).astype(np.float32)
                    t = time.perf_counter()
                    di.ingest(t0 + s, bed, m, x)
                    chunk_us[m].append(1e6 * (time.perf_counter() - t))
        return [di.close_window(bed, t0 + seconds, extra={
            "labs": rng.standard_normal(N_LABS).astype(np.float32)})
            for bed in range(beds)]

    def reads(eng, slots):
        return np.array([eng.read(s) for s in slots])

    di = DeviceIngest(mods, beds, 30.0, device=dev)
    eng = SlotEngine(svc, di)
    eng.warm()
    refs = feed(di, 0.0)                   # untimed-by-tick first window
    torch.cuda.synchronize()

    # ---- the slot path: counters at zero just before, read just after
    for c in counters:
        c.reset()
    ticks = []
    for rnd in range(10):
        if rnd:
            refs = feed(di, 30.0 * rnd)
        for r in refs:
            eng.update(r)
        t = time.perf_counter()
        rep = eng.tick()
        ticks.append(time.perf_counter() - t)
        if rep.n_scored != beds or len(rep.stamped) != beds \
                or rep.spad != 64:
            raise AssertionError(f"tick {rnd}: {rep}")
    launches = {c.name: c.value for c in counters}
    per_tick = {k: v / 10 for k, v in launches.items()}
    print(f"  slot path: 10 ticks of {beds} beds; launches {launches}",
          flush=True)
    if min(launches["window_gather"], launches["conv1d_stripe_stacked"]) \
            <= 0:
        raise AssertionError(f"a kernel of the slot path never launched: "
                             f"{launches}")
    want_tick = {"window_gather": 2, "conv1d_stripe_stacked": conv_per_tick,
                 "conv1d_stripe": 0}
    if per_tick != want_tick:
        raise AssertionError(f"launches per tick {per_tick}, want "
                             f"{want_tick} (1 ECG + 1 vitals gather, the "
                             f"flush's convs)")
    if eng.dispatch_count != 10 * svc.n_buckets:
        raise AssertionError(f"10 ticks dispatched {eng.dispatch_count} "
                             f"bucket passes, want 10 x {svc.n_buckets}")
    for c in counters:
        c.reset()
    d0 = eng.dispatch_count
    got64 = reads(eng, range(beds))
    if any(c.value for c in counters) or eng.dispatch_count != d0:
        raise AssertionError(f"64 reads launched {[c.value for c in counters]}"
                             f" kernels, {eng.dispatch_count - d0} passes")

    # device busy of one tick (traced), after the counted run
    for r in refs:
        eng.update(r)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.tick()
        torch.cuda.synchronize()
    by_kernel = _device_ms_by_kernel(torch, prof)
    busy = sum(ms for ms, _ in by_kernel.values())

    # ---- checks, each against the run above
    failures = []
    flush64 = np.array(svc.predict_batch(refs))
    if not np.array_equal(got64, flush64):
        failures.append(f"tick != flush at 64 of 64: max abs err "
                        f"{np.abs(got64 - flush64).max():.3g}")
    plain = EnsembleService(ctx["members"], vitals_model=ctx["vitals"],
                            labs_model=ctx["labs"], impl="torch",
                            device=dev)
    peng = SlotEngine(plain, di)
    for r in refs:
        peng.update(r)
    peng.tick()
    plain_err = float(np.abs(reads(peng, range(beds)) - got64).max())
    if not plain_err <= TOL:
        failures.append(f"tick vs the plain versions' tick: {plain_err}")
    keep = np.sort(rng.choice(beds, 40, replace=False))
    for s in sorted(set(range(beds)) - set(keep.tolist())):
        eng.discharge(s)
    eng.tick()
    got40 = reads(eng, keep)
    flush40 = np.array(svc.predict_batch([refs[s] for s in keep]))
    if not np.array_equal(got40, flush40):
        failures.append(f"tick != flush at 40 of 64: max abs err "
                        f"{np.abs(got40 - flush40).max():.3g}")
    eng.ensure_slots(128)
    for r in refs:
        eng.update(r)                           # re-admits the other 24
    rep128 = eng.tick()
    got128 = reads(eng, range(beds))
    filler = di.close_window(beds, 400.0)       # valid 0: an all-zero row
    flush128 = np.array(svc.predict_batch(refs + [filler]))[:beds]
    if rep128.spad != 128 or not np.array_equal(got128, flush128):
        failures.append(f"tick at rung {rep128.spad} != flush at 128: max "
                        f"abs err {np.abs(got128 - flush128).max():.3g}")
    rung_err = float(np.abs(got128 - flush64).max())
    rung_bitwise = bool(np.array_equal(got128, flush64))
    if not rung_err <= TOL:
        failures.append(f"rung 128 vs rung 64: {rung_err}")
    every = np.concatenate([got64, got40, got128])
    if not (np.all(np.isfinite(every)) and every.min() >= 0
            and every.max() <= 1):
        failures.append(f"scores outside [0, 1]: {every}")

    # ---- served: the slot server and the slot pipeline
    di2 = DeviceIngest(mods, beds, 30.0, device=dev)
    eng2 = SlotEngine(svc, di2)
    eng2.warm()
    refs2 = feed(di2, 0.0)
    srv = EnsembleServer(engine="slots", slot_engine=eng2, n_workers=2,
                         tick_interval=0.05, slot_wait_timeout=60.0).start()
    for bed, r in enumerate(refs2):
        if not srv.submit(bed, r):
            raise AssertionError(f"slot server shed bed {bed}")
    stats = srv.stop()
    served = {p: sc for p, sc, _, _ in srv.results()}
    srv_want = reads(eng2, range(beds))
    srv_got = np.array([served.get(p, np.nan) for p in range(beds)])
    if stats.served != beds or stats.failed or srv.leaked \
            or not np.array_equal(srv_got, srv_want):
        failures.append(f"slot server: served {stats.served}, failed "
                        f"{stats.failed}, leaked {srv.leaked}, scores equal "
                        f"{np.array_equal(srv_got, srv_want)}")
    pipes = {e: StreamingPipeline(svc, n_patients=16, device_ingest=True,
                                  engine=e, device=dev)
             for e in ("flush", "slots")}
    closed = {}                       # (bed, t_window) -> the slot ref
    slot_update = pipes["slots"].slot_engine.update

    def keep_ref(ref):
        closed[(ref.patient, pipes["slots"].device_ingest
                .window_start[ref.patient])] = ref
        return slot_update(ref)
    pipes["slots"].slot_engine.update = keep_ref
    for t0 in (0, 31):
        for s in range(31):
            for bed in range(16):
                ecg = rng.standard_normal((3, ECG_HZ)).astype(np.float32)
                vit = rng.standard_normal((N_VITALS, 1)).astype(np.float32)
                for pipe in pipes.values():
                    pipe.feed(float(t0 + s), bed, "ecg", ecg)
                    pipe.feed(float(t0 + s), bed, "vitals", vit)
    pipes["slots"].tick_now(62.0)
    by_key = {e: {(r.patient, r.t_window): r.score for r in p.records}
              for e, p in pipes.items()}
    pipe_keys = sorted(by_key["flush"])
    pipe_f = np.array([by_key["flush"][k] for k in pipe_keys])
    pipe_s = np.array([by_key["slots"].get(k, np.nan) for k in pipe_keys])
    # the flush pipeline scores each window alone (rung 1), the slot
    # pipeline's ticks run at rung 16: held to the tolerance across
    # rungs (whether the bits agree is recorded), and bitwise to a
    # flush of the same refs at rung 16
    pipe_err = float(np.abs(pipe_s - pipe_f).max())
    pipe_bitwise = bool(np.array_equal(pipe_s, pipe_f))
    rung16 = {}
    for t_w in sorted({t for _, t in closed}):
        ks = [k for k in sorted(closed) if k[1] == t_w]
        rung16.update(zip(ks, svc.predict_batch([closed[k] for k in ks])))
    pipe_16 = np.array([rung16.get(k, np.nan) for k in pipe_keys])
    if len(pipe_keys) != 32 or sorted(by_key["slots"]) != pipe_keys \
            or sorted(closed) != pipe_keys or not pipe_err <= TOL \
            or not np.array_equal(pipe_s, pipe_16):
        failures.append(f"slot pipeline: {len(by_key['slots'])} / "
                        f"{len(pipe_keys)} records, max abs err "
                        f"{pipe_err:.3g} against the flush pipeline, bitwise "
                        f"a rung-16 flush {np.array_equal(pipe_s, pipe_16)}")

    ing = {m: {"p50_us": float(np.percentile(v, 50)),
               "p95_us": float(np.percentile(v, 95)), "chunks": len(v)}
           for m, v in chunk_us.items()}
    # device time of one chunk's writes: 64 chunks of a modality traced
    for m, c, k in (("ecg", ECG_LEADS, ECG_HZ),
                    ("vitals", N_VITALS, VITALS_HZ)):
        xs = [rng.standard_normal((c, k)).astype(np.float32)
              for _ in range(beds)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for bed in range(beds):
                di2.ingest(40.0, bed, m, xs[bed])
            torch.cuda.synchronize()
        ing[m]["device_us"] = 1e3 * sum(
            ms for ms, _ in _device_ms_by_kernel(torch, prof).values()) \
            / beds
    tick_ms = np.array(ticks) * 1e3
    out = {"beds": beds, "launches": launches, "launches_per_tick": per_tick,
           "dispatch_per_tick": svc.n_buckets,
           "tick_p50_ms": float(np.percentile(tick_ms, 50)),
           "tick_p95_ms": float(np.percentile(tick_ms, 95)),
           "tick_ms": tick_ms.tolist(), "tick_device_busy_ms": busy,
           "tick_by_kernel": {k: {"ms": ms, "count": n}
                              for k, (ms, n) in by_kernel.items()},
           "flush_p50_ms_P64": ctx["lat"][64]["p50_ms"],
           "ingest": ing,
           "tick_vs_plain_max_abs_err": plain_err,
           "rung128_vs_rung64_max_abs_err": rung_err,
           "rung128_bitwise_rung64": rung_bitwise,
           "pipeline_vs_flush_max_abs_err": pipe_err,
           "pipeline_bitwise": pipe_bitwise,
           "server": {"served": stats.served, "failed": stats.failed},
           "failures": failures}
    record["slots"] = out
    print(f"  slots on {card}: tick p50 {out['tick_p50_ms']:.2f} ms p95 "
          f"{out['tick_p95_ms']:.2f} ms (P=64 flush p50 "
          f"{out['flush_p50_ms_P64']:.2f} ms), device busy {busy:.2f} ms "
          f"a tick; launches per tick {per_tick}; ingest host us per chunk "
          f"ecg p50 {ing['ecg']['p50_us']:.1f} p95 {ing['ecg']['p95_us']:.1f}"
          f" (device {ing['ecg']['device_us']:.2f}), vitals p50 "
          f"{ing['vitals']['p50_us']:.1f} p95 {ing['vitals']['p95_us']:.1f} "
          f"(device {ing['vitals']['device_us']:.2f}); tick vs plain {plain_err:.3g}; rung 128 vs "
          f"64 {rung_err:.3g} (bitwise {rung_bitwise}); pipeline vs flush "
          f"{pipe_err:.3g} (bitwise {pipe_bitwise})", flush=True)
    if failures:
        raise AssertionError("slot engine: " + "; ".join(failures))
    return out


def phase_placement(torch, np, ctx, record, card):
    """Placement over 4 lanes of ``cuda:0`` on phase 3's full zoo,
    models, ingest and refs: the LPT plan from the 20 bucket costs
    measured at ``PLAN_BATCH``; the 4-lane flush (refs path, P=8 and
    P=64) and slot ticks (64 beds) against the unsharded service in the
    same run (bitwise, the same launches, both p50s, device busy); then
    a lane lost for good (lane 2) under ``FaultPlane.protect`` behind an
    ``EnsembleServer`` over the 64 refs with a ``HotSwapper``
    (64/64 served, bitwise the unsharded oracle after failover, 3 lanes
    left, seconds from the loss to the first correct score), a
    ``re_place`` from the live costs, and the same loss mid-tick under
    ``protect_engine``.  Every check raises on failure."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.control.faults import FaultEvent, FaultPlane
    from repro_torch.control.swap import HotSwapper
    from repro_torch.device import lanes
    from repro_torch.kernels import conv1d_stripe as kconv
    from repro_torch.kernels import window_gather as kgather
    from repro_torch.obs import spans as _spans
    from repro_torch.serving import pipeline as _pl
    from repro_torch.serving.pipeline import PLAN_BATCH, EnsembleService
    from repro_torch.serving.server import EnsembleServer
    from repro_torch.serving.slots import SlotEngine, SlotTicker, TickLadder

    dev, svc, refs = ctx["dev"], ctx["svc"], ctx["refs"]
    members, di = ctx["members"], ctx["ingest"]
    side = {"vitals_model": ctx["vitals"], "labs_model": ctx["labs"]}
    counters = (kgather.launches, kconv.launches_stacked, kconv.launches)
    failures = []

    # ---- the plan, from the bucket costs measured on the card
    costs = svc.measured_bucket_costs(reps=3, batch=PLAN_BATCH)
    pl = svc.plan_placement(4, bucket_costs=costs)
    devs = lanes(4, dev)
    if any(d.device != dev for d in devs):
        raise AssertionError(f"a lane left the card: {devs}")
    plan = {"bucket_costs_ms": [1e3 * c for c in costs],
            "members_per_lane": [len(a) for a in pl.assignment],
            "load_ms_per_lane": [1e3 * x for x in pl.loads],
            "makespan_ms": 1e3 * pl.makespan, "imbalance": pl.imbalance}
    print(f"  plan over 4 lanes of {dev} from {len(costs)} bucket costs at "
          f"P={PLAN_BATCH} (ms): "
          + " ".join(f"{c:.2f}" for c in plan["bucket_costs_ms"]),
          flush=True)
    print(f"  lanes: members {plan['members_per_lane']}, load (ms) "
          + ", ".join(f"{x:.2f}" for x in plan["load_ms_per_lane"])
          + f"; makespan {plan['makespan_ms']:.2f} ms, imbalance "
          f"{pl.imbalance:.4f}", flush=True)
    sharded = EnsembleService(members, placement=pl, devices=devs, **side)
    t0 = time.perf_counter()
    sharded.warmup(batch_sizes=(1, 8, 64))
    warm_s = time.perf_counter() - t0
    if sharded.device != dev or any(
            b.tdev != dev or b.device not in devs
            for b in sharded._buckets):
        raise AssertionError("a shard is off its lane")

    # ---- the same work unsharded, then over the 4 lanes: counters at
    # zero just before each, read just after
    flat_eng, eng = SlotEngine(svc, di), SlotEngine(sharded, di)
    for r in refs:
        flat_eng.update(r)
        eng.update(r)
    if len(eng.groups) != 4 or len(flat_eng.groups) != 1:
        raise AssertionError(f"groups: {len(eng.groups)} over 4 lanes, "
                             f"{len(flat_eng.groups)} unsharded")
    runs = {}
    for name, s_, e_ in (("unsharded", svc, flat_eng),
                         ("4 lanes", sharded, eng)):
        torch.cuda.synchronize()
        for c in counters:
            c.reset()
        d0 = s_.dispatch_count
        out = {P: np.array(s_.predict_batch(refs[:P])) for P in (8, 64)}
        rep = e_.tick()
        out["tick"] = np.array([e_.read(b) for b in range(64)])
        runs[name] = {"out": out, "passes": s_.dispatch_count - d0,
                      "launches": {c.name: c.value for c in counters},
                      "stamped": len(rep.stamped)}
    a, b_ = runs["unsharded"], runs["4 lanes"]
    bitwise = {k: bool(np.array_equal(a["out"][k], b_["out"][k]))
               for k in (8, 64, "tick")}
    for k, same in bitwise.items():
        if not same:
            failures.append(f"4 lanes != unsharded at {k}: max abs err "
                            f"{np.abs(a['out'][k] - b_['out'][k]).max():.3g}")
    if a["launches"] != b_["launches"] or a["passes"] != b_["passes"] \
            or b_["stamped"] != 64 \
            or min(b_["launches"]["window_gather"],
                   b_["launches"]["conv1d_stripe_stacked"]) <= 0:
        failures.append(f"launches: unsharded {a['launches']} ({a['passes']}"
                        f" passes), 4 lanes {b_['launches']} "
                        f"({b_['passes']} passes, {b_['stamped']} stamped)")
    print(f"  4-lane flushes at P=8 and P=64 and one 64-bed tick: launches "
          f"{b_['launches']} (unsharded {a['launches']}); bitwise equal "
          f"{bitwise}", flush=True)

    # ---- times: phase 3's service, two unsharded ones built and warmed
    # as the 4-lane one was (one over the members in plan order: it
    # issues the 20 bucket passes in the 4-lane order, and its Eq. 5
    # sum runs in another order, so it is held within TOL), and the
    # 4-lane one, in turns, in this run; with each flush's dispatch span
    # (the 4-lane one's holds its shards' retire-clock events, the
    # unsharded ones take none)
    def warmed(mems):
        s_ = EnsembleService(mems, device=dev, **side)
        s_.warmup(batch_sizes=(1, 8, 64))
        e_ = SlotEngine(s_, di)
        for r in refs:
            e_.update(r)
        return s_, e_

    # the 4-lane flush with its shards' retire clocks on the host (no
    # CUDA event): what the events cost it
    clocks = (_pl._clock_start, _pl._clock_stop)
    host_clocks = (lambda d: time.perf_counter(),
                   lambda d, t0: time.perf_counter() - t0)

    order = [i for slot in pl.assignment for i in slot]
    quad = (("unsharded", svc, flat_eng, True),
            ("unsharded fresh", *warmed(members), True),
            ("unsharded, plan order", *warmed([members[i] for i in order]),
             False),
            ("4 lanes", sharded, eng, True),
            ("4 lanes, host clock", sharded, None, True))
    lat = {n: {8: [], 64: [], "tick": []} for n, _, _, _ in quad}
    span = {n: {8: [], 64: []} for n, _, _, _ in quad}

    def same(name, exact, got, want, what):
        ok = np.array_equal(got, want) if exact else \
            np.allclose(got, want, rtol=TOL, atol=TOL)
        if not ok:
            failures.append(f"{name} {what} != unsharded: max abs err "
                            f"{np.abs(np.asarray(got) - want).max():.3g}")

    for i in range(8):
        for name, s_, e_, exact in (quad if i % 2 == 0 else quad[::-1]):
            for P in (8, 64):
                _pl._clock_start, _pl._clock_stop = \
                    host_clocks if e_ is None else clocks
                with _spans.collect() as acc:
                    t = time.perf_counter()
                    got = np.array(s_.predict_batch(refs[:P]))
                    lat[name][P].append(time.perf_counter() - t)
                span[name][P].append(acc.get("dispatch", 0.0))
                same(name, exact, got, a["out"][P],
                     f"flush P={P} round {i}")
            if e_ is None:
                continue
            t = time.perf_counter()
            e_.tick()
            lat[name]["tick"].append(time.perf_counter() - t)
            same(name, exact, [e_.read(x) for x in range(64)],
                 a["out"]["tick"], f"tick round {i}")
    _pl._clock_start, _pl._clock_stop = clocks
    p50 = {n: {k: 1e3 * float(np.percentile(v, 50)) if v else None
               for k, v in d.items()} for n, d in lat.items()}
    dispatch_p50 = {n: {P: 1e3 * float(np.percentile(v, 50))
                        for P, v in d.items()} for n, d in span.items()}
    busy = {}
    for name, s_, _, _ in quad[:4]:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            s_.predict_batch(refs)
            torch.cuda.synchronize()
        busy[name] = sum(ms for ms, _ in _device_ms_by_kernel(
            torch, prof).values())
    names = [n for n, _, _, _ in quad]
    print(f"  flush p50 on {card} (ms), {' / '.join(names)}: P=8 "
          + " / ".join(f"{p50[n][8]:.2f}" for n in names) + "; P=64 "
          + " / ".join(f"{p50[n][64]:.2f}" for n in names)
          + "; tick (64 beds) "
          + " / ".join(f"{p50[n]['tick']:.2f}" for n in names[:4])
          + "; dispatch span p50 P=8 "
          + " / ".join(f"{dispatch_p50[n][8]:.2f}" for n in names)
          + ", P=64 "
          + " / ".join(f"{dispatch_p50[n][64]:.2f}" for n in names)
          + "; device busy of one P=64 flush "
          + " / ".join(f"{busy[n]:.2f}" for n in names[:4])
          + f" ms; 4-lane warm-up {warm_s:.2f} s", flush=True)

    # ---- a lane lost for good mid-run, behind the server
    ones = np.ones(len(members), np.int8)
    sw = HotSwapper(members, ones, n_devices=4, devices=devs,
                    warmup_batch_sizes=(1, 8), placement_fn=lambda s: pl,
                    device=dev, **side)
    sw.placement_fn = None           # re-planning from live costs later
    plane = FaultPlane([FaultEvent(0.15, "device_loss", target=2)])
    plane.arm(sw, devices=devs)
    done = []

    def score(batch):
        out = sw.facade.predict_batch(batch)
        done.append((time.monotonic(), list(batch), out))
        return out

    srv = EnsembleServer(batch_handler=plane.protect(score, sw,
                                                     retry_sleep=0.002),
                         n_workers=2, max_batch=8).start()
    for bed, r in enumerate(refs):
        if not srv.submit(bed, r):
            raise AssertionError(f"failover server shed bed {bed}")
    stats = srv.stop()
    served = srv.results()
    scores = np.array([sc for _, sc, _, _ in served])
    fired = [t for t, ev in plane.fired if ev.kind == "device_loss"]
    t_loss = plane._armed_at + fired[0] if fired else float("nan")
    after = [t for t, _, _ in done if t > t_loss]
    failover_s = (min(after) - t_loss) if after else float("nan")
    n_bad = sum(not np.array_equal(out, svc.predict_batch(batch))
                for _, batch, out in done)
    if stats.served != 64 or stats.failed or len(served) != 64 \
            or srv.leaked or np.isnan(scores).any() or not fired:
        failures.append(f"failover server: served {stats.served}/64, "
                        f"failed {stats.failed}, NaN "
                        f"{int(np.isnan(scores).sum())}, leaked {srv.leaked}, "
                        f"loss fired {bool(fired)}")
    if sw.quarantined != [devs[2]] or len(sw.devices) != 3 \
            or sw.active_placement.n_slots != 3 \
            or list(plane._failover_threads) != [2] or n_bad \
            or devs[2] in {b.device for b in sw.facade.current._buckets}:
        failures.append(f"failover: quarantined {sw.quarantined}, lanes "
                        f"{len(sw.devices)}, threads "
                        f"{list(plane._failover_threads)}, {n_bad} batches "
                        f"not bitwise the unsharded oracle")
    fo_plan = [len(x) for x in sw.active_placement.assignment]
    live = sw.facade.current.live_bucket_costs()
    replaced = sw.re_place()
    rp = sw.active_placement
    after_rp = np.array(sw.facade.predict_batch(refs[:8]))
    if not np.array_equal(after_rp, a["out"][8]):
        failures.append("after re_place the P=8 flush is not bitwise")
    print(f"  failover: {stats.served}/64 served, {stats.failed} failed, "
          f"{len(done)} batches bitwise the unsharded oracle {n_bad == 0}; "
          f"lane 2 lost at {fired[0] if fired else float('nan'):.3f} s, first "
          f"correct score {failover_s:.3f} s later; members per lane "
          f"{fo_plan} on 3 lanes; re_place from live costs "
          f"({'measured' if live else 'none'}): changed {replaced}, members "
          f"per lane {[len(x) for x in rp.assignment]}, load (ms) "
          + ", ".join(f"{1e3 * x:.2f}" for x in rp.loads)
          + f", imbalance {rp.imbalance:.4f}", flush=True)

    # ---- the same loss mid-tick, through protect_engine
    sw2 = HotSwapper(members, ones, n_devices=4, devices=devs,
                     warmup_batch_sizes=(64,), placement_fn=lambda s: pl,
                     device=dev, **side)
    eng2 = SlotEngine(sw2.facade.current, di)
    ticker = SlotTicker(eng2, interval=0.05)          # driven by hand
    ladder = TickLadder(ticker, intervals=(0.2, 0.05))
    clock = {"t": 0.0}
    plane2 = FaultPlane([FaultEvent(1.0, "device_loss", target=2)],
                        clock=lambda: clock["t"])
    plane2.arm(sw2, devices=devs)
    plane2.protect_engine(eng2, sw2, ticker=ticker, tick_ladder=ladder)
    for r in refs:
        eng2.update(r)
    eng2.tick()
    clock["t"] = 2.0                                  # the loss fires
    t = time.perf_counter()
    rep2 = eng2.tick()
    slot_failover_s = time.perf_counter() - t
    got2 = np.array([eng2.read(x) for x in range(64)])
    if eng2.n_tick_aborts or not eng2.n_rebinds \
            or sw2.quarantined != [devs[2]] or len(eng2.groups) != 3 \
            or len(rep2.stamped) != 64 or ladder.ladder_pos != 1 \
            or not np.array_equal(got2, a["out"]["tick"]):
        failures.append(f"slot failover: aborts {eng2.n_tick_aborts}, "
                        f"rebinds {eng2.n_rebinds}, quarantined "
                        f"{sw2.quarantined}, groups {len(eng2.groups)}, "
                        f"stamped {len(rep2.stamped)}, bitwise "
                        f"{np.array_equal(got2, a['out']['tick'])}")
    print(f"  slot failover: the tick that met the loss recovered and "
          f"re-ran in {slot_failover_s:.3f} s ({eng2.n_tick_faults} fault, "
          f"{eng2.n_rebinds} rebind, {len(eng2.groups)} groups); bitwise "
          f"the unsharded tick {np.array_equal(got2, a['out']['tick'])}",
          flush=True)
    out = {"plan": plan, "lanes": [str(d) for d in devs],
           "launches": b_["launches"], "launches_unsharded": a["launches"],
           "bitwise": {str(k): v for k, v in bitwise.items()},
           "passes": b_["passes"], "p50_ms": p50,
           "dispatch_span_p50_ms": dispatch_p50,
           "device_busy_ms_P64": busy, "warmup_s": warm_s,
           "failover": {"served": stats.served, "failed": stats.failed,
                        "seconds_to_first_correct_score": failover_s,
                        "loss_at_s": fired[0] if fired else None,
                        "members_per_lane": fo_plan,
                        "replace_changed": replaced,
                        "replace_members_per_lane":
                            [len(x) for x in rp.assignment],
                        "replace_imbalance": rp.imbalance,
                        "slot_recovery_tick_s": slot_failover_s},
           "failures": failures}
    record["placement"] = out
    if failures:
        raise AssertionError("placement: " + "; ".join(failures))
    return out


def phase_control(torch, np, ctx, record, card):
    """The closed control loop over phase 3's full zoo, models and 64
    refs.  (a) Fleet shed and climb: a ``HotSwapper`` over three
    bucket-granular rungs cut from the 20 bucket costs at ``PLAN_BATCH``
    (cheap, mid, full), behind an ``EnsembleServer`` tapped by an
    ``SloTelemetry``, the SLO at the geometric mean of a 64-bed round's
    p99 at full and at cheap; ``wire_controller`` (stepped by hand, with
    a ``MetricsExporter``) sheds under 64-bed rounds and climbs back
    under 8-bed ones.  (b) RE-PLACE from retire drift over two lanes of
    the card, lane 0 slowed by a 20 ms host sleep in its guard, until a
    step returns REPLACE.  (c) Tiers: a ``TieredEnsemble`` over one
    staging cache, a ``TieredController`` over a ``TieredTelemetry``
    and a tiered server over the 64 beds (a third critical), overloaded
    and stepped by hand.  Every served score is held bitwise to an
    unsharded flush of the same refs by the selector that scored it.
    Every check raises on failure."""
    import threading
    from repro_torch.control import (ControllerConfig, Decision,
                                     HotSwapper, SloTelemetry, TIER_ORDER,
                                     TieredController,
                                     TieredControllerConfig, TieredEnsemble,
                                     TieredTelemetry, wire_controller)
    from repro_torch.device import lanes
    from repro_torch.kernels import conv1d_stripe as kconv
    from repro_torch.kernels import window_gather as kgather
    from repro_torch.obs.export import MetricsExporter
    from repro_torch.serving.pipeline import PLAN_BATCH, EnsembleService
    from repro_torch.serving.placement import (grouped_lpt_placement,
                                               placement_signature)
    from repro_torch.serving.server import EnsembleServer

    dev, svc, refs = ctx["dev"], ctx["svc"], ctx["refs"]
    members = ctx["members"]
    side = {"vitals_model": ctx["vitals"], "labs_model": ctx["labs"]}
    counters = (kgather.launches, kconv.launches_stacked, kconv.launches)
    n, beds, failures = len(members), len(refs), []
    window_s = 2.0                 # the telemetry window the drill ages
    lock = threading.Lock()

    # ---- the ladder: the cheapest buckets summing to <= 1/4 and <= 1/2
    # of the 20 bucket costs, and the full zoo
    costs = svc.measured_bucket_costs(reps=3, batch=PLAN_BATCH)
    total = float(np.sum(costs))

    def rung(frac):
        sel, acc = np.zeros(n, np.int8), 0.0
        for j in np.argsort(costs, kind="stable"):
            if acc + costs[j] > frac * total:
                break
            acc += costs[j]
            sel[svc._buckets[j].idx] = 1
        return sel

    names = ("cheap", "mid", "full")
    ladder = [rung(0.25), rung(0.5), np.ones(n, np.int8)]
    if not 0 < ladder[0].sum() < ladder[1].sum() < n:
        raise AssertionError(f"rungs of {[int(s.sum()) for s in ladder]}")
    oracles = [EnsembleService.for_selector(members, s, device=dev, **side)
               for s in ladder[:2]] + [svc]
    member_costs = svc.measured_costs(reps=3)

    def round_(srv, k, tel=None):
        """``k`` beds submitted at once and drained: the round's
        latencies; with ``tel``, its arrivals = served + shed + failed."""
        since = time.monotonic()
        time.sleep(0.02)                   # past one sketch bucket
        for bed in range(k):
            if not srv.submit(bed, refs[bed]):
                failures.append(f"bed {bed} shed")
        srv.drain(timeout=60.0)
        got = srv.results()
        nan = int(np.isnan([x[1] for x in got]).sum())
        if len(got) != k or nan:
            failures.append(f"a {k}-bed round served {len(got)}, NaN {nan}")
        if tel is not None:
            s = tel.snapshot(since=since)
            if not s.n_arrivals == k == s.n_served + s.n_shed + s.n_failed:
                failures.append(f"telemetry: {s.n_arrivals} arrivals, "
                                f"{s.n_served} served, {s.n_shed} shed, "
                                f"{s.n_failed} failed of {k}")
        return [x[2] for x in got]

    # ---- counters at zero just before the drills, read just after
    # (the oracle flushes at the end are not the path)
    torch.cuda.synchronize()
    for c in counters:
        c.reset()
    t_phase = time.perf_counter()

    # ==== (a) fleet shed and climb behind the flush server
    t0 = time.perf_counter()
    sw = HotSwapper(members, ladder[2], warmup_batch_sizes=(1, 8, 64),
                    device=dev, **side)
    sw.set_ladder(ladder, prestage=True)
    stage_s = time.perf_counter() - t0
    rung_of = {id(sw.stage(s)): k for k, s in enumerate(ladder)}
    flushes = []                     # (t_retire, rung, refs, scores)

    def score(batch):
        cur = sw.facade.current      # the member identity that scores
        out = list(cur.predict_batch(batch))
        with lock:
            flushes.append((time.monotonic(), rung_of[id(cur)],
                            list(batch), out))
        return out

    calib = EnsembleServer(batch_handler=score, n_workers=2,
                           max_batch=64).start()
    p99 = {}
    for k, size in ((2, beds), (0, beds), (1, 8)):
        sw.swap_to(ladder[k])
        round_(calib, size)                # one untimed round first
        p99[k, size] = float(np.percentile(round_(calib, size), 99))
    calib.stop()
    sw.swap_to(ladder[2])
    full, cheap, mid8 = p99[2, beds], p99[0, beds], p99[1, 8]
    slo = math.sqrt(full * cheap)
    # CLIMB wants a window's p99 under headroom_frac of the SLO: 1.25x
    # the 8-bed p99 at mid, so that 8-bed rounds climb to full
    headroom = max(0.5, 1.25 * mid8 / slo)
    if full < 1.3 * cheap or headroom > 0.95:
        raise AssertionError(
            f"64-bed p99 full {1e3 * full:.1f} ms, cheap {1e3 * cheap:.1f}; "
            f"8-bed p99 mid {1e3 * mid8:.1f}: the drill cannot be run")
    tel = SloTelemetry(slo_seconds=slo, window_seconds=window_s)
    srv = EnsembleServer(batch_handler=score, n_workers=2, max_batch=64,
                         telemetry=tel).start()
    exporter = MetricsExporter(server=srv)
    # mu from the per-member batch-1 costs (the reference's profile)
    # states a 64-wide flush's capacity many times too low, so its
    # predicted-risk RECOMPOSE would stand through the drill, and an
    # 8-bed load after a 64-bed one is a drift: both are put out of
    # reach, as the reference's tick-ladder test does, to drill shed and
    # climb (the profile is still read and printed)
    ctl = wire_controller(
        tel, sw, member_costs=member_costs,
        config=ControllerConfig(slo_seconds=slo, cooldown_seconds=0.0,
                                min_samples=16, predicted_factor=1e9,
                                drift_factor=1e9, headroom_frac=headroom),
        sync=True, start=False, exporter=exporter)
    profile = ctl.service_profile_fn()
    step_ms, sheds, climbs, overload = [], [], [], []
    by_rung = {0: [], 1: [], 2: []}

    def step():
        t = time.perf_counter()
        d = ctl.step()
        step_ms.append(1e3 * (time.perf_counter() - t))
        return d

    for _ in range(6):                     # 64-bed rounds: SHED
        k = sw.ladder_pos
        lat = round_(srv, beds, tel)
        by_rung[k] += lat
        overload.append((names[k], 1e3 * float(np.percentile(lat, 99))))
        d = step()
        if d is Decision.SHED:
            sheds.append((time.monotonic(), sw.ladder_pos))
        elif overload[-1][1] <= 1e3 * slo:
            break
    predicted = ctl.snapshot().predicted_latency
    time.sleep(window_s + 0.1)             # the overload ages out
    for _ in range(24):                    # 8-bed rounds: CLIMB
        k = sw.ladder_pos
        by_rung[k] += round_(srv, 8, tel)
        if step() is Decision.CLIMB:
            climbs.append(sw.ladder_pos)
        if sw.ladder_pos == 2:
            break
    srv.stop()
    shed_to_cheaper = [min(t for t, k, _, _ in flushes
                           if t > t_s and k == pos) - t_s
                       for t_s, pos in sheds]
    served, counts = srv.stats.served, ctl.decision_counts()
    metric = {}
    for line in exporter.render().splitlines():
        if line and not line.startswith("#"):
            key, _, val = line.rpartition(" ")
            metric[key] = float(val)
    exported = {k: metric.get(f'holmes_controller_decisions_total'
                              f'{{decision="{k}"}}') for k in counts}
    if srv.leaked or srv.stats.failed or not sheds or not climbs \
            or sw.ladder_pos != 2:
        failures.append(f"(a): sheds {len(sheds)}, climbs {climbs}, rung "
                        f"{sw.ladder_pos}, failed {srv.stats.failed}, "
                        f"leaked {srv.leaked}")
    if metric.get("holmes_served_total") != served \
            or exported != {k: float(v) for k, v in counts.items()}:
        failures.append(f"exporter: served {metric.get('holmes_served_total')}"
                        f" vs {served}, decisions {exported} vs {counts}")
    tap = SloTelemetry(slo_seconds=slo, window_seconds=window_s)
    t = time.perf_counter()
    for _ in range(20000):
        tap.record_arrival()
        tap.record_served(0.05)
    tap_us = 1e6 * (time.perf_counter() - t) / 20000
    rung_p99 = {names[k]: 1e3 * float(np.percentile(v, 99))
                for k, v in by_rung.items() if v}
    a = {"slo_ms": 1e3 * slo, "headroom_frac": headroom,
         "calibration_p99_ms": {"full 64": 1e3 * full,
                                "cheap 64": 1e3 * cheap, "mid 8": 1e3 * mid8},
         "members": {nm: int(s.sum()) for nm, s in zip(names, ladder)},
         "stage_s": stage_s, "overload_rounds_p99_ms": overload,
         "rung_p99_ms": rung_p99,
         "decisions": [d.value for _, d in ctl.log],
         "step_ms_p50": float(np.percentile(step_ms, 50)),
         "tap_us_per_query": tap_us, "shed_to_cheaper_s": shed_to_cheaper,
         "served": served, "profile_mu_per_s": profile[0],
         "profile_ts_s": profile[1], "predicted_latency_s": predicted}
    print(f"  (a) on {card}: rungs {a['members']} members (staged and "
          f"warmed in {stage_s:.2f} s); SLO {a['slo_ms']:.1f} ms (64-bed p99 full "
          f"{1e3 * full:.1f}, cheap {1e3 * cheap:.1f}; 8-bed mid "
          f"{1e3 * mid8:.1f}; headroom {headroom:.2f}); decisions "
          f"{a['decisions']}; rung p99 (ms) "
          + ", ".join(f"{k} {v:.1f}" for k, v in rung_p99.items())
          + f"; step() p50 {a['step_ms_p50']:.3f} ms; telemetry tap "
          f"{tap_us:.2f} us a query; SHED to the first cheaper score (s) "
          + ", ".join(f"{x:.3f}" for x in shed_to_cheaper)
          + f"; {served} served; profile mu {profile[0]:.2f}/s, T_s "
          f"{1e3 * profile[1]:.1f} ms, predicted {predicted:.2f} s",
          flush=True)

    # ==== (b) RE-PLACE from retire drift, over 2 lanes of the card
    groups = [list(b.idx) for b in svc._buckets]
    pl_init = grouped_lpt_placement(
        groups, [1.0, 1.0] + [0.5] * (len(groups) - 2), 2)
    devs = lanes(2, dev)
    t0 = time.perf_counter()
    sw2 = HotSwapper(members, np.ones(n, np.int8), n_devices=2,
                     devices=devs, warmup_batch_sizes=(1, 8),
                     placement_fn=lambda s: pl_init, device=dev, **side)
    stage2_s = time.perf_counter() - t0
    sw2.placement_fn = None                # re-planning from the drift
    slow_keys = {tuple(sorted(b.idx)) for b in sw2.facade.current._buckets
                 if b.device == devs[0]}

    def guard(lane):
        if lane == devs[0]:
            time.sleep(0.02)               # lane 0 slowed down

    sw2.service_hook = lambda s: setattr(s, "dispatch_guard", guard)
    sw2.facade.current.dispatch_guard = guard
    flushes2 = []

    def score2(batch):
        out = list(sw2.facade.predict_batch(batch))
        with lock:
            flushes2.append((2, list(batch), out))
        return out

    tel2 = SloTelemetry(slo_seconds=60.0, window_seconds=60.0)
    ctl2 = wire_controller(
        tel2, sw2, member_costs=member_costs,
        config=ControllerConfig(slo_seconds=60.0, cooldown_seconds=0.0,
                                min_samples=8, predicted_factor=1e9,
                                drift_factor=1e9),
        sync=True, start=False)
    srv2 = EnsembleServer(batch_handler=score2, n_workers=2, max_batch=8,
                          telemetry=tel2).start()
    sig0 = placement_signature(sw2.active_placement)
    fin_before, replace_s, d2 = None, float("nan"), Decision.HOLD
    for _ in range(6):
        round_(srv2, 8)
        fin_before = sw2.facade.current.measured_finish_times()
        t = time.perf_counter()
        d2 = ctl2.step()
        if d2 is Decision.REPLACE:
            replace_s = time.perf_counter() - t
            break
    new_pl = sw2.active_placement
    for _ in range(2):
        round_(srv2, 8)
    fin_after = sw2.facade.current.measured_finish_times()
    srv2.stop()
    split = all(not slow_keys <= {tuple(sorted(b.idx))
                                  for b in sw2.facade.current._buckets
                                  if set(b.idx) <= set(slot)}
                for slot in new_pl.assignment)
    if d2 is not Decision.REPLACE or placement_signature(new_pl) == sig0 \
            or not split or len(slow_keys) < 2 or srv2.leaked \
            or srv2.stats.failed \
            or srv2.stats.served != sum(len(b) for _, b, _ in flushes2):
        failures.append(f"(b): decision {d2.value}, plan changed "
                        f"{placement_signature(new_pl) != sig0}, pair split "
                        f"{split}, served {srv2.stats.served}, failed "
                        f"{srv2.stats.failed}")
    b_out = {"finish_ms_before": [1e3 * x for x in fin_before or []],
             "finish_ms_after": [1e3 * x for x in fin_after or []],
             "replace_s": replace_s, "stage_s": stage2_s,
             "members_per_lane_before": [len(x) for x in pl_init.assignment],
             "members_per_lane": [len(x) for x in new_pl.assignment],
             "served": srv2.stats.served}
    print(f"  (b) on {card}: live finish times (ms) before "
          + ", ".join(f"{x:.1f}" for x in b_out["finish_ms_before"])
          + ", after " + ", ".join(f"{x:.1f}" for x in
                                   b_out["finish_ms_after"])
          + f"; REPLACE in {replace_s:.3f} s (measure and stage); members "
          f"per lane {b_out['members_per_lane_before']} -> "
          f"{b_out['members_per_lane']}; lane 0's {len(slow_keys)} buckets "
          f"split {split}; {srv2.stats.served} served", flush=True)

    # ==== (c) tiers over one staging cache
    t0 = time.perf_counter()
    te = TieredEnsemble(members, initial=ladder[2],
                        warmup_batch_sizes=(1, 8, 64), device=dev, **side)
    te.set_ladder(ladder)
    stage3_s = time.perf_counter() - t0
    staged0 = len(te.staging.staged)
    for bed in range(beds):                # beds 1, 4, 7, ...: critical
        te.registry.assign(bed, TIER_ORDER[(bed + 1) % 3])
    rung3 = {id(te.swapper("critical").stage(s)): k
             for k, s in enumerate(ladder)}
    flushes3 = []

    def score3(batch, tier):
        cur = te.swapper(tier or te.registry.default).facade.current
        out = list(cur.predict_batch(batch))
        with lock:
            flushes3.append((rung3[id(cur)], list(batch), out))
        return out

    tel3 = TieredTelemetry(te.tier_of, TIER_ORDER, slo_seconds=slo,
                           window_seconds=window_s)
    tier_ctl = TieredController(tel3, te.swappers,
                                config=TieredControllerConfig(
                                    slo_seconds=slo, cooldown_seconds=0.0,
                                    min_samples=16))
    srv3 = EnsembleServer(batch_handler=score3, tier_of=te.tier_of,
                          n_workers=2, max_batch=64, telemetry=tel3).start()
    rungs_seen, monotone = [], True
    for _ in range(8):
        round_(srv3, beds)
        tier_ctl.step()
        rungs_seen.append(te.rungs())
        monotone = monotone and te.monotone()
        if not any(s.can_shed() for s in te.swappers.values()):
            break
    srv3.stop()
    actions = [(tier, d.value) for _, tier, d in tier_ctl.log]
    held = all(r["stable"] == r["elevated"] == 0
               for r in rungs_seen if r["critical"] < 2)
    if not monotone or not held or not actions \
            or actions[0] != ("stable", "shed") or staged0 != len(ladder) \
            or len(te.staging.staged) != staged0 or srv3.leaked \
            or srv3.stats.failed or srv3.stats.served != sum(
                len(b) for _, b, _ in flushes3):
        failures.append(f"(c): monotone {monotone}, critical held {held}, "
                        f"staged {staged0} -> {len(te.staging.staged)}, "
                        f"actions {actions}, failed {srv3.stats.failed}")
    print(f"  (c) on {card}: rungs after each step {rungs_seen}; actions "
          f"{actions}; monotone {monotone}; critical held until no "
          f"alternative {held}; {staged0} (selector, placement) pairs "
          f"staged once for 3 tiers in {stage3_s:.2f} s, "
          f"{len(te.staging.staged)} after the drill", flush=True)
    torch.cuda.synchronize()
    launches = {c.name: c.value for c in counters}
    loop_s = time.perf_counter() - t_phase
    print(f"  control plane on {card}: launches {launches} in {loop_s:.1f} s",
          flush=True)
    if min(launches["window_gather"],
           launches["conv1d_stripe_stacked"]) <= 0:
        failures.append(f"a kernel of the path never launched: {launches}")

    # ---- every served score bitwise an unsharded flush of the same
    # refs by the selector that scored it
    logged = [f[1:] for f in flushes] + flushes2 + flushes3
    n_bad = sum(not np.array_equal(np.asarray(out), np.asarray(
        oracles[k].predict_batch(batch))) for k, batch, out in logged)
    n_checked = sum(len(batch) for _, batch, _ in logged)
    if n_bad:
        failures.append(f"{n_bad} of {len(logged)} flushes not bitwise "
                        f"their selector's unsharded flush")
    print(f"  control plane: {n_checked} served scores in {len(logged)} "
          f"flushes bitwise their selector's unsharded flush {n_bad == 0}",
          flush=True)
    out = {"a": a, "b": b_out,
           "c": {"rungs": rungs_seen, "actions": actions,
                 "staged": staged0, "stage_s": stage3_s},
           "launches": launches, "seconds": loop_s,
           "bitwise_checked": n_checked, "failures": failures}
    record["control"] = out
    if failures:
        raise AssertionError("control plane: " + "; ".join(failures))
    return out


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


def phase_only(torch, np, F, specs, record, card, names) -> int:
    """``--only=gather,flash,...``: phase 2 for the named kernels alone
    (gather, conv, mamba_conv, flash, decode, ssd, gmm), or ``flush``:
    phase 3 alone (the full zoo's main path and its P=8/P=64 flush
    times and host stages), its records in
    ``chiprun_out/chip_smoke_only.json``; no result line."""
    phases = {"flush": lambda: phase_main(torch, np, specs, record, card),
              "gather": lambda: phase_gather(torch, np, record),
              "conv": lambda: phase_conv(torch, np, F, specs, record),
              "mamba_conv": lambda: phase_mamba_conv(torch, np, F, record),
              "flash": lambda: phase_flash(torch, np, F, record),
              "decode": lambda: phase_decode(torch, np, F, record),
              "ssd": lambda: phase_ssd(torch, record),
              "gmm": lambda: phase_gmm(torch, record)}
    unknown = [n for n in names if n not in phases]
    if unknown:
        raise ValueError(f"--only: unknown phases {unknown}; known: "
                         f"{sorted(phases)}")
    for name in names:
        phases[name]()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_only.json").write_text(json.dumps(
        {k: v for k, v in record.items() if k != "nvcc_log"}, indent=1,
        default=str))
    print(f"  --only={','.join(names)}: done", flush=True)
    return 0


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
    profile = "--profile" in sys.argv
    only = [name for a in sys.argv[1:] if a.startswith("--only=")
            for name in a.split("=", 1)[1].split(",")]
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
    if only:
        return phase_only(torch, np, F, specs, record, card, only)
    gather = phase_gather(torch, np, record)
    conv = phase_conv(torch, np, F, specs, record)
    mconv = phase_mamba_conv(torch, np, F, record)
    flash = phase_flash(torch, np, F, record)
    decode = phase_decode(torch, np, F, record)
    ssd = phase_ssd(torch, record)
    gmm = phase_gmm(torch, record)

    print("phase 3: main path (full zoo)", flush=True)
    launches, conv_per_flush, ctx = phase_main(torch, np, specs, record,
                                               card, profile=profile)
    if conv_per_flush != conv[("conv1d_stripe_stacked", 64)]["calls"]:
        raise AssertionError(
            f"a flush launched {conv_per_flush} convs, the shape table "
            f"counts {conv[('conv1d_stripe_stacked', 64)]['calls']}")
    phase_small_reference(torch, np)

    print("phase 3b: slot engine (full zoo)", flush=True)
    slots = phase_slots(torch, np, ctx, record, card,
                        conv[("conv1d_stripe_stacked", 64)]["calls"])

    print("phase 3c: placement (full zoo, 4 lanes on cuda:0)", flush=True)
    placed = phase_placement(torch, np, ctx, record, card)

    print("phase 3d: control plane (full zoo)", flush=True)
    control = phase_control(torch, np, ctx, record, card)

    print("phase 4: dense-LM serving path (qwen3-4b, full width and "
          "depth; smollm-360m)", flush=True)
    from repro_torch.kernels import conv1d_stripe as kconv
    from repro_torch.kernels import decode_attention as kdecode
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import moe_gmm as kgmm
    from repro_torch.kernels import ssd as kssd
    from repro_torch.kernels import window_gather as kgather
    from repro_torch.configs.registry import get_config
    counters = (kgather.launches, kconv.launches_stacked, kconv.launches,
                kflash.launches, kdecode.launches, kssd.launches,
                kgmm.launches)
    served = ["--batch", "4", "--prompt-len", "2048", "--new-tokens", "32",
              "--seed", str(SEED)]

    def attention_launches(cfg, a, moe_layers=0):
        """``flash_attention`` once a layer in prefill, ``decode_attention``
        once a layer in every decode step; ``moe_gmm`` once a MoE layer in
        prefill and in every step."""
        L, n = cfg.num_layers, a.new_tokens
        want = {"flash_attention": L, "decode_attention": L * n}
        if moe_layers:
            want["moe_gmm"] = moe_layers * (1 + n)
        return want

    qwen = phase_llm(torch, np, record, card, ["--arch", "qwen3-4b"] + served,
                     counters, attention_launches, profile=profile)
    if (qwen["layers"], qwen["d_model"], qwen["launches"]["flash_attention"],
            qwen["launches"]["decode_attention"]) != (36, 2560, 36, 1152):
        raise AssertionError(f"qwen3-4b served at {qwen}")
    smollm = phase_llm(torch, np, record, card, ["--arch", "smollm-360m"],
                       counters, attention_launches)
    fp, fd = flash["qwen3-4b prefill"], decode["qwen3-4b decode"]
    share = {"prefill": 36 * fp["ms"] / (1e3 * qwen["prefill_s"]),
             "decode": 36 * fd["ms"] / qwen["decode_ms_per_token"]}
    record["llm_attention_share"] = share
    print(f"  qwen3-4b attention share (36 x kernel ms at the phase-2 "
          f"shapes over the served time): prefill {share['prefill']:.3f}, "
          f"decode step {share['decode']:.3f}", flush=True)

    print("phase 5: pure-SSM serving path (mamba2-2.7b, full width and "
          "depth)", flush=True)
    mamba = phase_llm(
        torch, np, record, card, ["--arch", "mamba2-2.7b"] + served,
        counters, lambda cfg, a: {"ssd": cfg.num_layers,
                                  "conv1d_stripe": 3 * cfg.num_layers},
        profile=profile)
    if (mamba["layers"], mamba["d_model"], mamba["launches"]["ssd"],
            mamba["launches"]["conv1d_stripe"]) != (64, 2560, 64, 192):
        raise AssertionError(f"mamba2-2.7b served at {mamba}")
    s_ms = ssd["served"]["ms"]
    print(f"  mamba2-2.7b ssd share (64 x kernel ms at the phase-2 shape "
          f"over the served prefill): "
          f"{64 * s_ms / (1e3 * mamba['prefill_s']):.3f}", flush=True)

    print("phase 6: MoE serving path (phi3.5-moe-42b-a6.6b, full width, "
          "depth 10 of 32)", flush=True)
    phi_cfg = dataclasses.replace(get_config("phi3.5-moe-42b-a6.6b"),
                                  num_layers=10)
    phi = phase_moe(torch, record, card,
                    ["--arch", "phi3.5-moe-42b-a6.6b"] + served, counters,
                    lambda cfg, a: attention_launches(cfg, a,
                                                      cfg.num_layers),
                    phi_cfg, profile=profile)
    m = phi_cfg.moe
    if (phi["layers"], phi["d_model"], m.n_routed_experts, m.top_k,
            phi["launches"]["moe_gmm"], phi["launches"]["flash_attention"],
            phi["launches"]["decode_attention"]) != (10, 4096, 16, 2, 330,
                                                     10, 320):
        raise AssertionError(f"phi3.5-moe served at {phi}")
    g_ms = {k: gmm[k]["ms"] for k in ("prefill", "decode")}
    print(f"  phi3.5-moe moe_gmm share (10 x kernel ms at the phase-2 "
          f"shapes over the served time): prefill "
          f"{10 * g_ms['prefill'] / (1e3 * phi['prefill_s']):.3f}, decode "
          f"step {10 * g_ms['decode'] / phi['decode_ms_per_token']:.3f}",
          flush=True)
    torch.cuda.empty_cache()

    print("phase 7: MLA serving path (deepseek-v2-lite-16b, full width "
          "and depth; materialized, then absorbed)", flush=True)
    ds_cfg = get_config("deepseek-v2-lite-16b")
    ds = phase_mla(torch, record, card,
                   ["--arch", "deepseek-v2-lite-16b"] + served, counters,
                   lambda cfg, a: attention_launches(
                       cfg, a, cfg.num_layers - cfg.moe.first_dense_layers),
                   profile=profile)
    m = ds_cfg.moe
    if (ds["layers"], ds["d_model"], m.n_routed_experts, m.top_k,
            ds["launches"]["flash_attention"],
            ds["launches"]["decode_attention"], ds["launches"]["moe_gmm"],
            ds["absorbed_launches"]["decode_attention"]) != (
                27, 2048, 64, 6, 27, 864, 858, 864):
        raise AssertionError(f"deepseek-v2-lite-16b served at {ds}")
    dm, da = (decode["deepseek MLA decode materialized"],
              decode["deepseek MLA decode absorbed"])
    print(f"  deepseek-v2-lite-16b decode_attention share (27 x kernel ms at "
          f"the phase-2 shapes over the decode step): materialized "
          f"{27 * dm['ms'] / ds['decode_ms_per_token']:.3f}, absorbed "
          f"{27 * da['ms'] / ds['absorbed_decode_ms_per_token']:.3f}",
          flush=True)

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
    conv_stacked = conv_row("conv1d_stripe_stacked",
                            ("conv1d_stripe_stacked", 64),
                            "src/repro/kernels/conv1d_stripe.py:99")
    conv_stacked["launches_by_path"] = {
        "flush main path (phase 3)": launches["conv1d_stripe_stacked"],
        "slot ticks (phase 3b, 10 ticks)":
            slots["launches"]["conv1d_stripe_stacked"],
        "placement (phase 3c, 4 lanes: flushes P=8, P=64 and a tick)":
            placed["launches"]["conv1d_stripe_stacked"],
        "control plane (phase 3d)":
            control["launches"]["conv1d_stripe_stacked"]}
    conv_m1 = conv_row("conv1d_stripe", ("conv1d_stripe", 1),
                       "src/repro/kernels/conv1d_stripe.py:62")
    conv_m1["max_abs_err"] = max(conv_m1["max_abs_err"],
                                 *(v["max_abs_err"] for v in mconv.values()))
    conv_m1["launches_by_path"] = {
        "ecg per-member oracle query": launches["conv1d_stripe"],
        "mamba2-2.7b": mamba["launches"]["conv1d_stripe"]}
    conv_m1["mamba_short_conv"] = {
        f"[4,2048,{c}]": {k: v[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "path",
            "device_ms", "host_ms", "library_device_ms", "library_host_ms",
            "direct_ms")}
        for c, v in mconv.items()}
    conv_m1.update({k: conv[("conv1d_stripe", 1)][k] for k in (
        "device_ms", "host_ms", "library_device_ms", "library_host_ms",
        "direct_ms", "calls_by_path")})
    sv, gp = ssd["served"], gmm["prefill"]
    kernels = [
        {"name": "window_gather", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/window_gather.cu",
         "replaces": "src/repro/kernels/window_gather.py:55",
         "launches": launches["window_gather"],
         "max_abs_err": max(v["max_abs_err"] for v in gather.values()),
         "ms": g["ms"], "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
         "bound_by": "bytes", "library_ms": None,
         "launches_by_path": {
             "flush main path (phase 3)": launches["window_gather"],
             "slot ticks (phase 3b, 10 ticks)":
                 slots["launches"]["window_gather"],
             "placement (phase 3c, 4 lanes: flushes P=8, P=64 and a tick)":
                 placed["launches"]["window_gather"],
             "control plane (phase 3d)": control["launches"]["window_gather"]},
         "device_ms": g["device_ms"], "host_ms": g["host_ms"],
         "shape": "ECG ring: [64, 3, 16384], P=64, L=7500",
         "vitals": {k: gather["vitals"][k] for k in (
             "ms", "plain_ms", "bound_ms", "device_ms", "host_ms")}},
        conv_stacked,
        conv_m1,
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:98",
         "launches": qwen["launches"]["flash_attention"],
         "launches_by_path": {
             "qwen3-4b": qwen["launches"]["flash_attention"],
             "smollm-360m": smollm["launches"]["flash_attention"],
             "phi3.5-moe (10 layers)": phi["launches"]["flash_attention"],
             "deepseek-v2-lite-16b": ds["launches"]["flash_attention"]},
         "max_abs_err": max(v["max_abs_err"] for v in flash.values()),
         "ms": fp["ms"], "plain_ms": fp["plain_ms"],
         "bound_ms": fp["bound_ms"], "bound_by": fp["bound_by"],
         "library_ms": fp["library_ms"],
         **{k: fp[k] for k in ("device_ms", "host_ms", "tf32x3_ops_ms",
                               "fp32_ops_ms", "bytes_ms")},
         "shape": "qwen3-4b prefill: B=4 S=T=2048 Hq=32 Hkv=8 D=128 causal",
         **{key: {k: flash[label][k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "device_ms", "host_ms", "tf32x3_ops_ms", "fp32_ops_ms")}
            for key, label in (("mla_prefill", "deepseek MLA prefill"),
                               ("window_512", "qwen3-4b prefill window=512"),
                               ("smollm-360m", "smollm-360m prefill"))}},
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention.py:69",
         "launches": ds["launches"]["decode_attention"],
         "launches_by_path": {
             "deepseek-v2-lite-16b materialized":
                 ds["launches"]["decode_attention"],
             "deepseek-v2-lite-16b absorbed":
                 ds["absorbed_launches"]["decode_attention"],
             "qwen3-4b": qwen["launches"]["decode_attention"],
             "smollm-360m": smollm["launches"]["decode_attention"],
             "phi3.5-moe (10 layers)": phi["launches"]["decode_attention"]},
         "max_abs_err": max(v["max_abs_err"] for v in decode.values()),
         "ms": dm["ms"], "plain_ms": dm["plain_ms"],
         "bound_ms": dm["bound_ms"], "bound_by": dm["bound_by"],
         "library_ms": dm["library_ms"], "device_ms": dm["device_ms"],
         "host_ms": dm["host_ms"], "path": dm["path"], "plan": dm["plan"],
         "shape": "deepseek-v2-lite-16b materialized MLA step: B=4 Hq=Hkv=16 "
                  "D=192 Dv=128, ring 2081 (2065 filled)",
         **{key: {k: decode[label][k] for k in
                  ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                   "device_ms", "host_ms", "path", "plan", "cuda_cores")
                  if k in decode[label]}
            for key, label in (("absorbed", "deepseek MLA decode absorbed"),
                               ("qwen3-4b", "qwen3-4b decode"),
                               ("smollm-360m", "smollm-360m decode"))}},
        {"name": "ssd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd.cu",
         "replaces": "src/repro/kernels/ssd_scan.py:74",
         "launches": mamba["launches"]["ssd"],
         "max_abs_err": max(v["max_abs_err"] for v in ssd.values()),
         "ms": sv["ms"], "plain_ms": sv["plain_ms"],
         "bound_ms": sv["bound_ms"], "bound_by": sv["bound_by"],
         "library_ms": None, "device_ms": sv["device_ms"],
         "host_ms": sv["host_ms"], "tf32x3_ops_ms": sv["tf32x3_ops_ms"],
         "scratch_bytes": sv["scratch_bytes"],
         "shape": "mamba2-2.7b prefill: B=4 S=2048 H=80 P=64 G=1 N=128 "
                  "chunk 128"},
        {"name": "moe_gmm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/moe_gmm.cu",
         "replaces": "src/repro/kernels/moe_gmm.py:48",
         "launches": phi["launches"]["moe_gmm"],
         "max_abs_err": max(v["max_abs_err"] for v in gmm.values()),
         "ms": gp["ms"], "plain_ms": gp["plain_ms"],
         "bound_ms": gp["bound_ms"], "bound_by": gp["bound_by"],
         "library_ms": None,
         "launches_by_path": {
             "phi3.5-moe (10 layers)": phi["launches"]["moe_gmm"],
             "deepseek-v2-lite-16b": ds["launches"]["moe_gmm"],
             "deepseek-v2-lite-16b absorbed decode":
                 ds["absorbed_launches"]["moe_gmm"]},
         "shape": "phi3.5-moe prefill: [16, 1296, 4096], f=6400",
         "path": gp["path"], "tf32x3_ops_ms": gp["tf32x3_ops_ms"],
         "fp32_ops_ms": gp["fp32_ops_ms"],
         **{key: {k: gmm[label][k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "path",
             "occupied_experts", "bytes_ms", "tf32x3_ops_ms", "fp32_ops_ms")}
            for key, label in (("decode", "decode"),
                               ("routed_decode", "routed decode"),
                               ("deepseek_prefill", "deepseek prefill"),
                               ("deepseek_decode", "deepseek decode"),
                               ("deepseek_routed_decode",
                                "deepseek routed decode"))}},
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
