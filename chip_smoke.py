#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (or
another sm_90a card), ``nvcc`` and PyTorch built for CUDA.  It imports
nothing of JAX or of the JAX package (``src/repro``).  Phases:

1. environment: versions, the card's name and power limit, the build of
   every CUDA kernel from ``src/repro_torch/kernels/csrc``;
2. each kernel against its plain PyTorch version at the paths' shapes
   (``window_gather`` bitwise; both conv entry points and
   ``flash_attention`` within rtol = atol = 1e-4 with TF32 off), with
   its time, the plain version's time, the time of one library call
   where one computes the same function, and the least time the card
   could take (bound);
3. the ECG main path at full width: the 60-member full zoo (30-s
   windows) behind ``StreamingPipeline(device_ingest=True)`` and an
   ``EnsembleServer`` over ``DeviceWindowRef``s, with the launch
   counters reset just before and read just after; then the flush
   latency at P=8 and P=64 and checks against the plain versions;
4. the dense-LM serving path through ``repro_torch.launch.serve``:
   qwen3-4b at full width and depth (36 layers; batch 4, prompt 2048,
   32 new tokens), counters reset just before and read just after
   (36 x 33 ``flash_attention`` launches), prefill logits against the
   plain versions and cached decode against the teacher-forced forward;
   then smollm-360m at the launcher's defaults;
5. a ``kernels`` JSON line, and the last line
   ``{"ok": true, "device": {...}}``.

``--profile`` adds one traced flush at P=8 and at P=64 after phase 3
and one traced qwen3-4b prefill and decode step in phase 4
(``torch.profiler``): device time by kernel and the card's idle share.

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


def _attn_cases(np):
    """The LM path's attention calls at full width, as
    ``(label, B, Hq, Hkv, D, window, qpos, kpos)``: qwen3-4b's prefill
    (B=4, 2048 tokens, causal) and a decode step mid-generation (the
    2081-slot ring, 2065 slots filled, ``kpos = -1`` tail); a 512-token
    window over the same prefill and over the ring ``fit_kv_cache``
    builds for a 2080-token prompt (rolled by 2080 % 512, then the step's
    own slot written); smollm-360m's prefill and a decode step at the
    launcher's defaults (D=64, g=3)."""
    ar = np.arange
    ring = np.where(ar(2081) < 2065, ar(2081), -1)
    win = np.roll(ar(2080 - 512, 2080), 2080 % 512)
    win[2080 % 512] = 2080
    small = np.where(ar(97) < 81, ar(97), -1)
    return [
        ("qwen3-4b prefill", 4, 32, 8, 128, 0, ar(2048), ar(2048)),
        ("qwen3-4b decode", 4, 32, 8, 128, 0, np.array([2064]), ring),
        ("qwen3-4b prefill window=512", 4, 32, 8, 128, 512, ar(2048),
         ar(2048)),
        ("qwen3-4b decode window=512 ring", 4, 32, 8, 128, 512,
         np.array([2080]), win),
        ("smollm-360m prefill", 4, 15, 5, 64, 0, ar(64), ar(64)),
        ("smollm-360m decode", 4, 15, 5, 64, 0, np.array([80]), small),
    ]


def phase_flash(torch, np, F, record):
    """``flash_attention`` against the plain version (TF32 off) at the
    LM path's shapes, with its time, the plain version's, one
    ``F.scaled_dot_product_attention`` call's (same boolean mask, fp32,
    ``enable_gqa``) and the bound: 4*D FLOPs per visible (q, k) pair and
    head against the bytes of q, o and every K/V row some query sees."""
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ref

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {}
    for label, B, Hq, Hkv, D, window, qp_np, kp_np in _attn_cases(np):
        S, T = len(qp_np), len(kp_np)
        q = torch.randn((B, S, Hq, D), device=dev, generator=gen)
        k = torch.randn((B, T, Hkv, D), device=dev, generator=gen)
        v = torch.randn((B, T, Hkv, D), device=dev, generator=gen)
        qp = torch.from_numpy(qp_np.astype(np.int32)).to(dev)
        kp = torch.from_numpy(kp_np.astype(np.int32)).to(dev)
        run = lambda: kflash.flash_attention(q, k, v, qp, kp, causal=True,
                                             window=window)
        plain = lambda: ref.attention(q, k, v, qp, kp, causal=True,
                                      window=window)
        y, r = run(), plain()
        torch.cuda.synchronize()
        err = float((y - r).abs().max())
        if not torch.allclose(y, r, rtol=TOL, atol=TOL):
            raise AssertionError(f"flash_attention {label}: max abs err "
                                 f"{err} beyond rtol=atol={TOL}")
        vis = ref.visible(qp, kp, True, window)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=vis, enable_gqa=True)
        lib_err = float((lib().transpose(1, 2) - r).abs().max())
        pairs = int(vis.sum())
        live_rows = int(vis.any(0).sum())
        flops = 4.0 * D * pairs * B * Hq
        nbytes = 4.0 * (2 * B * S * Hq * D + 2 * B * live_rows * Hkv * D
                        + S + T)
        bs, os_ = nbytes / HBM_BYTES_S, flops / FP32_FLOP_S
        reps = 5 if S > 1 else 20
        rec = {"B": B, "S": S, "T": T, "Hq": Hq, "Hkv": Hkv, "D": D,
               "window": window, "visible_pairs": pairs,
               "ms": _time_ms(torch, run, reps),
               "plain_ms": _time_ms(torch, plain, reps),
               "library_ms": _time_ms(torch, lib, reps),
               "bound_ms": 1e3 * max(bs, os_),
               "bound_by": "operations" if os_ >= bs else "bytes",
               "max_abs_err": err, "library_max_abs_err": lib_err}
        print(f"  flash_attention {label:31s} B={B} S={S} T={T} "
              f"Hq={Hq} Hkv={Hkv} D={D}: max abs err {err:.3g}; kernel "
              f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, SDPA "
              f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']})", flush=True)
        out[label] = rec
        del q, k, v, y, r, qt, kt, vt, vis
    record["flash_attention"] = out
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


def phase_llm_profile(torch, r, max_len):
    """Device time by kernel class over one traced prefill and one traced
    decode step of the served model, and the card's idle share of the
    untraced prefill and mean decode step."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer

    cfg, rt = r["cfg"], r["rt"]
    out = {}
    walls = {"prefill": 1e3 * r["prefill_s"],
             "decode": r["decode_ms_per_token"]}
    for what in ("prefill", "decode"):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if what == "prefill":
                _, cache = transformer.prefill(r["params"], r["tokens"], cfg,
                                               rt, max_len=max_len)
            else:                                   # the first step again
                transformer.decode_step(r["params"], cache,
                                        r["generated"][:, 0], cfg, rt)
            torch.cuda.synchronize()
        by = _device_ms_by_kernel(torch, prof)
        wall = walls[what]
        cls = {"flash_attention": 0.0, "gemm": 0.0, "other": 0.0}
        for name, (ms, _) in by.items():
            key = ("flash_attention" if "flash" in name else
                   "gemm" if "gemm" in name.lower() or "gemv" in
                   name.lower() else "other")
            cls[key] += ms
        busy = sum(cls.values())
        out[what] = {"wall_ms": wall, "device_busy_ms": busy,
                     "idle_share": 1 - busy / wall, "by_class_ms": cls,
                     "ops": sum(n for _, n in by.values()),
                     "top": sorted(((k, ms, n) for k, (ms, n) in by.items()),
                                   key=lambda t: -t[1])[:8]}
        print(f"  profile {cfg.name} {what}: device busy {busy:.2f} ms of "
              f"{wall:.2f} ms (untraced) -> idle share "
              f"{1 - busy / wall:.3f}; flash_attention "
              f"{cls['flash_attention']:.2f} ms, GEMM {cls['gemm']:.2f} ms, "
              f"other {cls['other']:.2f} ms; {out[what]['ops']} device ops",
              flush=True)
        for name, ms, n in out[what]["top"]:
            print(f"    {ms:9.3f} ms  x{n:5d}  {name[:90]}", flush=True)
    del cache
    return out


def phase_llm(torch, np, record, card, argv, counters, profile=False):
    """The dense-LM serving path through its launcher
    (``repro_torch.launch.serve``): prefill, then a greedy decode loop,
    with every launch counter at 0 just before and read just after; then
    the prefill logits against the plain versions (1e-4) and the first
    two decode steps against the teacher-forced forward on the same
    tokens (2e-3, the reference's own bound)."""
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    from repro_torch.models.runtime import RuntimeOptions

    args = serve.parse_args(argv)
    for c in counters:
        c.reset()
    r = serve.run(args)
    launches = {c.name: c.value for c in counters}
    cfg, B, S = r["cfg"], args.batch, args.prompt_len
    want = cfg.num_layers * (1 + args.new_tokens)
    print(f"  {args.arch}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, head_dim {cfg.head_dim}, "
          f"vocab {cfg.vocab_size}; batch {B}, prompt {S}, "
          f"{args.new_tokens} new tokens; launches {launches}", flush=True)
    if launches["flash_attention"] != want or \
            sum(launches.values()) != want:
        raise AssertionError(f"{args.arch}: launches {launches}, want "
                             f"{want} flash_attention and nothing else")
    gen = r["generated"]
    if tuple(gen.shape) != (B, args.new_tokens + 1) or int(gen.min()) < 0 \
            or int(gen.max()) >= cfg.padded_vocab:
        raise AssertionError(f"{args.arch}: generated {tuple(gen.shape)}")
    logits = r["prefill_logits"]
    if tuple(logits.shape) != (B, cfg.padded_vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{args.arch}: prefill logits "
                             f"{tuple(logits.shape)} not finite")
    max_len = S + args.new_tokens + 1
    before = kflash.launches.value
    plain, _ = transformer.prefill(r["params"], r["tokens"], cfg,
                                   RuntimeOptions(impl="torch"),
                                   max_len=max_len)
    if kflash.launches.value != before:
        raise AssertionError("the plain prefill launched the kernel")
    plain_err = float((logits - plain).abs().max())
    if not torch.allclose(logits, plain, rtol=TOL, atol=TOL):
        raise AssertionError(f"{args.arch}: prefill logits, kernel vs "
                             f"plain: max abs err {plain_err}")
    del plain
    full, _ = transformer.forward(
        r["params"], torch.cat([r["tokens"], gen[:, :2]], dim=1), cfg,
        r["rt"])
    tf_err = 0.0
    for got, at in ((logits, S - 1), (r["step_logits"][0], S),
                    (r["step_logits"][1], S + 1)):
        tf_err = max(tf_err, float((got - full[:, at]).abs().max()))
        if not torch.allclose(got, full[:, at], rtol=2e-3, atol=2e-3):
            raise AssertionError(f"{args.arch}: cached logits at position "
                                 f"{at} vs teacher-forced forward: max abs "
                                 f"err {tf_err}")
    del full
    # one more step of the served cache: the decode path never stalls
    # the host on the card (a sync would serialise launch and compute)
    torch.cuda.set_sync_debug_mode("error")
    transformer.decode_step(r["params"], r["cache"], gen[:, -1], cfg,
                            r["rt"])
    torch.cuda.set_sync_debug_mode(0)
    if profile:
        rec_prof = phase_llm_profile(torch, r, max_len)
    rec = {"arch": args.arch, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "batch": B, "prompt_len": S,
           "new_tokens": args.new_tokens, "launches": launches,
           "init_s": r["init_s"], "prefill_s": r["prefill_s"],
           "decode_ms_per_token": r["decode_ms_per_token"],
           "decode_tok_per_s": r["decode_tok_per_s"],
           "peak_mem_gib": r["peak_mem_gib"],
           "prefill_vs_plain_max_abs_err": plain_err,
           "decode_vs_forward_max_abs_err": tf_err,
           "generated_0_16": gen[0, :16].tolist(), "card": card}
    if profile:
        rec["profile"] = rec_prof
    print(f"  {args.arch} on {card}: prefill {rec['prefill_s']:.4f} s, "
          f"decode {rec['decode_ms_per_token']:.3f} ms/token "
          f"({rec['decode_tok_per_s']:.1f} tok/s), peak memory "
          f"{rec['peak_mem_gib']:.3f} GiB, init {rec['init_s']:.2f} s; "
          f"prefill logits vs plain max abs err {plain_err:.3g}, cached "
          f"vs teacher-forced {tf_err:.3g}", flush=True)
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
    flash = phase_flash(torch, np, F, record)

    print("phase 3: main path (full zoo)", flush=True)
    launches, conv_per_flush = phase_main(torch, np, specs, record, card,
                                          profile="--profile" in sys.argv)
    if conv_per_flush != conv[("conv1d_stripe_stacked", 64)]["calls"]:
        raise AssertionError(
            f"a flush launched {conv_per_flush} convs, the shape table "
            f"counts {conv[('conv1d_stripe_stacked', 64)]['calls']}")
    phase_small_reference(torch, np)

    print("phase 4: dense-LM serving path (qwen3-4b, full width and "
          "depth; smollm-360m)", flush=True)
    from repro_torch.kernels import conv1d_stripe as kconv
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import window_gather as kgather
    counters = (kgather.launches, kconv.launches_stacked, kconv.launches,
                kflash.launches)
    qwen = phase_llm(torch, np, record, card,
                     ["--arch", "qwen3-4b", "--batch", "4", "--prompt-len",
                      "2048", "--new-tokens", "32", "--seed", str(SEED)],
                     counters, profile="--profile" in sys.argv)
    if (qwen["layers"], qwen["d_model"]) != (36, 2560):
        raise AssertionError(f"qwen3-4b served at {qwen}")
    phase_llm(torch, np, record, card, ["--arch", "smollm-360m"], counters)
    fp, fd = flash["qwen3-4b prefill"], flash["qwen3-4b decode"]
    share = {"prefill": 36 * fp["ms"] / (1e3 * qwen["prefill_s"]),
             "decode": 36 * fd["ms"] / qwen["decode_ms_per_token"]}
    record["llm_attention_share"] = share
    print(f"  qwen3-4b attention share (36 x kernel ms at the phase-2 "
          f"shapes over the served time): prefill {share['prefill']:.3f}, "
          f"decode step {share['decode']:.3f}", flush=True)

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
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:98",
         "launches": qwen["launches"]["flash_attention"],
         "max_abs_err": max(v["max_abs_err"] for v in flash.values()),
         "ms": fp["ms"], "plain_ms": fp["plain_ms"],
         "bound_ms": fp["bound_ms"], "bound_by": fp["bound_by"],
         "library_ms": fp["library_ms"],
         "shape": "qwen3-4b prefill: B=4 S=T=2048 Hq=32 Hkv=8 D=128 causal"},
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
