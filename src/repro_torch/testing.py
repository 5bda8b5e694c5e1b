"""The one tolerance the port is held to against the JAX package.

Float compute (convs, GroupNorm, softmax, served scores) agrees within
``rtol = atol = 1e-4``.  Both sides compute in float32, but they sum in
different orders: XLA's CPU conv, PyTorch's CPU conv and the port's
CUDA kernel each order the K x cin_g products their own way, and the
GroupNorm mean and variance are reduced differently.  At full width
(W=128, 16 blocks, 30-s windows) the logits measured within 3.8e-6 of
the reference at a magnitude near 10, so 1e-4 keeps about 25x headroom
while still catching any wrong tap, pad or group (those move values by
O(1)).  No test loosens it.

Ops that only move data (the ring ingest, ``window_gather``, the
lead-gather, refs against packed flushes, the MoE dispatch buffer) must
be bitwise equal: ``assert_bitwise``.

One place reads the same 1e-4 at another scale: a served MoE layer on
the card (``chip_smoke.py`` phase 6).  The reference's init scales an
``[E, d, f]`` expert leaf by its first axis, E = 16, not by d, so the
experts' outputs there are ~1e3 in size, and an elementwise 1e-4 would
test the order in which 6400-term fp32 sums are taken, not the kernel.
There each MoE layer's output, kernel against plain on the same input,
is held to ``max |y_kernel - y_plain| / RMS(y_plain) <= 1e-4``: the
scale at which the next ``rms_norm`` reads it.  And since a relative
difference of ~1e-6 can flip a top-k choice at a near-tie, routing is
compared choice by choice; a flip is accepted only where the two
experts' probabilities differ by less than 1e-5.  Such a flip sends
its token through another expert, so the two runs then differ by O(1)
at that token in later layers and, through causal attention and the
per-sequence capacity, at the later tokens of its sequence: flips
there are downstream, reported and not held to the gap, and the
logits of that sequence are reported instead of asserted (the other
sequences, which share nothing with it, stay held to 1e-4).  The CPU
tests, at reduced width, keep the elementwise rule.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import decode_attention as kdecode
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import ref

RTOL = 1e-4
ATOL = 1e-4


def to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close(got, want, what: str = "") -> None:
    """Float compute: within ``RTOL``/``ATOL``."""
    np.testing.assert_allclose(to_numpy(got).astype(np.float64),
                               to_numpy(want).astype(np.float64),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def assert_bitwise(got, want, what: str = "") -> None:
    """Data movement: identical arrays, shape and dtype included."""
    g, w = to_numpy(got), to_numpy(want)
    assert g.shape == w.shape and g.dtype == w.dtype, \
        (what, g.shape, g.dtype, w.shape, w.dtype)
    assert np.array_equal(g, w), what


# ------------------------------------------------- plain models of kernels
def round_tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 (10 mantissa bits), returned as float32: round to
    nearest with ties away from zero, as ``cvt.rna.tf32.f32`` does (add
    half a TF32 ulp to the magnitude's bits, then drop the 13 low bits;
    inf stays inf, NaN stays NaN)."""
    bits = a.contiguous().view(torch.int32)
    out = torch.bitwise_and(bits + 0x1000, ~0x1FFF).view(torch.float32)
    return torch.where(torch.isnan(a), a, out)


def truncate_tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 by dropping the 13 low bits: what the tensor cores
    read of a float32 operand that is not already TF32."""
    bits = a.contiguous().view(torch.int32)
    return torch.bitwise_and(bits, ~0x1FFF).view(torch.float32)


def matmul_tf32(a: torch.Tensor, b: torch.Tensor,
                passes: int = 3) -> torch.Tensor:
    """``a @ b`` in float32 as the tensor cores take it.  ``passes=1``:
    both operands rounded to TF32 (plain TF32).  ``passes=3`` (3xTF32,
    the split of ``csrc/moe_gmm.cu``): each operand split into
    ``big = round_tf32(v)`` and ``small = v - big``, of which the tensor
    cores read ``truncate_tf32(small)``, and ``small·big + big·small +
    big·big`` summed in float32 (a product of two TF32 values is exact
    in float32)."""
    if passes == 1:
        return round_tf32(a) @ round_tf32(b)
    if passes != 3:
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    a_big, b_big = round_tf32(a), round_tf32(b)
    a_small, b_small = truncate_tf32(a - a_big), truncate_tf32(b - b_big)
    return (a_small @ b_big + a_big @ b_small) + a_big @ b_big


def moe_gmm_tf32(xbuf: torch.Tensor, w_gate: torch.Tensor,
                 w_up: torch.Tensor, w_down: torch.Tensor,
                 passes: int = 3) -> torch.Tensor:
    """``ref.moe_gmm`` with its three products taken by
    ``matmul_tf32``: a plain model of the tensor-core path of the CUDA
    ``moe_gmm`` (the SwiGLU in float32 between them)."""
    gate = matmul_tf32(xbuf, w_gate, passes)
    up = matmul_tf32(xbuf, w_up, passes)
    h = gate / (1 + torch.exp(-gate)) * up
    return matmul_tf32(h, w_down, passes)


def moe_gmm_occupied_rows(xbuf: torch.Tensor, w_gate: torch.Tensor,
                          w_up: torch.Tensor,
                          w_down: torch.Tensor) -> torch.Tensor:
    """A plain model of the streaming path of the CUDA ``moe_gmm``: each
    expert computes only its rows that hold a nonzero value; every other
    row of y is zero, and an expert with no such row reads no weight."""
    y = torch.zeros_like(xbuf)
    for e in range(xbuf.shape[0]):
        rows = (xbuf[e] != 0).any(-1).nonzero()[:, 0]
        if len(rows):
            y[e, rows] = ref.moe_gmm(xbuf[e:e + 1, rows], w_gate[e:e + 1],
                                     w_up[e:e + 1], w_down[e:e + 1])[0]
    return y


def ssd_chunk_parallel(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       B_: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                       chunk: int, h0: Optional[torch.Tensor] = None,
                       passes: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A plain model of the CUDA ``ssd``'s decomposition
    (``csrc/ssd.cu``): (1) every chunk's own end state ``s_c = x^T (wgt *
    B)`` at once, (2) the states passed on in chunk order, ``h_c =
    exp(total_c) h_{c-1} + s_c``, keeping the state that enters each
    chunk, (3) every chunk's output ``W x + exp(seg) C h_{c-1}^T + D x``
    at once, W built on the causal half only.  ``passes`` takes the four
    products by ``matmul_tf32`` (3: the kernel's 3xTF32), else in the
    inputs' own precision.  Same arguments and results as
    ``ref.ssd_chunked``."""
    mm = torch.matmul if passes is None else \
        (lambda a, b: matmul_tf32(a, b, passes))
    b, S, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    nc = -(-S // chunk)
    pad = nc * chunk - S
    x_, dt_ = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
    B_, C = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (B_, C))

    def heads(t):                     # [b, S', H, n] -> [b, H, nc, L, n]
        return t.reshape(b, nc, chunk, H, -1).permute(0, 3, 1, 2, 4)

    xh = heads(x_)
    Bh, Ch = (heads(t.repeat_interleave(H // G, dim=2)) for t in (B_, C))
    dth = dt_.reshape(b, nc, chunk, H).permute(0, 3, 1, 2)   # [b,H,nc,L]
    seg = torch.cumsum(dth * A[None, :, None, None], dim=-1)
    total = seg[..., -1]                                      # [b,H,nc]
    # (1) each chunk's own end state, all chunks at once
    wgt = torch.exp(total[..., None] - seg) * dth
    st = mm(xh.transpose(-1, -2), Bh * wgt[..., None])       # [b,H,nc,P,N]
    # (2) the state entering each chunk, in chunk order
    h = torch.zeros((b, H, P, N), dtype=x.dtype, device=x.device) \
        if h0 is None else h0
    prev = []
    for c in range(nc):
        prev.append(h)
        h = h * torch.exp(total[:, :, c])[:, :, None, None] + st[:, :, c]
    prev = torch.stack(prev, dim=2)                           # [b,H,nc,P,N]
    # (3) each chunk's output, W on its causal half
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=x.device).tril()
    diff = torch.where(causal, seg[..., :, None] - seg[..., None, :],
                       torch.zeros((), dtype=seg.dtype, device=x.device))
    W = torch.where(causal, mm(Ch, Bh.transpose(-1, -2)) * torch.exp(diff)
                    * dth[..., None, :],
                    torch.zeros((), dtype=x.dtype, device=x.device))
    y = (mm(W, xh) + mm(Ch, prev.transpose(-1, -2))
         * torch.exp(seg)[..., None]) + xh * D[None, :, None, None, None]
    y = y.permute(0, 2, 3, 1, 4).reshape(b, nc * chunk, H, P)
    return y[:, :S], h


def _tile_live(kp: torch.Tensor, lo: int, hi: int, causal: bool,
               window: int) -> bool:
    """The CUDA ``flash_attention``'s test of a key tile against a range
    of query positions ``[lo, hi]`` (``lo > hi``: no query): some key
    valid, its least valid position at most ``hi`` if causal, its
    greatest more than ``window`` behind ``lo`` if windowed."""
    ok = kp[kp >= 0]
    if lo > hi or ok.numel() == 0:
        return False
    live = True
    if causal:
        live = live and int(ok.min()) <= hi
    if window:
        live = live and int(ok.max()) > lo - window
    return live


def flash_stages(D: int) -> List[Tuple[int, int]]:
    """The CUDA ``flash_attention``'s stages of Q K^T over D, as ``(first
    column, width)``: 32 columns each (4 k8 steps, ``Cfg::STG``), or all
    of D below 32, and a short last stage of what is left where 32 does
    not divide D (``Cfg::TAIL``; zamba2's D = 112 is 32, 32, 32, 16)."""
    stage = min(D, 32)
    return [(d0, min(stage, D - d0)) for d0 in range(0, D, stage)]


def flash_attention_tiles(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, qpos: torch.Tensor,
                          kpos: torch.Tensor, *, causal: bool = True,
                          window: int = 0, scale: Optional[float] = None,
                          passes: Optional[int] = 3) -> torch.Tensor:
    """A plain model of the CUDA ``flash_attention``'s order of work
    (``csrc/flash_attention.cu``): blocks of 128 query rows, warps of 16;
    key tiles of 64 keys (32 at D > 128, 16 at D > 192;
    ``kflash.tile_plan``) visited in order, a tile
    skipped unless it is live for the block's and for the warp's query
    positions (``_tile_live``), K/V rows past T read as zeros with ``kpos
    = -1``; in each tile S = Q K^T summed by the kernel's stages of D
    (``flash_stages``: 32 each, the last one short where 32 does not
    divide D), each stage a product of its own added in float32, then
    multiplied by
    ``scale * log2 e`` and masked to -1e30;
    the online softmax in base 2; P V one product a tile, added as ``o =
    o * alpha + part``.  ``passes`` takes the products by ``matmul_tf32``
    (3: the kernel's 3xTF32), else (None) in the inputs' precision.  Same
    arguments and result as ``ref.attention``."""
    mm = torch.matmul if passes is None else \
        (lambda a, b: matmul_tf32(a, b, passes))
    B, S, Hq, D = q.shape
    T, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    g = Hq // Hkv
    plan = kflash.tile_plan(D, Dv)
    block_q, warp_rows, bk = plan["bq"], 16, plan["bk"]
    c = (D ** -0.5 if scale is None else scale) * math.log2(math.e)
    n_tiles = -(-T // bk)
    pad = n_tiles * bk - T
    kh = F.pad(k, (0, 0, 0, 0, 0, pad)).permute(0, 2, 1, 3)   # [B,Hkv,T',D]
    vh = F.pad(v, (0, 0, 0, 0, 0, pad)).permute(0, 2, 1, 3)
    kp = F.pad(kpos.to(torch.int64), (0, pad), value=-1)
    qp = qpos.to(torch.int64)
    qg = q.reshape(B, S, Hkv, g, D).permute(0, 2, 3, 1, 4)    # [B,Hkv,g,S,D]
    vis = ref.visible(qp, kp, causal, window).expand(S, -1)   # [S, T']
    out = torch.zeros((B, Hkv, g, S, Dv), dtype=q.dtype, device=q.device)
    for s0 in range(0, S, block_q):
        b_rows = qp[s0:min(S, s0 + block_q)]
        b_lo, b_hi = int(b_rows.min()), int(b_rows.max())
        for r0 in range(s0, min(S, s0 + block_q), warp_rows):
            rows = slice(r0, min(S, r0 + warp_rows))
            w_lo, w_hi = int(qp[rows].min()), int(qp[rows].max())
            qs = qg[:, :, :, rows]
            n = qs.shape[3]
            m = torch.full((B, Hkv, g, n), ref.NEG_INF, dtype=q.dtype)
            l = torch.zeros((B, Hkv, g, n), dtype=q.dtype)
            o = torch.zeros((B, Hkv, g, n, Dv), dtype=q.dtype)
            for j in range(n_tiles):
                keys = slice(j * bk, (j + 1) * bk)
                if not (_tile_live(kp[keys], b_lo, b_hi, causal, window)
                        and _tile_live(kp[keys], w_lo, w_hi, causal,
                                       window)):
                    continue
                kt = kh[:, :, None, keys]                     # [B,Hkv,1,bk,D]
                sc = sum(mm(qs[..., d0:d0 + w],
                            kt[..., d0:d0 + w].transpose(-1, -2))
                         for d0, w in flash_stages(D))
                sc = torch.where(vis[rows, keys], sc * c,
                                 torch.full_like(sc, ref.NEG_INF))
                m_new = torch.maximum(m, sc.amax(-1))
                p = torch.exp2(sc - m_new[..., None])
                alpha = torch.exp2(m - m_new)
                l = l * alpha + p.sum(-1)
                o = o * alpha[..., None] + mm(p, vh[:, :, None, keys])
                m = m_new
            out[:, :, :, rows] = o / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, Dv)


def gather_plan(P: int, C: int, L: int, cap: int) -> dict:
    """The CUDA ``window_gather``'s launch (``csrc/window_gather.cu``):
    ``vec`` (a float4 of output a thread, when ``L % 4 == 0``), threads
    a block (256, or the row's units rounded up to a warp), chunks of a
    (row, channel), blocks, and ``wrap`` (``L > cap``: the exact modulo
    per element instead of one subtraction)."""
    vec = L % 4 == 0
    units = L // 4 if vec else L
    threads = 256 if units >= 256 else -(-units // 32) * 32
    chunks = -(-units // threads)
    return {"vec": vec, "threads": threads, "chunks": chunks,
            "blocks": P * C * chunks, "wrap": L > cap,
            "per_block": (4 if vec else 1) * threads}


def window_gather_runs(buf: torch.Tensor, patients: torch.Tensor,
                       ends: torch.Tensor, valid: torch.Tensor,
                       L: int) -> torch.Tensor:
    """A plain model of the CUDA ``window_gather``'s plan
    (``gather_plan``): each (row, channel) cut into chunks of
    ``per_block`` outputs; a chunk's first ring position reduced mod
    ``cap`` once (floor-mod, in 64 bits); inside the chunk, when ``L <=
    cap``, the wrap is one subtraction (checked: it always lands in
    ``[0, cap)``), else the exact modulo; outputs before ``L - valid``
    zero without a read.  Same arguments and result as
    ``ref.window_gather``."""
    P, C, cap = patients.shape[0], buf.shape[1], buf.shape[2]
    plan = gather_plan(P, C, L, cap)
    out = torch.zeros((P, C, L), dtype=buf.dtype, device=buf.device)
    ends64, pts = ends.to(torch.int64), patients.to(torch.int64)
    zero_before = (L - valid.to(torch.int64))[:, None]
    chan = torch.arange(C, device=buf.device)[None, :, None]
    for ch in range(plan["chunks"]):
        j0 = ch * plan["per_block"]
        jj = torch.arange(j0, min(L, j0 + plan["per_block"]),
                          device=buf.device)
        first = torch.remainder(ends64 - L + j0, cap)[:, None]   # [P, 1]
        pos = first + (jj - j0)[None, :]
        if plan["wrap"]:
            pos = torch.remainder(pos, cap)
        else:
            pos = torch.where(pos >= cap, pos - cap, pos)
            assert bool(((pos >= 0) & (pos < cap)).all()), "two wraps"
        keep = jj[None, :] >= zero_before                         # [P, n]
        vals = buf[pts[:, None, None], chan,
                   torch.where(keep, pos, 0)[:, None, :]]
        out[:, :, j0:j0 + len(jj)] = torch.where(
            keep[:, None, :], vals, torch.zeros((), dtype=buf.dtype))
    return out


def decode_score_parts(D: int, path: str) -> List[Tuple[int, int]]:
    """The column ranges of D whose partial ``q . k`` the CUDA
    ``decode_attention`` sums, in this order: on the CUDA cores one
    range a warp (8 warps, whole float4s), on the tensor cores the two
    halves of D's k8 steps."""
    if path == "tensor_cores":
        mid = 8 * -(-(D // 8) // 2)
        return [(0, mid), (mid, D)]
    per = 4 * -(-(D // 4) // 8)
    return [(d, min(D, d + per)) for d in range(0, D, per)]


def decode_pv_groups(Dv: int, path: str) -> int:
    """The key groups over which the CUDA ``decode_attention`` spreads a
    tile's P @ V (each group's sums kept apart over the piece and added
    in group order at its end): the wrapper's ``pv_groups`` on the CUDA
    cores; one on the tensor cores (the mma sums all 32 keys)."""
    return 1 if path == "tensor_cores" else kdecode.pv_groups(Dv)


# (label, B, Hkv, g, T, D, Dv, v_in_k, path, pieces, (slots, blocks an
# SM)): the served decode steps (B = 4; a 2081-slot ring, smollm's 97,
# seamless's cross step over 1024 frames; the published Zamba2's 8
# sessions over a 4096-slot ring, two waves of one block an SM), as the
# kernel's layout (the C plan) gives them on 132 SMs
SERVED_DECODE_PLANS = [
    ("deepseek absorbed", 4, 1, 16, 2081, 576, 512, True, "tensor_cores",
     33, (2, 1)),
    ("deepseek materialized", 4, 16, 1, 2081, 192, 128, False,
     "cuda_cores", 4, (2, 2)),
    ("qwen3-4b", 4, 8, 4, 2081, 128, 128, False, "cuda_cores", 8, (3, 2)),
    ("smollm-360m", 4, 5, 3, 97, 64, 64, False, "cuda_cores", 1, (4, 2)),
    ("zamba2-7b", 4, 32, 1, 2081, 112, 112, False, "cuda_cores", 2,
     (3, 2)),
    ("zamba2-7b-instruct", 8, 32, 1, 4096, 224, 224, False, "cuda_cores",
     1, (3, 1)),
    ("seamless cross", 4, 16, 1, 1024, 64, 64, False, "cuda_cores", 4,
     (6, 2)),
]


def decode_attention_pieces(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, kpos: torch.Tensor,
                            qpos: torch.Tensor, *, ts: int,
                            path: str = "cuda_cores", window: int = 0,
                            scale: Optional[float] = None,
                            causal: bool = True,
                            tile: int = 32) -> torch.Tensor:
    """A plain model of the CUDA ``decode_attention``'s order of work
    (``csrc/decode_attention.cu``): T cut into pieces of ``ts`` keys;
    in each piece an online softmax in base 2 over tiles of ``tile``
    keys (tiles with no visible key skipped), a tile's scores summed
    from the partial products over ``decode_score_parts`` in order, its
    P @ V kept apart by key group (``decode_pv_groups``) and the groups
    added in order at the end of the piece; the pieces' ``(m, l, acc)``
    merged in piece order with ``w_i = exp2(m_i - max m)``.  A row that
    sees no key gives zeros, as the kernel's.  Same arguments as
    ``ref.decode_attention`` (qpos a ``[1]`` tensor) and ``causal``."""
    B, Hq, D = q.shape
    T, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    g = Hq // Hkv
    scale = D ** -0.5 if scale is None else scale
    qs = (q * (scale * math.log2(math.e))).reshape(B, Hkv, g, D)
    vis = ref.visible(qpos.reshape(1), kpos, causal, window)[0]     # [T]
    parts = decode_score_parts(D, path)
    groups = decode_pv_groups(Dv, path)
    per = tile // groups
    pieces = []
    for t_begin in range(0, T, ts):
        t_end = min(T, t_begin + ts)
        m = torch.full((B, Hkv, g), ref.NEG_INF, dtype=q.dtype)
        l = torch.zeros((B, Hkv, g), dtype=q.dtype)
        acc = torch.zeros((groups, B, Hkv, g, Dv), dtype=q.dtype)
        for t0 in range(t_begin, t_end, tile):
            keys = slice(t0, min(t_end, t0 + tile))
            if not bool(vis[keys].any()):
                continue
            s = sum(torch.einsum("bkgd,btkd->bkgt", qs[..., d0:d1],
                                 k[:, keys, :, d0:d1]) for d0, d1 in parts)
            s = torch.where(vis[keys], s, torch.full_like(s, ref.NEG_INF))
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp2(s - m_new[..., None])
            alpha = torch.exp2(m - m_new)
            l = l * alpha + p.sum(-1)
            vt = F.pad(v[:, keys], (0, 0, 0, 0, 0, tile - p.shape[-1]))
            p = F.pad(p, (0, tile - p.shape[-1]))
            acc = acc * alpha[..., None] + torch.stack([torch.einsum(
                "bkgt,btkd->bkgd", p[..., i * per:(i + 1) * per],
                vt[:, i * per:(i + 1) * per]) for i in range(groups)])
            m = m_new
        pieces.append((m, l, sum(acc[i] for i in range(groups))))
    mx = torch.stack([pc[0] for pc in pieces]).amax(0)
    w = [torch.exp2(pc[0] - mx) for pc in pieces]
    num = sum(wi[..., None] * pc[2] for wi, pc in zip(w, pieces))
    den = sum(wi * pc[1] for wi, pc in zip(w, pieces))
    return (num / torch.clamp(den, min=1e-30)[..., None]).reshape(B, Hq, Dv)
