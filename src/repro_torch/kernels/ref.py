"""Plain PyTorch versions of the ported kernels (window gather, conv,
attention, SSD scan, MoE grouped SwiGLU), and the attention and SSD
decode oracles (``repro/kernels/ref.py``).

They are the port's own reference, playing the part ``repro.kernels.ref``
plays in the JAX package: the CPU path runs them, the tests hold them
against the JAX oracles, and ``chip_smoke.py`` holds each CUDA kernel
against them on the card.  Nothing on the serving path calls them for a
CUDA tensor unless the caller forces ``impl="torch"``.

On the card, a float32 ``F.conv1d`` goes through cuDNN in TF32 unless
``torch.backends.cudnn.allow_tf32`` is False; whoever compares against
this conv on a GPU must turn TF32 off first (``chip_smoke.py`` does).
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

# masked scores are -1e30, not -inf: the online softmax relies on
# exp(-1e30 - -1e30) = 1 being wiped by a later alpha = exp(-1e30 - m) = 0
# (with -inf a fully masked tile gives NaN)
NEG_INF = -1e30


def conv_padding(L: int, K: int, stride: int,
                 padding: str) -> Tuple[int, int, int]:
    """``(lo, hi, L_out)`` of a 1-D conv.  SAME follows the lax
    convention (``L_out = ceil(L / stride)``, ``lo = pad_total // 2``),
    which is asymmetric for every stride-2 K=7 conv on an even length;
    CAUSAL pads ``K - 1`` on the left."""
    L_out = -(-L // stride)
    if padding == "CAUSAL":
        return K - 1, 0, L_out
    if padding != "SAME":
        raise ValueError(f"padding must be 'SAME' or 'CAUSAL', got "
                         f"{padding!r}")
    pad_total = max((L_out - 1) * stride + K - L, 0)
    lo = pad_total // 2
    return lo, pad_total - lo, L_out


def window_gather(buf: torch.Tensor, patients: torch.Tensor,
                  ends: torch.Tensor, valid: torch.Tensor,
                  L: int) -> torch.Tensor:
    """Ring-buffer window gather (``repro.kernels.ref.window_gather``).

    ``buf`` is ``[N, C, cap]``; row ``i`` of the result holds the last
    ``L`` samples ending (exclusive) at ring position ``ends[i]`` of
    patient ``patients[i]``, oldest first, zeroed where
    ``j < L - valid[i]``.  Returns ``[P, C, L]``."""
    cap = buf.shape[-1]
    j = torch.arange(L, device=buf.device)
    pos = torch.remainder(ends.long()[:, None] - L + j[None, :], cap)
    win = buf[patients.long()[:, None, None],
              torch.arange(buf.shape[1], device=buf.device)[None, :, None],
              pos[:, None, :]]                                # [P, C, L]
    keep = j[None, None, :] >= (L - valid.long())[:, None, None]
    return torch.where(keep, win, torch.zeros((), dtype=buf.dtype,
                                              device=buf.device))


def conv1d_stripe(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor] = None, stride: int = 1,
                  groups: int = 1, padding: str = "SAME") -> torch.Tensor:
    """Grouped 1-D conv, channels last (``repro.kernels.ref
    .conv1d_stripe``).  x: ``[B, L, Cin]``; w: ``[K, Cin // groups,
    Cout]``; b: ``[Cout]``.  Returns ``[B, L_out, Cout]``."""
    K = w.shape[0]
    lo, hi, _ = conv_padding(x.shape[1], K, stride, padding)
    xc = F.pad(x.transpose(1, 2), (lo, hi))                   # [B, Cin, Lp]
    y = F.conv1d(xc, w.permute(2, 1, 0), stride=stride, groups=groups)
    y = y.transpose(1, 2)
    return y if b is None else y + b


def conv1d_stripe_stacked(x: torch.Tensor, w: torch.Tensor,
                          b: Optional[torch.Tensor] = None,
                          stride: int = 1, groups: int = 1,
                          padding: str = "SAME") -> torch.Tensor:
    """Member-stacked conv: the vmapped oracle of ``repro.kernels.ops``
    (``ops.py:84-87``) written as a loop over the member axis.
    x: ``[M, B, L, Cin]``; w: ``[M, K, Cin // groups, Cout]``;
    b: ``[M, Cout]``.  Returns ``[M, B, L_out, Cout]``."""
    y = torch.stack([conv1d_stripe(x[m], w[m], None, stride, groups,
                                   padding) for m in range(x.shape[0])])
    return y if b is None else y + b[:, None, None, :]


# ------------------------------------------------------------- attention
def visible(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
            window: int) -> torch.Tensor:
    """``[S, T]`` bool: key ``t`` is visible to query ``s`` when
    ``kpos >= 0``, and ``kpos <= qpos`` if causal, and ``qpos - kpos <
    window`` if a window is set."""
    qp = qpos[:, None].to(torch.int32)
    kp = kpos[None, :].to(torch.int32)
    ok = kp >= 0
    if causal:
        ok = ok & (kp <= qp)
    if window:
        ok = ok & ((qp - kp) < window)
    return ok


def _mask_bias(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
               window: int) -> torch.Tensor:
    """Additive ``[S, T]`` float32 bias: 0 where visible, ``NEG_INF``
    elsewhere."""
    zero = torch.zeros((), dtype=torch.float32, device=qpos.device)
    return torch.where(visible(qpos, kpos, causal, window), zero,
                       torch.full_like(zero, NEG_INF))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              qpos: torch.Tensor, kpos: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              scale: Optional[float] = None) -> torch.Tensor:
    """Grouped-query attention oracle (``repro.kernels.ref.attention``).

    q: ``[B, S, Hq, D]``; k: ``[B, T, Hkv, D]``; v: ``[B, T, Hkv, Dv]``
    (``Dv`` may differ from ``D``); ``Hkv`` divides ``Hq`` and query head
    ``h`` reads KV head ``h // g``.  qpos ``[S]``, kpos ``[T]`` absolute
    positions (-1 marks an empty cache slot).  A row with no visible key
    gets the uniform mean of ``v`` over all ``T`` (every bias is
    ``NEG_INF``).  Returns ``[B, S, Hq, Dv]``."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    Dv = v.shape[3]
    g = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, S, Hkv, g, D)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k).float()
    logits = logits * scale + _mask_bias(qpos, kpos, causal, window)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(B, S, Hq, Dv)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kpos: torch.Tensor, qpos: Union[int, torch.Tensor], *,
                     window: int = 0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode oracle (``repro.kernels.ref.decode_attention``,
    with the Pallas function's ``scale``).  q: ``[B, Hq, D]``; k:
    ``[B, T, Hkv, D]``; v: ``[B, T, Hkv, Dv]`` (``Dv`` may differ from
    ``D``, as in MLA); kpos ``[T]``; qpos the query token's position (a
    scalar or a one-element tensor); ``scale`` defaults to ``D ** -0.5``.
    A row with no visible key gets the mean of ``v`` (``attention``).
    Returns ``[B, Hq, Dv]``."""
    qp = torch.as_tensor(qpos, dtype=torch.int32, device=q.device)
    out = attention(q[:, None], k, v, qp.reshape(1), kpos, causal=True,
                    window=window, scale=scale)
    return out[:, 0]


def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      qpos: torch.Tensor, kpos: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      scale: Optional[float] = None,
                      chunk: int = 512) -> torch.Tensor:
    """Online-softmax attention over KV chunks of ``chunk`` keys
    (``repro.kernels.ref.attention_chunked``): the flash-attention
    schedule in plain tensor ops, never holding the ``[S, T]`` scores.
    The tail chunk is padded with empty slots (``kpos = -1``).  A row
    with no visible key gets the mean of ``v`` over every chunk."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    Dv = v.shape[3]
    g = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    pad = (-T) % chunk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kpos = F.pad(kpos.to(torch.int32), (0, pad), value=-1)
    qg = q.reshape(B, S, Hkv, g, D)
    m = torch.full((B, Hkv, g, S), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Hkv, g, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, g, S, Dv), dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, k.shape[1], chunk):
        kb, vb = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        s = torch.einsum("bskgd,btkd->bkgst", qg, kb).float() * scale
        s = s.masked_fill(~visible(qpos, kpos[c0:c0 + chunk], causal,
                                   window), NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgst,btkd->bkgsd", p.to(vb.dtype), vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, Dv).to(q.dtype)


# ------------------------------------------------------------------ SSD
def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B_: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                chunk: int, h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 SSD chunked scan (``repro.kernels.ref.ssd_chunked``).

    x ``[B, S, H, P]``; dt ``[B, S, H]`` (softplus-ed, > 0); A ``[H]``
    (< 0); B_, C ``[B, S, G, N]`` (group ``h // (H // G)`` feeds head
    h); D ``[H]``; h0 ``[B, H, P, N]`` or None.  A ragged S is padded
    with ``dt = 0`` steps, which leave the state unchanged, so ``hT`` is
    the state after step S.  Returns (y ``[B, S, H, P]``, hT ``[B, H, P,
    N]`` float32)."""
    b, S, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    S0 = S
    if S % chunk:
        pad = chunk - S % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))                 # dt=0 -> no-op steps
        B_ = F.pad(B_, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
        S = S + pad
    nc = S // chunk
    rep = H // G
    xc = x.reshape(b, nc, chunk, H, P)
    dtc = dt.reshape(b, nc, chunk, H)
    Bc = B_.repeat_interleave(rep, dim=2).reshape(b, nc, chunk, H, N)
    Cc = C.repeat_interleave(rep, dim=2).reshape(b, nc, chunk, H, N)

    seg = torch.cumsum(dtc * A, dim=2)                  # [b,nc,c,H] (<= 0)
    total = seg[:, :, -1, :]                            # [b,nc,H]

    # within-chunk term: L[i,j] = exp(seg_i - seg_j) for i >= j (the
    # difference first: exp(seg_i) * exp(-seg_j) overflows)
    diff = seg[:, :, :, None, :] - seg[:, :, None, :, :]    # [b,nc,c,c,H]
    mask = torch.ones(chunk, chunk, dtype=torch.bool,
                      device=x.device).tril()
    L = torch.where(mask[None, None, :, :, None], torch.exp(diff),
                    torch.zeros((), dtype=diff.dtype, device=x.device))
    CB = torch.einsum("bqchs,bqkhs->bqckh", Cc, Bc)         # [b,nc,c,c,H]
    W = CB * L.to(CB.dtype) * dtc[:, :, None, :, :].to(CB.dtype)
    y_diag = torch.einsum("bqckh,bqkhp->bqchp", W, xc)

    # each chunk's contribution to its end state
    wgt = torch.exp(total[:, :, None, :] - seg) * dtc        # [b,nc,c,H]
    states = torch.einsum("bqchs,bqchp->bqhps",
                          Bc * wgt[..., None].to(Bc.dtype), xc).float()

    # inter-chunk recurrence over the chunk states (float32 carry)
    h = (torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    h_prev = []
    for q in range(nc):
        h_prev.append(h)
        h = h * torch.exp(total[:, q].float())[:, :, None, None] \
            + states[:, q]
    h_prev = torch.stack(h_prev, dim=1)                     # [b,nc,H,P,N]

    # output from the carried state
    y_off = torch.einsum("bqchs,bqch,bqhps->bqchp", Cc.float(),
                         torch.exp(seg).float(), h_prev)
    y = (y_diag.float() + y_off).to(x.dtype).reshape(b, S, H, P) \
        + x * D[None, None, :, None].to(x.dtype)
    return y[:, :S0], h


def ssd_decode_step(h: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    A: torch.Tensor, B_: torch.Tensor, C: torch.Tensor,
                    D: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrent SSD step (``repro.kernels.ref.ssd_decode_step``).
    h ``[B, H, P, N]``; x ``[B, H, P]``; dt ``[B, H]``; B_, C ``[B, G,
    N]``.  Returns (y ``[B, H, P]``, h_new)."""
    H, G = x.shape[1], B_.shape[1]
    rep = H // G
    Bh = B_.repeat_interleave(rep, dim=1)
    Ch = C.repeat_interleave(rep, dim=1)
    dA = torch.exp(dt * A[None, :])[:, :, None, None]
    h_new = h * dA + torch.einsum("bh,bhn,bhp->bhpn", dt, Bh, x)
    y = torch.einsum("bhn,bhpn->bhp", Ch, h_new) + x * D[None, :, None]
    return y, h_new


# ------------------------------------------------------------- MoE GMM
def moe_gmm(xbuf: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor) -> torch.Tensor:
    """Grouped expert SwiGLU (``repro.kernels.ref.moe_gmm``).  xbuf
    ``[E, C, d]`` (capacity-dispatched tokens); w_gate, w_up ``[E, d,
    f]``; w_down ``[E, f, d]``.  Returns ``[E, C, d]``."""
    gate = torch.einsum("ecd,edf->ecf", xbuf, w_gate)
    up = torch.einsum("ecd,edf->ecf", xbuf, w_up)
    return torch.einsum("ecf,efd->ecd", F.silu(gate) * up, w_down)
