"""Mamba-2 block (SSD, state-space duality) of the pure-SSM language
model (``repro/models/ssm.py``).

The reference's layout is kept: the in-projection is stored as separate
z, x, B, C and dt projections, and the three short convs are causal
depthwise convs over x, B and C.  Prefill runs each short conv through
``ops.conv1d(..., groups=channels, padding="CAUSAL")`` (the CUDA
``conv1d_stripe`` kernel on the card) and the scan through ``ops.ssd``
(the CUDA ``ssd`` kernel), and returns the last ``K - 1`` raw conv
inputs and the final state as the decode cache.

Decode runs one step with the einsum conv step and ``ref.ssd_decode_step``
(plain tensor ops on any device), exactly as the reference does
(``ssm.py:115-127``): the JAX package calls no kernel there, so the
port's decode launches none either; it is no fallback.  ``mamba2_apply``
in decode mode advances the cache IN PLACE (the conv windows shift and
the state is overwritten in the tensors it was given), the port's
convention for decode caches (``models/transformer.py``).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops, ref
from repro_torch.models.layers import (init_rmsnorm, rms_norm,
                                       truncated_normal_init)


def init_mamba2(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype,
                device: torch.device, lead: Sequence[int] = ()):
    """One block's params (``lead`` stacks them, ``[L]`` for a segment)."""
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    H = s.n_heads(d)
    gn, K = s.n_groups * s.d_state, s.conv_width
    lead = tuple(lead)

    def w(shape):
        return truncated_normal_init(gen, shape, 1.0, dtype, device, lead)

    def const(n, value, dt=dtype):
        return torch.full(lead + (n,), value, dtype=dt, device=device)

    return {
        "z_proj": w((d, di)),
        "x_proj": w((d, di)),
        "B_proj": w((d, gn)),
        "C_proj": w((d, gn)),
        "dt_proj": w((d, H)),
        "conv_x": w((K, 1, di)),
        "conv_B": w((K, 1, gn)),
        "conv_C": w((K, 1, gn)),
        "conv_bx": const(di, 0.0),
        "conv_bB": const(gn, 0.0),
        "conv_bC": const(gn, 0.0),
        "A_log": const(H, 0.0, torch.float32),          # A = -exp(0) = -1
        "D": const(H, 1.0, torch.float32),
        "dt_bias": const(H, 0.0, torch.float32),
        "norm": init_rmsnorm(di, dtype, device, lead),
        "out_proj": w((di, d)),
    }


def ssm_cache_init(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                   device: torch.device, lead: Sequence[int] = ()):
    """Empty decode state: the last ``K - 1`` conv inputs of x, B and C,
    and the ``[B, H, P, N]`` float32 SSM state."""
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    gn = s.n_groups * s.d_state
    K = s.conv_width
    lead = tuple(lead)

    def z(*shape, dt=dtype):
        return torch.zeros(lead + shape, dtype=dt, device=device)

    return {"conv_x": z(batch, K - 1, di),
            "conv_B": z(batch, K - 1, gn),
            "conv_C": z(batch, K - 1, gn),
            "ssm": z(batch, s.n_heads(d), s.head_dim, s.d_state,
                     dt=torch.float32)}


def _conv_step(hist: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """hist ``[B, K, ch]`` -> the causal conv's output at the last step
    ``[B, ch]``."""
    return torch.einsum("bkc,kc->bc", hist, w[:, 0, :]) + b


def gated_norm(y: torch.Tensor, z: torch.Tensor, p, eps: float,
               groups: int = 1) -> torch.Tensor:
    """``RMSNorm(y * SiLU(z))`` with the mean square taken over each of
    ``groups`` equal groups of the last axis (one group: the whole
    axis, as the reference has it)."""
    h = y * F.silu(z)
    if groups == 1:
        return rms_norm(h, p, eps)
    dt = h.dtype
    hg = h.float().unflatten(-1, (groups, -1))
    hg = hg * torch.rsqrt(hg.square().mean(-1, keepdim=True) + eps)
    return (hg.flatten(-2) * p["scale"].float()).to(dt)


def mamba2_apply(p, u: torch.Tensor, cfg: ArchConfig, *,
                 cache: Optional[dict] = None, return_cache: bool = False,
                 impl: Optional[str] = None, norm_groups: int = 1
                 ) -> Tuple[torch.Tensor, Optional[dict]]:
    """u ``[B, S, d]``.  With ``cache`` (decode) S must be 1 and the
    cache is advanced in place and returned; ``return_cache`` on the
    full-sequence path returns the post-prefill conv and SSM state.
    ``norm_groups`` groups the gated norm (``gated_norm``): the
    published Zamba2 takes ``ssm.n_groups``, the reference one."""
    s = cfg.ssm
    B, S, d = u.shape
    di = s.d_inner(d)
    H, P, G, N, K = (s.n_heads(d), s.head_dim, s.n_groups, s.d_state,
                     s.conv_width)

    z = u @ p["z_proj"]
    x_raw = u @ p["x_proj"]
    B_raw = u @ p["B_proj"]
    C_raw = u @ p["C_proj"]
    dt = F.softplus((u @ p["dt_proj"]).float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    if cache is None:
        xc = F.silu(ops.conv1d(x_raw, p["conv_x"], p["conv_bx"], groups=di,
                               padding="CAUSAL", impl=impl))
        Bc = F.silu(ops.conv1d(B_raw, p["conv_B"], p["conv_bB"],
                               groups=G * N, padding="CAUSAL", impl=impl))
        Cc = F.silu(ops.conv1d(C_raw, p["conv_C"], p["conv_bC"],
                               groups=G * N, padding="CAUSAL", impl=impl))
        y, hT = ops.ssd(xc.reshape(B, S, H, P), dt, A,
                        Bc.reshape(B, S, G, N), Cc.reshape(B, S, G, N),
                        p["D"], s.chunk, impl=impl)
        new_cache = None
        if return_cache:
            # copies: a view would keep the whole [B, S, ch] input alive
            new_cache = {"conv_x": x_raw[:, S - (K - 1):, :].clone(),
                         "conv_B": B_raw[:, S - (K - 1):, :].clone(),
                         "conv_C": C_raw[:, S - (K - 1):, :].clone(),
                         "ssm": hT.float()}
        y = y.reshape(B, S, di)
    else:
        hx = torch.cat([cache["conv_x"], x_raw], dim=1)
        hB = torch.cat([cache["conv_B"], B_raw], dim=1)
        hC = torch.cat([cache["conv_C"], C_raw], dim=1)
        x = F.silu(_conv_step(hx, p["conv_x"], p["conv_bx"]))
        Bm = F.silu(_conv_step(hB, p["conv_B"], p["conv_bB"]))
        Cm = F.silu(_conv_step(hC, p["conv_C"], p["conv_bC"]))
        y, h_new = ref.ssd_decode_step(
            cache["ssm"], x.float().reshape(B, H, P), dt[:, 0], A,
            Bm.float().reshape(B, G, N), Cm.float().reshape(B, G, N),
            p["D"])
        cache["conv_x"].copy_(hx[:, 1:])
        cache["conv_B"].copy_(hB[:, 1:])
        cache["conv_C"].copy_(hC[:, 1:])
        cache["ssm"].copy_(h_new)
        new_cache = cache
        y = y.to(u.dtype).reshape(B, 1, di)

    y = gated_norm(y, z, p["norm"], cfg.norm_eps, norm_groups)
    return y @ p["out_proj"], new_cache
