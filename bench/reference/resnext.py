"""Plain forward pass of one 1-D stripe ResNeXt member (HOLMES §4.1.1).

Channels first, ``F.conv1d`` for every conv, float32.  ``tf32=True``
rounds every conv's and the head's operands to TF32 (10 mantissa bits,
round to nearest even) and accumulates in float32: the control of the
benchmark's check, computed the same way on any device."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties to even), as float32."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def _same(L: int, K: int, stride: int):
    L_out = -(-L // stride)
    pad_total = max((L_out - 1) * stride + K - L, 0)
    return pad_total // 2, pad_total - pad_total // 2


def conv(x: torch.Tensor, p: Dict, stride: int = 1, groups: int = 1,
         tf32: bool = False) -> torch.Tensor:
    """x ``[B, Cin, L]``; ``p["w"]`` ``[K, Cin // groups, Cout]``."""
    w = p["w"].permute(2, 1, 0)
    if tf32:
        x, w = round_tf32(x), round_tf32(w.contiguous())
    lo, hi = _same(x.shape[-1], w.shape[-1], stride)
    y = F.conv1d(F.pad(x, (lo, hi)), w, stride=stride, groups=groups)
    return y + p["b"][None, :, None]


def group_norm(p: Dict, x: torch.Tensor, groups: int = 4,
               eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over ``[B, C, L]``: ``g = min(groups, C)``, lowered until
    it divides ``C``; statistics over each group's channels and L."""
    B, C, L = x.shape
    g = min(groups, C)
    while C % g:
        g -= 1
    xg = x.reshape(B, g, C // g, L)
    mu = xg.mean(dim=(2, 3), keepdim=True)
    var = xg.var(dim=(2, 3), correction=0, keepdim=True)
    xg = (xg - mu) * torch.rsqrt(var + eps)
    return xg.reshape(B, C, L) * p["scale"][None, :, None] \
        + p["bias"][None, :, None]


def forward(params: Dict, x: torch.Tensor, cardinality: int,
            tf32: bool = False) -> torch.Tensor:
    """x ``[B, L]`` one lead -> P(stable) ``[B]`` (softmax's class 1)."""
    h = conv(x[:, None, :], params["stem"], stride=2, tf32=tf32)
    h = torch.relu(group_norm(params["stem_gn"], h))
    for i, blk in enumerate(params["blocks"]):
        stride = 2 if i % 2 == 0 else 1
        r = torch.relu(group_norm(blk["gn1"],
                                  conv(h, blk["reduce"], tf32=tf32)))
        r = torch.relu(group_norm(blk["gn2"], conv(
            r, blk["stripe"], stride=stride, groups=cardinality,
            tf32=tf32)))
        r = group_norm(blk["gn3"], conv(r, blk["expand"], tf32=tf32))
        short = h[..., ::stride] if stride > 1 else h
        h = torch.relu(short[..., :r.shape[-1]] + r)
    pooled = h.mean(dim=-1)
    w = params["head"]["w"]
    if tf32:
        pooled, w = round_tf32(pooled), round_tf32(w)
    logits = pooled @ w + params["head"]["b"]
    return torch.softmax(logits, dim=-1)[:, 1]
