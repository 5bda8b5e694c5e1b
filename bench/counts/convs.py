"""Every conv of a ResNeXt member's forward pass from its shapes, and the
least time the card could take for it (a frozen copy of the port's
measurement arithmetic: bytes counted once, FMAs only for the taps that
land inside ``[0, L)``)."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from bench.counts.peaks import HBM_BYTES_S, TF32_FLOP_S

Conv = Tuple[str, int, int, int, int, int, int]


def conv_padding(L: int, K: int, stride: int) -> Tuple[int, int, int]:
    """``(lo, hi, L_out)`` of a SAME conv in the lax convention
    (``L_out = ceil(L / stride)``, ``lo = pad_total // 2``)."""
    L_out = -(-L // stride)
    pad_total = max((L_out - 1) * stride + K - L, 0)
    lo = pad_total // 2
    return lo, pad_total - lo, L_out


def inner_width(width: int, cardinality: int) -> int:
    inner = max(cardinality, width // 2)
    return inner - inner % cardinality


def conv_calls(width: int, blocks: int, input_len: int, cardinality: int,
               kernel_size: int) -> List[Conv]:
    """``(layer, L_in, Cin, Cout, K, groups, stride)`` of every conv of
    one member, in order."""
    W, K, card = width, kernel_size, cardinality
    inner = inner_width(W, card)
    L = input_len
    calls = [("stem", L, 1, W, K, 1, 2)]
    L = conv_padding(L, K, 2)[2]
    for i in range(blocks):
        s = 2 if i % 2 == 0 else 1
        calls.append(("reduce", L, W, inner, 1, 1, 1))
        calls.append(("stripe", L, inner, inner, K, card, s))
        L = conv_padding(L, K, s)[2]
        calls.append(("expand", L, inner, W, 1, 1, 1))
    return calls


def conv_counts(M: int, B: int, L: int, Cin: int, Cout: int, K: int,
                groups: int, stride: int) -> Tuple[float, float]:
    """(flops, bytes) of one member-stacked conv: each input and weight
    read once, the output written once; 2 flops an FMA inside [0, L)."""
    lo, _, L_out = conv_padding(L, K, stride)
    li = np.arange(L_out)[:, None] * stride + np.arange(K)[None, :] - lo
    taps = int(((li >= 0) & (li < L)).sum())
    cin_g = Cin // groups
    flops = 2.0 * M * B * Cout * cin_g * taps
    nbytes = 4.0 * (M * B * L * Cin + M * K * cin_g * Cout + M * Cout
                    + M * B * L_out * Cout)
    return flops, nbytes


def conv_bound_s(M: int, B: int, L: int, Cin: int, Cout: int, K: int,
                 groups: int, stride: int) -> float:
    """Least seconds for one stacked conv: the larger of its bytes over
    the HBM rate and its flops over the TF32 rate."""
    flops, nbytes = conv_counts(M, B, L, Cin, Cout, K, groups, stride)
    return max(nbytes / HBM_BYTES_S, flops / TF32_FLOP_S)


def buckets(members: Sequence[dict]) -> List[Tuple[dict, int]]:
    """``(shape, members in it)`` of each stacked bucket: members of equal
    (width, blocks, input_len, cardinality, kernel_size)."""
    out = {}
    for m in members:
        key = (m["width"], m["blocks"], m["input_len"], m["cardinality"],
               m["kernel_size"])
        out.setdefault(key, [m, 0])[1] += 1
    return [(m, n) for m, n in out.values()]


def _shape(m: dict):
    return (m["width"], m["blocks"], m["input_len"], m["cardinality"],
            m["kernel_size"])


def flush_conv_bound_s(members: Sequence[dict], ppad: int) -> float:
    """Least seconds of every stacked conv of one flush padded to
    ``ppad`` windows: one conv call a bucket and layer, over its M
    members and ``ppad`` rows."""
    total = 0.0
    for m, M in buckets(members):
        for _, L, cin, cout, K, g, s in conv_calls(*_shape(m)):
            total += conv_bound_s(M, ppad, L, cin, cout, K, g, s)
    return total


def window_flops(members: Sequence[dict]) -> float:
    """Model flops of scoring one window: every member's convs and its
    two-class head (GroupNorm, pooling and softmax left out)."""
    total = 0.0
    for m in members:
        for _, L, cin, cout, K, g, s in conv_calls(*_shape(m)):
            total += conv_counts(1, 1, L, cin, cout, K, g, s)[0]
        total += 2.0 * m["width"] * 2
    return total
