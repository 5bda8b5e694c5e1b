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

import numpy as np
import torch

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
