"""CUDA ``ssd``: the Mamba-2 chunked SSD scan of every mamba prefill
(source: ``csrc/ssd.cu``; replaces ``repro/kernels/ssd_scan.py:74``).
Computes ``ref.ssd_chunked`` within the port's tolerance, a ragged S
and an initial state included.

One call is four launches, chunk-parallel (each chunk's own end state,
each chunk's ``C B^T`` once per group, the states passed on in chunk
order, then each chunk's output), and counts as one launch of the
kernel.  The per-chunk states and products go through a scratch buffer
(``scratch_floats``: 172 MB at the served mamba2-2.7b shape) that the
wrapper allocates."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

launches = _build.LaunchCount("ssd")

MAX_CHUNK, MAX_P, MAX_N = 128, 64, 128     # the kernel's on-chip tiles


def scratch_floats(B: int, S: int, H: int, G: int, P: int, N: int,
                   chunk: int) -> int:
    """Floats of the call's scratch: each (chunk, group)'s ``C B^T``
    (128 x 128), each (chunk, head)'s ``[P, N]`` state and its total
    decay ``sum(dt * A)``."""
    return B * -(-S // chunk) * (G * MAX_CHUNK * MAX_CHUNK
                                 + H * (P * N + 1))


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        B_: torch.Tensor, C: torch.Tensor, D: torch.Tensor, chunk: int,
        h0: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x ``[B, S, H, P]``; dt ``[B, S, H]``; A, D ``[H]``; B_, C ``[B,
    S, G, N]`` with ``G | H``; h0 ``[B, H, P, N]`` or None; all float32,
    contiguous, on one card.  Returns (y ``[B, S, H, P]``, hT ``[B, H,
    P, N]``)."""
    tensors = (x, dt, A, B_, C, D) + (() if h0 is None else (h0,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise _build.no_backward("ssd")
    dev = _build.require_cuda("ssd", *tensors)
    for t in tensors:
        if t.dtype != torch.float32:
            raise ValueError(f"ssd: float32 only, got {t.dtype}")
    if x.dim() != 4 or B_.dim() != 4:
        raise ValueError("ssd: x and B_ must be 4-D")
    b, S, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    want = {"dt": (dt, (b, S, H)), "A": (A, (H,)), "B_": (B_, (b, S, G, N)),
            "C": (C, (b, S, G, N)), "D": (D, (H,))}
    if h0 is not None:
        want["h0"] = (h0, (b, H, P, N))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"ssd: {name} is {tuple(t.shape)}, want {shape}")
    if G == 0 or H % G:
        raise ValueError(f"ssd: G={G} does not divide H={H}")
    if not (0 < chunk <= MAX_CHUNK and 0 < P <= MAX_P and 0 < N <= MAX_N):
        raise ValueError(f"ssd: chunk={chunk}, P={P}, N={N} exceed the "
                         f"kernel's tiles ({MAX_CHUNK}, {MAX_P}, {MAX_N})")
    if b > 65535 or H > 65535 or x.numel() >= 2 ** 31:
        raise ValueError(f"ssd: x {tuple(x.shape)} exceeds the kernel's "
                         "grid (B, H <= 65535) or 32-bit index")
    y = torch.empty_like(x)
    hT = torch.empty((b, H, P, N), dtype=torch.float32, device=dev)
    scratch = torch.empty(scratch_floats(b, S, H, G, P, N, chunk),
                          dtype=torch.float32, device=dev)
    lib = _build.LIBRARY.get()
    rc = lib.ssd_f32(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                     B_.data_ptr(), C.data_ptr(), D.data_ptr(),
                     None if h0 is None else h0.data_ptr(), y.data_ptr(),
                     hT.data_ptr(), scratch.data_ptr(), b, S, H, P, G, N,
                     chunk, _build.stream_of(x))
    _build.check(rc, "ssd")
    launches.bump()
    return y, hT
