"""CUDA ``conv1d_stripe``/``conv1d_stripe_stacked``: every conv of the
ECG ResNeXt zoo (source: ``csrc/conv1d_stripe.cu``; replaces
``repro/kernels/conv1d_stripe.py:62`` and ``:99``).  One kernel serves
both entry points (the 3-D form is its ``M = 1`` case); each entry
point keeps its own launch counter."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import conv_padding

launches = _build.LaunchCount("conv1d_stripe")
launches_stacked = _build.LaunchCount("conv1d_stripe_stacked")


def _launch(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
            stride: int, groups: int, padding: str,
            name: str) -> torch.Tensor:
    tensors = (x, w) if b is None else (x, w, b)
    dev = _build.require_cuda(name, *tensors)
    for t in tensors:
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: float32 only, got {t.dtype}")
    M, B, L, Cin = x.shape
    Mw, K, cin_g, Cout = w.shape
    if Mw != M or cin_g * groups != Cin or Cout % groups or stride < 1:
        raise ValueError(f"{name}: x {tuple(x.shape)}, w {tuple(w.shape)}"
                         f", groups={groups}, stride={stride} do not "
                         "describe a grouped conv")
    if b is not None and tuple(b.shape) != (M, Cout):
        raise ValueError(f"{name}: bias {tuple(b.shape)} != {(M, Cout)}")
    lo, _, L_out = conv_padding(L, K, stride, padding)
    if M * B * L_out * Cout >= 2 ** 31:
        raise ValueError(f"{name}: {M * B * L_out * Cout} outputs exceed "
                         "the kernel's 32-bit index")
    y = torch.empty((M, B, L_out, Cout), dtype=x.dtype, device=dev)
    lib = _build.LIBRARY.get()
    rc = lib.conv1d_stripe_f32(
        x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
        y.data_ptr(), M, B, L, Cin, K, cin_g, Cout, groups, stride, lo,
        L_out, _build.stream_of(x))
    _build.check(rc, name)
    return y


def conv1d_stripe_stacked(x: torch.Tensor, w: torch.Tensor,
                          b: Optional[torch.Tensor] = None,
                          stride: int = 1, groups: int = 1,
                          padding: str = "SAME") -> torch.Tensor:
    """x ``[M, B, L, Cin]``; w ``[M, K, Cin // groups, Cout]``;
    b ``[M, Cout]``.  Returns ``[M, B, L_out, Cout]``."""
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError("conv1d_stripe_stacked: x and w must be 4-D")
    y = _launch(x, w, b, stride, groups, padding, "conv1d_stripe_stacked")
    launches_stacked.bump()
    return y


def conv1d_stripe(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor] = None, stride: int = 1,
                  groups: int = 1, padding: str = "SAME") -> torch.Tensor:
    """x ``[B, L, Cin]``; w ``[K, Cin // groups, Cout]``; b ``[Cout]``.
    Returns ``[B, L_out, Cout]``."""
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError("conv1d_stripe: x and w must be 3-D")
    y = _launch(x[None], w[None], None if b is None else b[None], stride,
                groups, padding, "conv1d_stripe")
    launches.bump()
    return y[0]
