"""CUDA ``conv1d_stripe``/``conv1d_stripe_stacked``: every conv of the
ECG ResNeXt zoo and mamba's short conv (source: ``csrc/conv1d_stripe.cu``;
replaces ``repro/kernels/conv1d_stripe.py:62`` and ``:99``).  One entry
point serves both (the 3-D form is its ``M = 1`` case) and picks the
depthwise, tiled or direct path by shape; each entry point keeps its own
launch counter.

At B = 1 a call is a few microseconds of device work, so the wrapper's
host time is most of its cost: the shape checks and the padding are
worked out once per shape (``_plan``) and the tensor checks that guard
the kernel (device, dtype, contiguity) stay on every call."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import conv_padding

launches = _build.LaunchCount("conv1d_stripe")
launches_stacked = _build.LaunchCount("conv1d_stripe_stacked")

PATHS = ("direct", "depthwise", "tiled")   # conv1d_stripe_path's codes

_plans = {}          # shape key -> (the kernel's int[11] dims, y's shape)


def _plan(key, name: str):
    """Validate one shape and work out the kernel's integer arguments."""
    xs, ws, bs, stride, groups, padding, stacked = key
    xs, ws = tuple(xs), tuple(ws)
    bs = None if bs is None else tuple(bs)
    if len(xs) != 3 + stacked or len(ws) != 3 + stacked:
        raise ValueError(f"{name}: x and w must be {3 + stacked}-D, got x "
                         f"{xs}, w {ws}")
    M, B, L, Cin = xs if stacked else (1, *xs)
    Mw, K, cin_g, Cout = ws if stacked else (1, *ws)
    if Mw != M or cin_g * groups != Cin or Cout % groups or stride < 1:
        raise ValueError(f"{name}: x {xs}, w {ws}, groups={groups}, "
                         f"stride={stride} do not describe a grouped conv")
    if bs is not None and bs != ((M, Cout) if stacked else (Cout,)):
        raise ValueError(f"{name}: bias {bs} does not match Cout={Cout}")
    lo, _, L_out = conv_padding(L, K, stride, padding)
    if M * B * L_out * Cout >= 2 ** 31:
        raise ValueError(f"{name}: {M * B * L_out * Cout} outputs exceed "
                         "the kernel's 32-bit index")
    dims = (M, B, L, Cin, K, cin_g, Cout, groups, stride, lo, L_out)
    yshape = (M, B, L_out, Cout) if stacked else (B, L_out, Cout)
    return (ctypes.c_int * 11)(*dims), yshape


_F32 = torch.float32
_entry = []          # the C entry point, once the library is loaded


def _launch(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
            stride: int, groups: int, padding: str, stacked: bool,
            name: str, force_direct: bool) -> torch.Tensor:
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad or (
            b is not None and b.requires_grad)):
        raise _build.no_backward(name)
    key = (x.shape, w.shape, None if b is None else b.shape, stride, groups,
           padding, stacked)
    plan = _plans.get(key)
    if plan is None:
        plan = _plans[key] = _plan(key, name)
    dims, yshape = plan
    # device, contiguity and dtype, on every call (one expression: at
    # B = 1 the host's time is the call's cost); the slow path names the
    # fault
    card = x.get_device()
    if not (x.is_cuda and x.is_contiguous() and x.dtype is _F32
            and w.get_device() == card and w.is_contiguous()
            and w.dtype is _F32
            and (b is None or (b.get_device() == card and b.is_contiguous()
                               and b.dtype is _F32))):
        tensors = (x, w) if b is None else (x, w, b)
        _build.require_cuda(name, *tensors)
        raise ValueError(f"{name}: float32 only, got "
                         f"{[t.dtype for t in tensors]}")
    if not _entry:
        _entry.append(_build.LIBRARY.get().conv1d_stripe_f32)
    y = x.new_empty(yshape)
    rc = _entry[0](x.data_ptr(), w.data_ptr(),
                   None if b is None else b.data_ptr(), y.data_ptr(), dims,
                   force_direct, torch._C._cuda_getCurrentRawStream(card))
    if rc:
        _build.check(rc, name)
    return y


def path(x_shape, w_shape, stride: int = 1, groups: int = 1,
         padding: str = "SAME") -> str:
    """The path ``conv1d_stripe_f32`` takes for these shapes (3-D or
    stacked): ``"depthwise"``, ``"tiled"`` or ``"direct"``.  Loads the
    kernel library."""
    stacked = len(x_shape) == 4
    dims, _ = _plan((tuple(x_shape), tuple(w_shape), None, stride, groups,
                     padding, stacked), "conv1d_stripe")
    M, B, _, Cin, K, cin_g, Cout = dims[:7]
    return PATHS[_build.LIBRARY.get().conv1d_stripe_path(
        M, B, Cin, K, cin_g, Cout, groups, stride)]


def conv1d_stripe_stacked(x: torch.Tensor, w: torch.Tensor,
                          b: Optional[torch.Tensor] = None,
                          stride: int = 1, groups: int = 1,
                          padding: str = "SAME", *,
                          force_direct: bool = False) -> torch.Tensor:
    """x ``[M, B, L, Cin]``; w ``[M, K, Cin // groups, Cout]``;
    b ``[M, Cout]``.  Returns ``[M, B, L_out, Cout]``.  ``force_direct``
    takes the one-thread-per-output path whatever the shape (for
    measurements against it)."""
    y = _launch(x, w, b, stride, groups, padding, True,
                "conv1d_stripe_stacked", force_direct)
    launches_stacked.bump()
    return y


def conv1d_stripe(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor] = None, stride: int = 1,
                  groups: int = 1, padding: str = "SAME", *,
                  force_direct: bool = False) -> torch.Tensor:
    """x ``[B, L, Cin]``; w ``[K, Cin // groups, Cout]``; b ``[Cout]``.
    Returns ``[B, L_out, Cout]``."""
    y = _launch(x, w, b, stride, groups, padding, False, "conv1d_stripe",
                force_direct)
    launches.bump()
    return y
