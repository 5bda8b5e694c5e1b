"""CUDA ``window_gather``: the ring unwrap of the ECG flush and the
vitals readback (source: ``csrc/window_gather.cu``; replaces
``repro/kernels/window_gather.py:55``).  Bitwise equal to
``ref.window_gather``: it only moves data.

A flush's gather is a few microseconds of device work, so the wrapper's
host time matters: the checks that guard the kernel on every call
(device, dtype, contiguity) are one expression, and the shape checks
run once per shape."""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

launches = _build.LaunchCount("window_gather")

_F32, _I32 = torch.float32, torch.int32
_shapes = {}     # shape key -> (output shape, int[5] N, C, cap, P, L, device)
_entry = []      # the C entry point, once the library is loaded


def _check(buf: torch.Tensor, patients: torch.Tensor, ends: torch.Tensor,
           valid: torch.Tensor, L: int) -> Tuple[int, int, int, int]:
    """Every check of a call, each fault named; raises on the first.
    Returns ``(N, C, cap, P)``."""
    _build.require_cuda("window_gather", buf, patients, ends, valid)
    if buf.dtype != _F32 or buf.dim() != 3:
        raise ValueError(f"window_gather: buf must be [N, C, cap] "
                         f"float32, got {tuple(buf.shape)} {buf.dtype}")
    P = patients.shape[0] if patients.dim() else -1
    for name, t in (("patients", patients), ("ends", ends),
                    ("valid", valid)):
        if t.dtype != _I32 or tuple(t.shape) != (P,):
            raise ValueError(f"window_gather: {name} must be [{P}] int32, "
                             f"got {tuple(t.shape)} {t.dtype}")
    if L < 0:
        raise ValueError(f"window_gather: L={L}")
    N, C, cap = buf.shape
    return N, C, cap, P


def window_gather(buf: torch.Tensor, patients: torch.Tensor,
                  ends: torch.Tensor, valid: torch.Tensor,
                  L: int) -> torch.Tensor:
    """buf ``[N, C, cap]`` float32; patients/ends/valid ``[P]`` int32,
    all on one card.  Returns ``[P, C, L]``.  The caller keeps
    ``patients`` inside ``[0, N)`` (the kernel does not bound-check a
    device index, which would cost a host sync)."""
    if torch.is_grad_enabled() and buf.requires_grad:
        raise _build.no_backward("window_gather")
    # device, dtype and contiguity, on every call (one expression); the
    # slow path names the fault
    card = buf.get_device()
    if not (card >= 0 and buf.dtype is _F32 and patients.dtype is _I32
            and ends.dtype is _I32 and valid.dtype is _I32
            and patients.get_device() == card and ends.get_device() == card
            and valid.get_device() == card and buf.is_contiguous()
            and patients.is_contiguous() and ends.is_contiguous()
            and valid.is_contiguous()):
        _check(buf, patients, ends, valid, L)
        raise ValueError("window_gather: unsupported inputs")
    key = (buf.shape, patients.shape, ends.shape, valid.shape, L, card)
    plan = _shapes.get(key)
    if plan is None:
        N, C, cap, P = _check(buf, patients, ends, valid, L)
        plan = _shapes[key] = ((P, C, L), (ctypes.c_int * 5)(
            N, C, cap, P, L), buf.device)
    out = torch.empty(plan[0], dtype=_F32, device=plan[2])
    if not _entry:
        _entry.append(_build.LIBRARY.get().window_gather_f32)
    rc = _entry[0](buf.data_ptr(), patients.data_ptr(), ends.data_ptr(),
                   valid.data_ptr(), out.data_ptr(), plan[1],
                   torch._C._cuda_getCurrentRawStream(card))
    if rc:
        _build.check(rc, "window_gather")
    launches.bump()
    return out
