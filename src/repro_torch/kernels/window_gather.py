"""CUDA ``window_gather``: the ring unwrap of the ECG flush and the
vitals readback (source: ``csrc/window_gather.cu``; replaces
``repro/kernels/window_gather.py:55``).  Bitwise equal to
``ref.window_gather``: it only moves data."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = _build.LaunchCount("window_gather")


def window_gather(buf: torch.Tensor, patients: torch.Tensor,
                  ends: torch.Tensor, valid: torch.Tensor,
                  L: int) -> torch.Tensor:
    """buf ``[N, C, cap]`` float32; patients/ends/valid ``[P]`` int32,
    all on one card.  Returns ``[P, C, L]``.  The caller keeps
    ``patients`` inside ``[0, N)`` (the kernel does not bound-check a
    device index, which would cost a host sync)."""
    dev = _build.require_cuda("window_gather", buf, patients, ends, valid)
    if buf.dtype != torch.float32 or buf.dim() != 3:
        raise ValueError(f"window_gather: buf must be [N, C, cap] "
                         f"float32, got {tuple(buf.shape)} {buf.dtype}")
    P = patients.shape[0]
    for name, t in (("patients", patients), ("ends", ends),
                    ("valid", valid)):
        if t.dtype != torch.int32 or tuple(t.shape) != (P,):
            raise ValueError(f"window_gather: {name} must be [{P}] int32, "
                             f"got {tuple(t.shape)} {t.dtype}")
    N, C, cap = buf.shape
    if L < 0:
        raise ValueError(f"window_gather: L={L}")
    out = torch.empty((P, C, L), dtype=buf.dtype, device=dev)
    lib = _build.LIBRARY.get()
    rc = lib.window_gather_f32(buf.data_ptr(), patients.data_ptr(),
                               ends.data_ptr(), valid.data_ptr(),
                               out.data_ptr(), N, C, cap, P, L,
                               _build.stream_of(buf))
    _build.check(rc, "window_gather")
    launches.bump()
    return out
