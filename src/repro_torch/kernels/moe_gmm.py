"""CUDA ``moe_gmm``: the grouped expert SwiGLU of every MoE layer,
prefill and decode (source: ``csrc/moe_gmm.cu``; replaces
``repro/kernels/moe_gmm.py:48``).  Computes ``ref.moe_gmm`` within the
port's tolerance for any C and f.

The path follows C, a shape the host knows (no sync): up to
``STREAM_C_MAX`` rows an expert (decode) the routed weight stream, which
reads only the experts that hold a nonzero row; above it (prefill) 3xTF32
on the tensor cores.  One call is two or three launches and counts as
one launch of the kernel."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = _build.LaunchCount("moe_gmm")

STREAM_C_MAX = 64          # csrc/moe_gmm.cu routed::CMAX


def path(C: int) -> str:
    """``"stream"`` or ``"tensor_cores"``: the path a call with C rows an
    expert takes."""
    return "stream" if C <= STREAM_C_MAX else "tensor_cores"


def moe_gmm(xbuf: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor) -> torch.Tensor:
    """xbuf ``[E, C, d]``; w_gate, w_up ``[E, d, f]``; w_down ``[E, f,
    d]``; all float32, contiguous, on one card.  Returns ``[E, C, d]``."""
    if torch.is_grad_enabled() and (xbuf.requires_grad or w_gate.requires_grad
                                    or w_up.requires_grad
                                    or w_down.requires_grad):
        raise _build.no_backward("moe_gmm")
    dev = _build.require_cuda("moe_gmm", xbuf, w_gate, w_up, w_down)
    for t in (xbuf, w_gate, w_up, w_down):
        if t.dtype != torch.float32 or t.dim() != 3:
            raise ValueError(f"moe_gmm: 3-D float32 only, got "
                             f"{tuple(t.shape)} {t.dtype}")
    E, C, d = xbuf.shape
    f = w_gate.shape[2]
    if tuple(w_gate.shape) != (E, d, f) or w_up.shape != w_gate.shape \
            or tuple(w_down.shape) != (E, f, d):
        raise ValueError(f"moe_gmm: xbuf {tuple(xbuf.shape)}, w_gate "
                         f"{tuple(w_gate.shape)}, w_up {tuple(w_up.shape)}, "
                         f"w_down {tuple(w_down.shape)} do not match")
    if max(E * C * f, E * C * d, E * d * f) >= 2 ** 31 or E > 65535 \
            or max(f, d) // 64 >= 65535:
        raise ValueError(f"moe_gmm: E={E}, C={C}, d={d}, f={f} exceed the "
                         "kernel's grid or 32-bit index")
    y = torch.empty_like(xbuf)
    hbuf = torch.empty((E, C, f), dtype=torch.float32, device=dev)
    rows = (torch.empty(2 * E * C + E, dtype=torch.int32, device=dev)
            if path(C) == "stream" else None)
    rc = _build.LIBRARY.get().moe_gmm_f32(
        xbuf.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
        w_down.data_ptr(), hbuf.data_ptr(),
        None if rows is None else rows.data_ptr(), y.data_ptr(), E, C, d, f,
        _build.stream_of(xbuf))
    _build.check(rc, "moe_gmm")
    launches.bump()
    return y
