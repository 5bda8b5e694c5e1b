"""Dispatch between the CUDA kernels and their plain versions.

``impl`` keeps the reference's idiom (``repro/kernels/ops.py``):

* ``None`` (default) — chosen by the tensor's device: a CPU tensor runs
  the plain version, a CUDA tensor runs the CUDA kernel (or raises).
  There is no fallback from a kernel to the plain version.
* ``"torch"`` — the plain version on any device: the port's oracle,
  forced only by checks that hold the kernels against it.
* ``"cuda"`` — the CUDA kernel; a CPU tensor raises.

Kernel modules import nothing CUDA-specific, so the CPU tests import
them freely; the kernel library is built at the first launch.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import conv1d_stripe as _conv
from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import moe_gmm as _gmm
from repro_torch.kernels import ref
from repro_torch.kernels import ssd as _ssd
from repro_torch.kernels import window_gather as _gather

IMPLS = (None, "torch", "cuda")


def resolve(impl: Optional[str], t: torch.Tensor) -> str:
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r} not in {IMPLS}")
    if impl is None:
        return "cuda" if t.is_cuda else "torch"
    return impl


def conv1d(x, w, b=None, stride: int = 1, groups: int = 1,
           padding: str = "SAME", *, impl: Optional[str] = None):
    """x: ``[B, L, Cin]`` (one member) or ``[M, B, L, Cin]`` (a stacked
    bucket; w gains the same leading M axis, b becomes ``[M, Cout]``)."""
    stacked = x.dim() == 4
    if resolve(impl, x) == "torch":
        fn = ref.conv1d_stripe_stacked if stacked else ref.conv1d_stripe
    else:
        fn = _conv.conv1d_stripe_stacked if stacked else _conv.conv1d_stripe
    return fn(x, w, b, stride, groups, padding)


def window_gather(buf, patients, ends, valid, L: int, *,
                  impl: Optional[str] = None):
    """``[P, C, L]`` windows out of a ``[N, C, cap]`` ring."""
    if resolve(impl, buf) == "torch":
        return ref.window_gather(buf, patients, ends, valid, L)
    return _gather.window_gather(buf, patients, ends, valid, L)


def attention(q, k, v, qpos, kpos, *, causal: bool = True, window: int = 0,
              scale: Optional[float] = None, impl: Optional[str] = None,
              chunk: int = 0):
    """GQA attention ``[B, S, Hq, D]`` -> ``[B, S, Hq, Dv]``
    (``repro/kernels/ops.py:29``).  The plain version is
    ``ref.attention``, or ``ref.attention_chunked`` when ``chunk`` is
    set.  On the card a prefill (``S > 1``) runs the CUDA
    ``flash_attention`` and a decode step (``S == 1``) the CUDA
    ``decode_attention``, with ``qpos`` left on the card; both ignore
    ``chunk``, as the reference's Pallas route does."""
    if resolve(impl, q) == "torch":
        if chunk:
            return ref.attention_chunked(q, k, v, qpos, kpos, causal=causal,
                                         window=window, scale=scale,
                                         chunk=chunk)
        return ref.attention(q, k, v, qpos, kpos, causal=causal,
                             window=window, scale=scale)
    if q.shape[1] == 1:
        out = _decode.decode_attention(q[:, 0], k, v, kpos, qpos,
                                       window=window, scale=scale,
                                       causal=causal)
        return out[:, None]
    return _flash.flash_attention(q, k, v, qpos, kpos, causal=causal,
                                  window=window, scale=scale)


def decode_attention(q, k, v, kpos, qpos, *, window: int = 0,
                     scale: Optional[float] = None,
                     impl: Optional[str] = None):
    """One query token ``[B, Hq, D]`` against a ring cache ``[B, T, Hkv,
    D]`` (v ``[B, T, Hkv, Dv]``), causal at ``qpos``
    (``repro/kernels/ops.py:47``).  The plain version is
    ``ref.decode_attention``; on the card the CUDA ``decode_attention``,
    which also takes ``k`` and ``v`` rows that are strided views."""
    if resolve(impl, q) == "torch":
        return ref.decode_attention(q, k, v, kpos, qpos, window=window,
                                    scale=scale)
    return _decode.decode_attention(q, k, v, kpos, qpos, window=window,
                                    scale=scale)


def ssd(x, dt, A, B_, C, D, chunk: int, h0=None, *,
        impl: Optional[str] = None):
    """Mamba-2 chunked SSD scan -> ``(y, hT)`` (``repro/kernels/ops.py:57``)."""
    if resolve(impl, x) == "torch":
        return ref.ssd_chunked(x, dt, A, B_, C, D, chunk, h0)
    return _ssd.ssd(x, dt, A, B_, C, D, chunk, h0)


def moe_gmm(xbuf, w_gate, w_up, w_down, *, impl: Optional[str] = None):
    """Grouped expert SwiGLU over ``[E, C, d]`` (``repro/kernels/ops.py:66``)."""
    if resolve(impl, xbuf) == "torch":
        return ref.moe_gmm(xbuf, w_gate, w_up, w_down)
    return _gmm.moe_gmm(xbuf, w_gate, w_up, w_down)
