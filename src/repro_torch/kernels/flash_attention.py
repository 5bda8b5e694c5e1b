"""CUDA ``flash_attention``: the prefill attention of the LM path
(``S > 1``; source: ``csrc/flash_attention.cu``; replaces
``repro/kernels/flash_attention.py:98``).  Computes ``ref.attention``
within the port's tolerance, for ``Dv == D`` (zamba2's 112 and the
published Zamba2's 224 among them) and for the materialized MLA
prefill's ``(D, Dv) = (192, 128)``, as
3xTF32 products on the tensor cores; bitwise repeatable at a fixed
shape.  Causal or not, with or without a window, and with ``T != S``
(seamless's cross-attention: all-zero positions, not causal).  A single decode
token goes to ``kernels/decode_attention.py``."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

launches = _build.LaunchCount("flash_attention")

# the kernel's (D, Dv) instantiations
HEAD_DIMS = ((16, 16), (32, 32), (64, 64), (112, 112), (128, 128),
             (192, 128), (224, 224))
SMEM_MAX = 232448     # bytes of shared memory a block may have


def pad_ld(width: int) -> int:
    """A tile row of ``width`` floats padded to 4 mod 32 (``pad_ld``)."""
    return width + (36 - width % 32) % 32


def tile_plan(D: int, Dv: int) -> dict:
    """The source's ``Cfg<D, Dv>``: query rows a block (``bq``, 128), its
    warps of 16 rows, keys a tile (``bk``: 64 to D = 128, 32 to D = 192,
    else 16, where two 32-key slots do not fit beside 128 rows) and a
    block's bytes of shared memory (``smem``: Q, and two ring slots of
    K, V and kpos)."""
    bq = 128
    bk = 16 if D > 192 else 32 if D > 128 else 64
    slot = bk * pad_ld(D) + bk * pad_ld(Dv) + bk
    return {"bq": bq, "warps": bq // 16, "bk": bk,
            "smem": 4 * (bq * pad_ld(D) + 2 * slot)}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    qpos: torch.Tensor, kpos: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q ``[B, S, Hq, D]`` with ``S > 1``; k ``[B, T, Hkv, D]`` and v
    ``[B, T, Hkv, Dv]`` with ``Hkv | Hq``; qpos ``[S]``, kpos ``[T]``
    int32 (``kpos < 0`` = empty slot); all float32, contiguous, on one
    card.  Returns ``[B, S, Hq, Dv]``."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise _build.no_backward("flash_attention")
    if q.dim() == 4 and q.shape[1] == 1:
        raise ValueError("flash_attention: one query token (S = 1) is a "
                         "decode step: use kernels.decode_attention "
                         "(ops.attention does)")
    dev = _build.require_cuda("flash_attention", q, k, v, qpos, kpos)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32 or t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be 4-D float32, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte "
                             "aligned")
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    Dv = v.shape[3]
    if tuple(k.shape) != (B, T, Hkv, D) or tuple(v.shape) != (B, T, Hkv, Dv):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not "
                         "match")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: Hkv={Hkv} does not divide "
                         f"Hq={Hq}")
    if (D, Dv) not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dims (D, Dv) = {(D, Dv)} "
                         f"not in {HEAD_DIMS}")
    if T == 0:
        raise ValueError("flash_attention: no keys (T = 0)")
    for name, t, n in (("qpos", qpos, S), ("kpos", kpos, T)):
        if t.dtype != torch.int32 or tuple(t.shape) != (n,):
            raise ValueError(f"flash_attention: {name} must be [{n}] int32, "
                             f"got {tuple(t.shape)} {t.dtype}")
    if -(-S // tile_plan(D, Dv)["bq"]) * B * Hq >= 2 ** 31 \
            or B * S >= 2 ** 31:
        raise ValueError(f"flash_attention: B={B}, Hq={Hq}, S={S} exceed "
                         "the kernel's grid or row index")
    out = torch.empty((B, S, Hq, Dv), dtype=q.dtype, device=dev)
    scale = float(scale if scale is not None else D ** -0.5)
    lib = _build.LIBRARY.get()
    rc = lib.flash_attention_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qpos.data_ptr(),
        kpos.data_ptr(), out.data_ptr(), B, S, T, Hq, Hkv, D, Dv,
        int(causal), int(window), scale, _build.stream_of(q))
    _build.check(rc, "flash_attention")
    launches.bump()
    return out
