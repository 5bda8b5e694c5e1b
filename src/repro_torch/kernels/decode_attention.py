"""CUDA ``decode_attention``: one query token against a (ring) KV cache,
every decode step of the LM path (source: ``csrc/decode_attention.cu``;
replaces ``repro/kernels/decode_attention.py:69``).  Computes
``ref.decode_attention`` within the port's tolerance, for any group size
``g = Hq / Hkv``, ``v`` of another width than ``k`` (MLA), and ``k`` and
``v`` rows that are strided views (the absorbed MLA step reads both out
of the latent cache).  A row that sees no key gets zeros, as the Pallas
kernel's; ``ref.decode_attention`` gives it the mean of ``v``.

One call is two launches (the pieces of T, then their combine) and
counts as one launch of the kernel."""
from __future__ import annotations

import functools
from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels import _build

launches = _build.LaunchCount("decode_attention")

TILE = 32            # keys a tile of the kernel; a piece is a multiple
MAX_DV = 512
HEADS_PER_BLOCK = 16


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_plan(B: int, Hkv: int, g: int, T: int,
               n_sm: int) -> Tuple[int, int]:
    """``(ts, n_split)``: the keys of a piece (a multiple of the tile)
    and the number of pieces, so that the ``B x Hkv x runs x n_split``
    blocks of the first launch number about two a SM (``runs`` of up to
    16 query heads a KV group)."""
    runs = -(-g // HEADS_PER_BLOCK)
    tiles = -(-T // TILE)
    n = max(1, min(-(-2 * n_sm // (B * Hkv * runs)), tiles))
    ts = -(-tiles // n) * TILE
    return ts, -(-T // ts)


def _row_strides(name: str, t: torch.Tensor) -> Tuple[int, int, int]:
    if t.dtype != torch.float32 or t.dim() != 4:
        raise ValueError(f"decode_attention: {name} must be 4-D float32, "
                         f"got {tuple(t.shape)} {t.dtype}")
    sb, st, sh, sd = t.stride()
    if sd != 1 or t.data_ptr() % 16 or sb % 4 or st % 4 or sh % 4:
        raise ValueError(f"decode_attention: the rows of {name} must be "
                         "contiguous and 16-byte aligned (strides "
                         f"{t.stride()})")
    return sb, st, sh


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kpos: torch.Tensor, qpos: Union[int, torch.Tensor], *,
                     window: int = 0, scale: Optional[float] = None,
                     causal: bool = True) -> torch.Tensor:
    """q ``[B, Hq, D]`` contiguous; k ``[B, T, Hkv, D]`` and v ``[B, T,
    Hkv, Dv]`` with ``Hkv | Hq``, each row contiguous and 16-byte aligned
    (views allowed); kpos ``[T]`` int32 (``< 0`` = empty slot); qpos the
    query token's position, a ``[1]`` int32 tensor on the card (or an
    int); all on one card.  Returns ``[B, Hq, Dv]``.  ``causal=False``
    drops the causal part of the mask (``ops.attention`` passes its own
    flag through)."""
    if isinstance(qpos, int):
        qpos = torch.full((1,), qpos, dtype=torch.int32, device=q.device)
    dev = _build.require_cuda("decode_attention", q, kpos, qpos)
    for name, t in (("k", k), ("v", v)):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"decode_attention: {name} on {t.device}, q "
                             f"on {dev} (the kernel needs one card)")
    if q.dtype != torch.float32 or q.dim() != 3 or q.data_ptr() % 16:
        raise ValueError(f"decode_attention: q must be [B, Hq, D] float32, "
                         f"16-byte aligned; got {tuple(q.shape)} {q.dtype}")
    sk = _row_strides("k", k)
    sv = _row_strides("v", v)
    B, Hq, D = q.shape
    T, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    if tuple(k.shape) != (B, T, Hkv, D) or tuple(v.shape) != (B, T, Hkv, Dv):
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not "
                         "match")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"decode_attention: Hkv={Hkv} does not divide "
                         f"Hq={Hq}")
    if D % 4 or Dv % 4 or Dv > MAX_DV:
        raise ValueError(f"decode_attention: head dims (D, Dv) = {(D, Dv)}: "
                         f"both multiples of 4, Dv <= {MAX_DV}")
    if T == 0:
        raise ValueError("decode_attention: no keys (T = 0)")
    for name, t, n in (("qpos", qpos, 1), ("kpos", kpos, T)):
        if t.dtype != torch.int32 or tuple(t.shape) != (n,):
            raise ValueError(f"decode_attention: {name} must be [{n}] "
                             f"int32, got {tuple(t.shape)} {t.dtype}")
    if B > 65535 or Hkv * -(-(Hq // Hkv) // HEADS_PER_BLOCK) > 65535:
        raise ValueError(f"decode_attention: B={B}, Hq={Hq} exceed the "
                         "kernel's grid")
    # v is the first Dv columns of k's rows: the kernel reads them once
    v_in_k = int(v.data_ptr() == k.data_ptr() and sv == sk and Dv <= D)
    ts, n_split = split_plan(B, Hkv, Hq // Hkv, T, _sm_count(dev.index))
    out = torch.empty((B, Hq, Dv), dtype=torch.float32, device=dev)
    part = torch.empty((B, Hq, n_split, Dv), dtype=torch.float32,
                       device=dev)
    ml = torch.empty((B, Hq, n_split, 2), dtype=torch.float32, device=dev)
    scale = float(scale if scale is not None else D ** -0.5)
    lib = _build.LIBRARY.get()
    rc = lib.decode_attention_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qpos.data_ptr(),
        kpos.data_ptr(), part.data_ptr(), ml.data_ptr(), out.data_ptr(),
        B, T, Hq, Hkv, D, Dv, *sk, *sv, int(causal), int(window), ts,
        n_split, v_in_k, scale, _build.stream_of(q))
    _build.check(rc, "decode_attention")
    launches.bump()
    return out
