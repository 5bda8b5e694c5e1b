"""CUDA ``decode_attention``: one query token against a (ring) KV cache,
every decode step of the LM path (source: ``csrc/decode_attention.cu``;
replaces ``repro/kernels/decode_attention.py:69``).  Computes
``ref.decode_attention`` within the port's tolerance, for any group size
``g = Hq / Hkv``, ``v`` of another width than ``k`` (MLA), and ``k`` and
``v`` rows that are strided views (the absorbed MLA step reads both out
of the latent cache).  A row that sees no key gets zeros, as the Pallas
kernel's; ``ref.decode_attention`` gives it the mean of ``v``.

The kernel takes one of two paths (``c_plan``): the tensor cores (3xTF32)
when the query heads come in runs of 16 (the absorbed MLA step), else
the CUDA cores.  T is cut into pieces (``split_plan``); one call is one
launch when the plan has one piece and two (the pieces, then their
combine) otherwise, and counts as one launch of the kernel.

A decode step is tens of microseconds of device work, so the wrapper's
host time matters: the shape checks and the plan are worked out once per
shape (``_plan``), and the checks that guard the kernel on every call
(device, dtype, contiguity, alignment) are one expression."""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.kernels import _build

launches = _build.LaunchCount("decode_attention")

TILE = 32                 # keys a tile of the kernel; a piece is a multiple
MAX_DV = 512
HEADS_PER_BLOCK = 16      # a run of query heads: one block, one m16 tile
WARPS = 8                 # of a block
SM_SMEM = 233472              # bytes of shared memory an SM holds
BLOCKS_PER_SM = 2             # the most the plan counts on
MAX_SLOTS = 6                 # of a block's K/V ring
PATHS = ("cuda_cores", "tensor_cores")     # the C plan's path numbers
# the fewest tiles a piece takes, by path: pieces shorter than this cost
# more in partial sums and combine than they gain in parallel blocks
MIN_PIECE_TILES = {"cuda_cores": 4, "tensor_cores": 2}

_F32, _I32 = torch.float32, torch.int32


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def pv_groups(Dv: int) -> int:
    """The key groups over which the CUDA-core path spreads a tile's
    P @ V (``PvLayout::KS`` in ``csrc/decode_attention.cu``; the C plan
    reports the same number): 256 threads as (group, float4 column of Dv
    rounded up to a power of two), at most 32 groups."""
    dvc = max(16, 1 << (Dv - 1).bit_length())
    return min(TILE, WARPS * 32 // (dvc // 4))


def c_plan(g: int, D: int, Dv: int, v_in_k: bool, slots: int = 2,
           path: Optional[str] = None) -> Optional[Tuple[str, int, int]]:
    """``(path, shared-memory bytes of a block, P @ V key groups)`` of a
    shape with a ring of ``slots`` tiles, from the kernel's own layout
    (``decode_attention_plan`` in ``csrc/decode_attention.cu``; needs
    the built library).  ``path`` None: the tensor cores (runs of 16
    heads, D and Dv multiples of 8) when they fit, else the CUDA cores.
    None when the path does not fit a block's shared memory."""
    out = (ctypes.c_int * 3)()
    rc = _build.LIBRARY.get().decode_attention_plan(
        g, D, Dv, int(v_in_k), slots,
        -1 if path is None else PATHS.index(path), out)
    return None if rc else (PATHS[out[0]], out[1], out[2])


def blocks_per_sm(smem: int) -> int:
    """Blocks of ``smem`` bytes an SM runs at once, at most
    ``BLOCKS_PER_SM`` (each block also holds 1 KB the runtime keeps)."""
    return max(1, min(BLOCKS_PER_SM, SM_SMEM // (smem + 1024)))


def ring_plan(smem_of: Callable[[int], Optional[int]],
              tiles: int) -> Tuple[int, int]:
    """``(slots, blocks an SM)`` for a piece of ``tiles`` tiles, given a
    block's shared-memory bytes by ring depth (``smem_of(slots)``, None
    where it does not fit): as many blocks an SM as fit with a ring of
    two tiles, then the deepest ring (at most ``MAX_SLOTS``, and no
    deeper than the piece) that keeps them.  On the card more blocks an
    SM did better than deeper rings at the served shapes, and a short
    piece gets all its tiles in flight at once."""
    blocks, slots = blocks_per_sm(smem_of(2)), 2
    while slots < min(MAX_SLOTS, tiles):
        need = smem_of(slots + 1)
        if need is None or blocks_per_sm(need) != blocks:
            break
        slots += 1
    return slots, blocks


def split_plan(B: int, Hkv: int, g: int, T: int, n_sm: int, per_sm: int,
               min_tiles: int) -> Tuple[int, int]:
    """``(ts, n_split)``: the keys of a piece (a multiple of the tile)
    and the number of pieces.  The ``B x Hkv x runs x n_split`` blocks
    (``runs`` of up to 16 query heads a KV group) fill at most one wave
    of the card at ``per_sm`` blocks an SM, with pieces of at least
    ``min_tiles`` tiles; one piece when the grid is already that large
    or T that short."""
    runs = -(-g // HEADS_PER_BLOCK)
    tiles = -(-T // TILE)
    n = max(1, min(n_sm * per_sm // (B * Hkv * runs), tiles // min_tiles))
    ts = -(-tiles // n) * TILE
    return ts, -(-T // ts)


class Plan(NamedTuple):
    """What a call of one shape launches: the C launcher's ``dims``,
    the output's shape, the scratch floats, the path, the pieces and
    the ring's depth."""
    dims: ctypes.Array
    oshape: Tuple[int, int, int]
    scratch: int
    D: int
    path: str
    ts: int
    n_split: int
    slots: int


def _row_strides(name: str, t: torch.Tensor) -> Tuple[int, int, int]:
    if t.dtype != _F32 or t.dim() != 4:
        raise ValueError(f"decode_attention: {name} must be 4-D float32, "
                         f"got {tuple(t.shape)} {t.dtype}")
    sb, st, sh, sd = t.stride()
    if sd != 1 or t.data_ptr() % 16 or sb % 4 or st % 4 or sh % 4:
        raise ValueError(f"decode_attention: the rows of {name} must be "
                         "contiguous and 16-byte aligned (strides "
                         f"{t.stride()})")
    return sb, st, sh


def _check(q, k, v, kpos, qpos) -> None:
    """Every check of a call, each fault named; raises on the first."""
    dev = _build.require_cuda("decode_attention", q, kpos, qpos)
    for name, t in (("k", k), ("v", v)):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"decode_attention: {name} on {t.device}, q "
                             f"on {dev} (the kernel needs one card)")
    if q.dtype != _F32 or q.dim() != 3 or q.data_ptr() % 16:
        raise ValueError(f"decode_attention: q must be [B, Hq, D] float32, "
                         f"16-byte aligned; got {tuple(q.shape)} {q.dtype}")
    _row_strides("k", k)
    _row_strides("v", v)
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
        if t.dtype != _I32 or tuple(t.shape) != (n,):
            raise ValueError(f"decode_attention: {name} must be [{n}] "
                             f"int32, got {tuple(t.shape)} {t.dtype}")
    if B > 65535 or Hkv * -(-(Hq // Hkv) // HEADS_PER_BLOCK) > 65535:
        raise ValueError(f"decode_attention: B={B}, Hq={Hq} exceed the "
                         "kernel's grid")


_plans = {}      # shape key -> Plan
_entry = []      # the C entry point, once the library is loaded


def _plan(key, q, k, v, kpos, qpos, path: Optional[str] = None) -> Plan:
    """Validate one shape and work out the kernel's arguments; ``path``
    forces a path (None: the C plan's choice)."""
    _check(q, k, v, kpos, qpos)
    _, _, sk, _, sv, v_in_k, window, causal, card = key[:9]
    B, Hq, D = q.shape
    T, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    g = Hq // Hkv
    # v is the first Dv columns of k's rows: the kernel reads them once
    v_in_k = bool(v_in_k and sv == sk and Dv <= D)
    first = c_plan(g, D, Dv, v_in_k, 2, path)
    if first is None:
        raise ValueError(f"decode_attention: g={g}, (D, Dv)={(D, Dv)} does "
                         "not fit a block's shared memory "
                         f"({path or 'either path'})")
    path, smem, _ = first

    def smem_of(slots):
        got = c_plan(g, D, Dv, v_in_k, slots, path)
        return None if got is None else got[1]

    ts, n_split = split_plan(B, Hkv, g, T, _sm_count(card),
                             blocks_per_sm(smem), MIN_PIECE_TILES[path])
    slots, _ = ring_plan(smem_of, ts // TILE)
    dims = (B, T, Hq, Hkv, D, Dv, *sk[:3], *sv[:3], int(causal),
            int(window), ts, n_split, int(v_in_k), slots, PATHS.index(path))
    scratch = 0 if n_split == 1 else B * Hq * n_split * (Dv + 2)
    return Plan((ctypes.c_longlong * 19)(*dims), (B, Hq, Dv), scratch, D,
                path, ts, n_split, slots)


def _key(q, k, v, kpos, qpos, window, causal, card):
    return (q.shape, k.shape, k.stride(), v.shape, v.stride(),
            v.data_ptr() == k.data_ptr(), window, causal, card, kpos.shape,
            qpos.shape)


def plan_of(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            kpos: torch.Tensor, qpos: torch.Tensor, *, window: int = 0,
            causal: bool = True) -> Plan:
    """The plan that calls with these inputs' shapes run (None before
    the first such call)."""
    return _plans.get(_key(q, k, v, kpos, qpos, window, causal,
                           q.get_device()))


def _launch(plan: Plan, q, k, v, kpos, qpos, scale) -> torch.Tensor:
    out = q.new_empty(plan.oshape)
    scratch = q.new_empty(plan.scratch) if plan.scratch else None
    if not _entry:
        _entry.append(_build.LIBRARY.get().decode_attention_f32)
    rc = _entry[0](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   qpos.data_ptr(), kpos.data_ptr(),
                   None if scratch is None else scratch.data_ptr(),
                   out.data_ptr(), plan.dims,
                   plan.D ** -0.5 if scale is None else scale,
                   torch._C._cuda_getCurrentRawStream(q.get_device()))
    if rc:
        _build.check(rc, "decode_attention")
    return out


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
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise _build.no_backward("decode_attention")
    if isinstance(qpos, int):
        qpos = torch.full((1,), qpos, dtype=_I32, device=q.device)
    # device, dtype, contiguity and alignment, on every call (one
    # expression); the slow path names the fault
    card = q.get_device()
    if not (q.is_cuda and q.dtype is _F32 and q.is_contiguous()
            and k.get_device() == card and v.get_device() == card
            and kpos.get_device() == card and qpos.get_device() == card
            and k.dtype is _F32 and v.dtype is _F32 and kpos.dtype is _I32
            and qpos.dtype is _I32 and kpos.is_contiguous()
            and not (q.data_ptr() | k.data_ptr() | v.data_ptr()) & 15):
        _check(q, k, v, kpos, qpos)
        raise ValueError("decode_attention: unsupported inputs")
    key = _key(q, k, v, kpos, qpos, window, causal, card)
    plan = _plans.get(key)
    if plan is None:
        plan = _plans[key] = _plan(key, q, k, v, kpos, qpos)
    out = _launch(plan, q, k, v, kpos, qpos, scale)
    launches.bump()
    return out
