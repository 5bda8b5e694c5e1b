"""The port's attention against the JAX package's.

* the plain ``attention`` and ``attention_chunked`` against
  ``repro.kernels.ref.attention`` / ``ref.attention_chunked`` and the
  Pallas ``flash_attention`` in interpret mode, at the float32 cases of
  ``tests/test_kernels.py``, within the one tolerance of
  ``repro_torch.testing``;
* the plain ``decode_attention`` oracle against JAX's;
* the plain models of the CUDA kernels' order of work
  (``flash_attention_tiles``, ``decode_attention_pieces``) against JAX's
  oracles and the Pallas kernels in interpret mode;
* what the oracles give a row that sees no key (the uniform mean of v);
* the ``ops`` dispatch: CPU tensors run the plain versions, and the CUDA
  kernel's wrapper refuses them.

The CUDA kernel itself is held against the plain version in
``tests/test_torch_cuda.py`` (card only) and by ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pl_decode
from repro.kernels.flash_attention import flash_attention as pl_flash
from repro_torch.kernels import decode_attention as kdecode
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import ops, ref
from repro_torch.testing import (assert_close, decode_attention_pieces,
                                 flash_attention_tiles, flash_stages)

torch.set_num_threads(1)

# (B, S, T, Hq, Hkv, D, causal, window): tests/test_kernels.py:24-30
FLASH_CASES = [
    (2, 64, 64, 4, 2, 32, True, 0),
    (1, 128, 128, 8, 8, 64, True, 16),
    (2, 48, 96, 4, 1, 32, True, 0),
    (1, 64, 64, 2, 2, 32, False, 0),
    (1, 33, 70, 6, 3, 16, True, 24),
]

# (B, T, Hq, Hkv, D, window, fill): tests/test_kernels.py:48-52
DECODE_CASES = [
    (2, 128, 8, 2, 64, 0, 128),
    (2, 128, 8, 2, 64, 0, 100),
    (1, 96, 4, 4, 32, 32, 96),
    (2, 80, 4, 1, 32, 0, 80),
]


def _qkv(B, S, T, Hq, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, Hq, D)).astype(np.float32),
            rng.standard_normal((B, T, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, T, Hkv, D)).astype(np.float32))


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(map(
    str, c)))
def test_plain_attention_matches_jax_and_pallas(case):
    B, S, T, Hq, Hkv, D, causal, window = case
    q, k, v = _qkv(B, S, T, Hq, Hkv, D)
    qpos = np.arange(T - S, T, dtype=np.int32)
    kpos = np.arange(T, dtype=np.int32)
    want = jref.attention(*_j(q, k, v, qpos, kpos), causal=causal,
                          window=window)
    pallas = pl_flash(*_j(q, k, v, qpos, kpos), causal=causal,
                      window=window, block_q=32, block_k=32, interpret=True)
    tq, tk, tv, tqp, tkp = _t(q, k, v, qpos, kpos)
    got = ref.attention(tq, tk, tv, tqp, tkp, causal=causal, window=window)
    assert_close(got, want)
    assert_close(got, pallas)
    for chunk in (16, 32):
        got_c = ref.attention_chunked(tq, tk, tv, tqp, tkp, causal=causal,
                                      window=window, chunk=chunk)
        assert_close(got_c, jref.attention_chunked(
            *_j(q, k, v, qpos, kpos), causal=causal, window=window,
            chunk=chunk))
        assert_close(got_c, want)
    # ops dispatch: a CPU tensor runs the plain version, chunked or not
    assert_close(ops.attention(tq, tk, tv, tqp, tkp, causal=causal,
                               window=window), want)
    assert_close(ops.attention(tq, tk, tv, tqp, tkp, causal=causal,
                               window=window, chunk=16), want)


def test_plain_attention_with_dv_other_than_d_matches_jax():
    q, k, _ = _qkv(2, 24, 40, 4, 2, 32)
    v = np.random.default_rng(1).standard_normal((2, 40, 2, 16)).astype(
        np.float32)
    qpos = np.arange(16, 40, dtype=np.int32)
    kpos = np.arange(40, dtype=np.int32)
    want = jref.attention(*_j(q, k, v, qpos, kpos), window=12)
    got = ref.attention(*_t(q, k, v, qpos, kpos), window=12)
    assert tuple(got.shape) == (2, 24, 4, 16)
    assert_close(got, want)
    assert_close(ref.attention_chunked(*_t(q, k, v, qpos, kpos), window=12,
                                       chunk=16),
                 jref.attention_chunked(*_j(q, k, v, qpos, kpos), window=12,
                                        chunk=16))


@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: "-".join(map(
    str, c)))
def test_plain_decode_attention_matches_jax(case):
    B, T, Hq, Hkv, D, window, fill = case
    q, k, v = _qkv(B, 1, T, Hq, Hkv, D)
    q = q[:, 0]
    kpos = np.where(np.arange(T) < fill, np.arange(T), -1).astype(np.int32)
    want = jref.decode_attention(*_j(q, k, v, kpos), jnp.asarray(fill),
                                 window=window)
    got = ref.decode_attention(*_t(q, k, v, kpos), fill, window=window)
    assert_close(got, want)


def test_rows_that_see_no_key():
    """Query position 3 sees no key of ``kpos = [10, 11, ...]``, causal:
    every oracle gives such a row the uniform mean of ``v`` over its
    keys (the chunked one over the padded chunks, whose empty slots
    hold zeros), in the port as in the reference.  The CUDA kernel
    gives it the mean over the tiles it visits, which for a row alone
    in its block is none: zeros (``tests/test_torch_cuda.py``)."""
    q, k, v = _qkv(1, 2, 20, 2, 1, 16)
    qpos = np.array([3, 12], np.int32)
    kpos = np.arange(10, 30, dtype=np.int32)
    want = jref.attention(*_j(q, k, v, qpos, kpos))
    got = ref.attention(*_t(q, k, v, qpos, kpos))
    assert_close(got, want)
    assert_close(got[0, 0, 0], v[0].mean(0)[0])
    want_c = jref.attention_chunked(*_j(q, k, v, qpos, kpos), chunk=16)
    got_c = ref.attention_chunked(*_t(q, k, v, qpos, kpos), chunk=16)
    assert_close(got_c, want_c)
    assert_close(got_c[0, 0, 0], v[0].sum(0)[0] / 32)


def test_ops_refuses_cpu_tensors_for_the_kernel():
    tq, tk, tv = _t(*_qkv(1, 4, 4, 2, 1, 32))
    pos = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kflash.flash_attention(tq, tk, tv, pos, pos)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.attention(tq, tk, tv, pos, pos, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        ops.attention(tq, tk, tv, pos, pos, impl="pallas")


# (B, T, Hq, Hkv, D, window, fill, pieces): the CUDA decode_attention's
# order of work (pieces of whole tiles, partial scores summed over D in a
# fixed order, pieces merged in order) at g = 1, 4 and 16 (16: the
# tensor-core path's two halves of D), with a window, and at one piece
PIECE_CASES = [
    (2, 150, 4, 4, 64, 0, 120, 3),          # g = 1
    (2, 130, 8, 2, 32, 0, 130, 2),          # g = 4
    (1, 150, 16, 1, 32, 0, 140, 3),         # g = 16
    (2, 96, 8, 2, 64, 40, 96, 1),           # one piece, a window
    (1, 80, 16, 1, 64, 0, 80, 1),           # g = 16, one piece
]


@pytest.mark.parametrize("case", PIECE_CASES, ids=lambda c: "-".join(map(
    str, c)))
def test_decode_merge_order_model_matches_jax_and_pallas(case):
    B, T, Hq, Hkv, D, window, fill, pieces = case
    q, k, v = _qkv(B, 1, T, Hq, Hkv, D)
    q = q[:, 0]
    kpos = np.where(np.arange(T) < fill, np.arange(T), -1).astype(np.int32)
    tiles = -(-T // kdecode.TILE)
    ts = -(-tiles // pieces) * kdecode.TILE
    assert -(-T // ts) == pieces
    # runs of 16 heads take the tensor cores (the C plan; on the card
    # test_cuda_decode_attention_cases_cover_both_paths_and_plans)
    path = "tensor_cores" if Hq // Hkv == 16 else "cuda_cores"
    got = decode_attention_pieces(*_t(q, k, v, kpos),
                                  torch.tensor([fill - 1], dtype=torch.int32),
                                  ts=ts, path=path, window=window)
    assert_close(got, jref.decode_attention(*_j(q, k, v, kpos),
                                            jnp.asarray(fill - 1),
                                            window=window))
    assert_close(got, pl_decode(*_j(q, k, v, kpos), jnp.asarray(fill - 1),
                                window=window, block_k=16, interpret=True))


def test_decode_merge_order_model_gives_zeros_without_a_visible_key():
    """Every key in the query's future: the model, like the kernel and
    the Pallas kernel, gives zeros (``ref.decode_attention`` gives the
    mean of v)."""
    q, k, v = _qkv(2, 1, 70, 16, 1, 32)
    kpos = np.arange(70, dtype=np.int32) + 100
    got = decode_attention_pieces(*_t(q[:, 0], k, v, kpos),
                                  torch.tensor([50], dtype=torch.int32),
                                  ts=32, path="tensor_cores")
    assert torch.equal(got, torch.zeros_like(got))
    assert_close(got, pl_decode(*_j(q[:, 0], k, v, kpos), jnp.asarray(50),
                                block_k=16, interpret=True))


# (B, S, T, Hq, Hkv, D, Dv, causal, window[, "zero positions"]): the CUDA
# flash_attention's order of work (blocks of 128 query rows, warps of 16,
# key tiles of 64 or 32 at D = 192, tile skips, 3xTF32 products in stages
# of 32 of D, the last one 16 at D = 112) at D = 128, (192, 128) and
# zamba2's (112, 112), S and T off the tiles, a window, g = 1 and 4, and
# seamless's cross-attention (not causal, all-zero positions, T != S);
# the published Zamba2's (224, 224) in tiles of 16 keys
TILE_CASES = [
    (1, 150, 150, 4, 1, 128, 128, True, 0),       # g = 4, two q blocks
    (2, 70, 90, 2, 2, 192, 128, True, 0),         # MLA widths, S < T
    (1, 140, 140, 4, 4, 64, 64, True, 40),        # window, g = 1
    (1, 33, 70, 8, 2, 32, 32, False, 0),          # not causal
    (1, 200, 260, 2, 1, 16, 16, True, 24),        # window cuts k8 steps
    (1, 150, 150, 2, 2, 112, 112, True, 0),       # zamba2: D = 112, g = 1
    (2, 40, 100, 2, 2, 64, 64, False, 0, "zero positions"),   # cross
    (1, 150, 170, 2, 2, 224, 224, True, 0),       # Zamba2: 2 q blocks
    (1, 70, 90, 2, 1, 224, 224, False, 0),        # not causal, g = 2
]


@pytest.mark.parametrize("case", TILE_CASES, ids=lambda c: "-".join(map(
    str, c)))
def test_flash_tile_model_matches_jax_and_pallas(case):
    B, S, T, Hq, Hkv, D, Dv, causal, window = case[:9]
    q, k, _ = _qkv(B, S, T, Hq, Hkv, D)
    v = np.random.default_rng(1).standard_normal((B, T, Hkv, Dv)).astype(
        np.float32)
    qpos = np.arange(T - S, T, dtype=np.int32)
    kpos = np.arange(T, dtype=np.int32)
    if case[9:] == ("zero positions",):          # cross_apply's call
        qpos, kpos = np.zeros_like(qpos), np.zeros_like(kpos)
    got = flash_attention_tiles(*_t(q, k, v, qpos, kpos), causal=causal,
                                window=window)
    assert tuple(got.shape) == (B, S, Hq, Dv)
    assert_close(got, jref.attention(*_j(q, k, v, qpos, kpos),
                                     causal=causal, window=window))
    if Dv == D:                  # the Pallas kernel takes v of q's width
        assert_close(got, pl_flash(*_j(q, k, v, qpos, kpos), causal=causal,
                                   window=window, block_q=64, block_k=64,
                                   interpret=True))


def test_flash_stages_follow_the_kernel():
    """``Cfg::STG`` k8 steps a stage (32 of D, or all of a smaller D) and
    a short last stage of ``Cfg::TAIL`` k8 steps where 32 does not divide
    D: zamba2's 112 is 32, 32, 32, 16; every (D, Dv) the wrapper takes
    is covered without overlap."""
    assert flash_stages(112) == [(0, 32), (32, 32), (64, 32), (96, 16)]
    assert flash_stages(16) == [(0, 16)]
    assert flash_stages(192) == [(d, 32) for d in range(0, 192, 32)]
    for D, _ in kflash.HEAD_DIMS:
        cols = [c for d0, w in flash_stages(D) for c in range(d0, d0 + w)]
        assert cols == list(range(D)) and all(
            w % 8 == 0 for _, w in flash_stages(D))


def test_flash_tile_plan_fits_a_block():
    """``tile_plan`` is the source's ``Cfg``: every (D, Dv) the wrapper
    takes fits a block's shared memory in 128 query rows of 8 warps; at
    (224, 224) two slots of 32 keys would not (233,728 bytes), so the
    tiles take 16 keys."""
    for D, Dv in kflash.HEAD_DIMS:
        plan = kflash.tile_plan(D, Dv)
        assert plan["smem"] <= kflash.SMEM_MAX, (D, Dv)
        assert (plan["bq"], plan["warps"]) == (128, 8)
        assert plan["bk"] == (16 if (D, Dv) == (224, 224) else
                              32 if D > 128 else 64)
    plan = kflash.tile_plan(224, 224)
    assert (plan["bk"], plan["smem"]) == (16, 175232)
    slot = 32 * 2 * kflash.pad_ld(224) + 32
    assert 4 * (128 * kflash.pad_ld(224) + 2 * slot) == 233728 \
        > kflash.SMEM_MAX


def test_flash_tile_model_skips_what_no_row_of_a_warp_sees():
    """Keys in the future of the first warp's 16 rows and in the past of
    the second's: the first warp skips every tile, so its rows get zeros
    (the kernel's, ``tests/test_torch_cuda.py``); the second's match the
    oracle.  The oracles give the first rows the mean of v."""
    q, k, v = _qkv(1, 32, 64, 2, 1, 32)
    qpos = np.concatenate([np.arange(16), np.arange(100, 116)]).astype(
        np.int32)
    kpos = (np.arange(64) + 100).astype(np.int32)
    got = flash_attention_tiles(*_t(q, k, v, qpos, kpos))
    assert torch.equal(got[:, :16], torch.zeros_like(got[:, :16]))
    want = jref.attention(*_j(q, k, v, qpos, kpos))
    assert_close(got[:, 16:], np.asarray(want)[:, 16:])
    assert_close(np.asarray(want)[0, 0, 0], v[0].mean(0)[0])


@pytest.mark.parametrize("idx", [5, 15, 21])
def test_gqa_ring_write_by_device_index_equals_the_slice(idx):
    """A GQA decode step writes slot ``idx % M`` of a 16-slot ring by a
    device index: with ``idx`` a host int or a ``[1]`` tensor, before the
    ring is full, at its last slot and wrapped (a window ring), the K/V
    rings and ``cache_pos`` equal the sliced write it replaced, bitwise,
    and so does the attention over them.  The query's position is not
    the ring index."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import attention as attn
    from repro_torch.models.layers import apply_rope, linear

    cfg = get_config("qwen3-4b-reduced")
    B, M = 2, 16
    gen = torch.Generator().manual_seed(idx)
    p = attn.init_gqa(gen, cfg, torch.float32, "cpu")
    x = torch.randn((B, 1, cfg.d_model), generator=gen)
    positions = torch.full((1,), idx + 40, dtype=torch.int32)
    ring = {name: torch.randn((B, M, cfg.n_kv_heads, cfg.head_dim),
                              generator=gen) for name in ("k", "v")}
    pos = torch.arange(M, dtype=torch.int32) + 30

    q, k, v = attn._project_qkv(p, x, cfg, 1)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    slot = idx % M
    want = {name: t.clone() for name, t in ring.items()}
    want["k"][:, slot:slot + 1] = k
    want["v"][:, slot:slot + 1] = v
    want_pos = pos.clone()
    want_pos[slot:slot + 1] = positions
    out = ops.attention(q, want["k"], want["v"], positions, want_pos,
                        causal=True)
    want_out = linear(p["wo"], out.reshape(B, 1, -1))

    for cache_idx in (idx, torch.full((1,), idx, dtype=torch.int32)):
        got = {name: t.clone() for name, t in ring.items()}
        got_pos = pos.clone()
        got_out, new = attn.gqa_apply(p, x, positions, cfg, cache=got,
                                      cache_pos=got_pos,
                                      cache_idx=cache_idx)
        assert new is got
        for name in ("k", "v"):
            assert torch.equal(got[name], want[name]), name
        assert torch.equal(got_pos, want_pos)
        assert torch.equal(got_out, want_out)
