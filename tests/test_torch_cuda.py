"""The CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: each test skips without a CUDA card (decided inside the
fixture, never at import).  This file imports nothing of JAX, so it runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The conv cases are the ones ``tests/test_torch_kernels.py`` holds the
plain versions to against the JAX package, and the mamba short conv
(depthwise, K = 4, CAUSAL); the ``window_gather`` cases its scalar and
float4 paths, a wrap inside a float4, ``L = cap`` and ``L > cap``; the
``flash_attention`` cases cover causal and windowed prefill, ragged
``S``/``T``, every (D, Dv) instantiation with the materialized MLA
prefill (D = 192, Dv = 128), zamba2's (112, 112) and the published
Zamba2's (224, 224) in tiles of 16 keys, g = 3, several
query blocks, two passes of key-tile liveness and seamless's
cross-attention (not causal, all-zero positions, T != S), each also
bitwise repeatable; the
``decode_attention`` cases empty cache
slots, a partly filled ring, the rolled ring of a windowed decode, ``g``
in {1, 3, 4, 16, 48}, the materialized MLA step (192 / 128), the
absorbed one (576 / 512, v a strided view of k's rows), zamba2's step
(g = 1, D = 112), the published Zamba2's served step (8 sessions, g =
1, D = 224, a 4096-slot ring) and seamless's cross step; the ``ssd``
cases ragged S, an initial state, G in {1, 2} and the served tiles
(chunk 128, P = 64, N = 128 and zamba2's N = 64); the ``moe_gmm`` cases
C and f off the tiles, at most 16 rows an expert (the decode tile) and
more.  Each path
of the redesigned kernels has its own cases, each also repeat-equal: the
conv's depthwise path (stride 1 and 2, SAME and CAUSAL, B = 1 and 4, L
up to 7500) and tiled path (the ECG zoo's 1x1, stem and grouped shapes
at B = 1), both also equal to the direct path; ``moe_gmm``'s stream
(whole experts empty, some rows, all rows, C = 16, 24 and 64, an empty
expert whose weights hold NaN) and its tensor-core path (C, d and f off
its tiles).  The slot engine over the reduced zoo on the card: its tick
bitwise the flush at full and partial occupancy, within the tolerance
of a tick over the plain versions, and an aborted tick leaving the
state tensor's bytes.  Placement over 4 lanes of the card: flushes and
ticks bitwise the unsharded service's with the same launches, the
retire EWMAs from CUDA events, and a lane lost for good quarantined and
re-placed, bitwise after.  Training: every kernel wrapper refuses an
input that requires grad while grad is on, and runs (against its plain
version) with grad off; two ECG train steps on the card match the
CPU's with TF32 switched on for the process, and leave it on.
"""
import numpy as np
import pytest
import torch

import dataclasses

from repro_torch.configs.base import MLAConfig
from repro_torch.kernels import conv1d_stripe as kconv
from repro_torch.kernels import decode_attention as kdecode
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import moe_gmm as kgmm
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd as kssd
from repro_torch.configs.registry import get_config
from repro_torch.models import attention as attn
from repro_torch.models import transformer
from repro_torch.models.api import get_model
from repro_torch.models.runtime import RuntimeOptions
from repro_torch.kernels import window_gather as kgather
from repro_torch.testing import (SERVED_DECODE_PLANS, assert_bitwise,
                                 assert_close)

# (B, L, Cin, Cout, K, groups, stride, padding)
CONV_CASES = [
    (2, 40, 8, 8, 7, 8, 2, "SAME"),
    (2, 41, 16, 16, 7, 8, 1, "SAME"),
    (3, 40, 1, 8, 7, 1, 2, "SAME"),
    (2, 33, 1, 16, 7, 1, 2, "SAME"),
    (2, 20, 16, 8, 1, 1, 1, "SAME"),
    (2, 20, 8, 16, 1, 1, 2, "SAME"),
    (2, 30, 4, 4, 4, 4, 1, "CAUSAL"),
    (2, 30, 8, 8, 7, 8, 2, "CAUSAL"),
    (1, 5, 4, 6, 7, 2, 1, "SAME"),
    (2, 300, 640, 640, 4, 640, 1, "CAUSAL"),  # mamba short conv, depthwise
    (2, 129, 128, 128, 4, 128, 1, "CAUSAL"),
    (4, 7500, 1, 128, 7, 1, 2, "SAME"),      # full-width stem
    (4, 3750, 64, 64, 7, 8, 2, "SAME"),      # full-width stripe
]

# (N, C, cap, L, patients, ends, valid)
GATHER_CASES = [
    (3, 2, 12, 8, [2, 0, 1, 0], [5, 11, 2, 3], [5, 8, 8, 0]),
    (4, 3, 37, 16, [0, 3, 2, 1, 3], [40, 0, 33, 7, -5], [16, 0, 9, 7, 16]),
    (2, 7, 64, 30, [1, 0, 1], [63, 29, 10], [30, 1, 30]),
    (2, 3, 16384, 7500, [1, 0], [16000, 100], [7500, 4200]),
    # the redesign's paths: scalar (L % 4 != 0) and float4 stores, a wrap
    # inside a float4, several chunks a row, L = cap, L > cap, odd caps
    (3, 2, 50, 21, [2, 0, 1], [10, 49, 70], [21, 5, 0]),
    (2, 2, 37, 16, [1, 0], [51, 14], [16, 16]),
    (1, 2, 3000, 2100, [0], [1502], [2100]),
    (2, 3, 40, 40, [0, 1, 1], [7, 40, 0], [40, 13, 40]),
    (2, 2, 24, 40, [1, 0], [5, 30], [40, 25]),
    (2, 1, 10, 33, [0, 1], [3, -7], [33, 20]),
    (2, 3, 7501, 7500, [0, 1], [7000, 7501], [7500, 7499]),
]


def _conv_inputs(case, M, device, seed=0):
    B, L, Cin, Cout, K, groups, stride, padding = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, B, L, Cin)).astype(np.float32)
    w = (rng.standard_normal((M, K, Cin // groups, Cout))
         / np.sqrt(K * Cin // groups)).astype(np.float32)
    b = rng.standard_normal((M, Cout)).astype(np.float32)
    return (torch.from_numpy(a).to(device) for a in (x, w, b))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: "-".join(map(
    str, c)))
def test_cuda_conv_matches_plain(cuda_device, case):
    _, _, _, _, _, groups, stride, padding = case
    x, w, b = _conv_inputs(case, 3, cuda_device)
    got = kconv.conv1d_stripe_stacked(x, w, b, stride, groups, padding)
    assert_close(got, ref.conv1d_stripe_stacked(x, w, b, stride, groups,
                                                padding))
    got3 = kconv.conv1d_stripe(x[1], w[1], b[1], stride, groups, padding)
    assert_close(got3, ref.conv1d_stripe(x[1], w[1], b[1], stride, groups,
                                         padding))


@pytest.mark.cuda
@pytest.mark.parametrize("case", GATHER_CASES,
                         ids=lambda c: f"cap{c[2]}-L{c[3]}")
def test_cuda_window_gather_bitwise(cuda_device, case):
    N, C, cap, L, pts, ends, valid = case
    buf = torch.from_numpy(np.random.default_rng(cap).standard_normal(
        (N, C, cap)).astype(np.float32)).to(cuda_device)
    idx = [torch.tensor(a, dtype=torch.int32, device=cuda_device)
           for a in (pts, ends, valid)]
    before = kgather.launches.value
    assert_bitwise(kgather.window_gather(buf, *idx, L),
                   ref.window_gather(buf, *idx, L))
    assert kgather.launches.value == before + 1


@pytest.mark.cuda
def test_cuda_window_gather_checks_its_inputs(cuda_device):
    buf = torch.zeros((2, 3, 16), device=cuda_device)
    i = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    kgather.window_gather(buf, i, i, i, 8)             # the shape's plan
    with pytest.raises(ValueError, match="int32"):
        kgather.window_gather(buf, i.long(), i, i, 8)
    with pytest.raises(ValueError, match="float32"):
        kgather.window_gather(buf.double(), i, i, i, 8)
    with pytest.raises(ValueError, match="contiguous"):
        kgather.window_gather(buf.transpose(0, 1), i, i, i, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kgather.window_gather(buf, i.cpu(), i, i, 8)
    with pytest.raises(ValueError, match=r"\[2\] int32"):
        kgather.window_gather(buf, i, i[:1], i, 8)


# (B, L, C, K, stride, padding): depthwise (groups = C), the mamba short
# conv and the ECG stripes whose inner width is their cardinality, C off
# the float4 width included
DEPTHWISE_CASES = [
    (1, 7500, 8, 7, 2, "SAME"),
    (4, 7500, 8, 7, 1, "SAME"),
    (4, 2048, 128, 4, 1, "CAUSAL"),
    (1, 2048, 5120, 4, 1, "CAUSAL"),
    (1, 33, 12, 7, 2, "CAUSAL"),
    (4, 301, 6, 4, 2, "SAME"),
    (1, 15, 8, 7, 1, "SAME"),
]

# (L, Cin, Cout, K, groups, stride): B = 1 as the per-member oracle query
# calls them: 1x1 reduce/expand, the stem, grouped stripes cin_g 2, 4, 8
TILED_CASES = [
    (1875, 64, 128, 1, 1, 1),
    (3750, 128, 64, 1, 1, 1),
    (15, 128, 64, 1, 1, 1),
    (469, 8, 16, 1, 1, 1),
    (7500, 1, 128, 7, 1, 2),
    (7500, 1, 8, 7, 1, 2),
    (1875, 16, 16, 7, 8, 2),
    (938, 32, 32, 7, 8, 1),
    (3750, 64, 64, 7, 8, 2),
    (41, 16, 12, 7, 4, 1),                  # cout_g 3: groups split a quad
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", DEPTHWISE_CASES, ids=lambda c: "-".join(map(
    str, c)))
def test_cuda_conv_depthwise_path(cuda_device, case):
    """The depthwise path against the plain version, repeat-equal, and
    equal to the direct path (the same summation order)."""
    B, L, C, K, stride, padding = case
    x, w, b = _conv_inputs((B, L, C, C, K, C, stride, padding), 1,
                           cuda_device)
    x, w, b = x[0], w[0], b[0]
    assert kconv.path(x.shape, w.shape, stride, C, padding) == "depthwise"
    got = kconv.conv1d_stripe(x, w, b, stride, C, padding)
    assert_close(got, ref.conv1d_stripe(x, w, b, stride, C, padding))
    assert torch.equal(got, kconv.conv1d_stripe(x, w, b, stride, C,
                                                 padding))
    assert torch.equal(got, kconv.conv1d_stripe(x, w, b, stride, C, padding,
                                                 force_direct=True))


@pytest.mark.cuda
@pytest.mark.parametrize("case", TILED_CASES, ids=lambda c: "-".join(map(
    str, c)))
def test_cuda_conv_tiled_path_at_b1(cuda_device, case):
    """The tiled path at B = 1 (and stacked, M = 3) against the plain
    version, repeat-equal, and equal to the direct path."""
    L, Cin, Cout, K, groups, stride = case
    x, w, b = _conv_inputs((1, L, Cin, Cout, K, groups, stride, "SAME"), 3,
                           cuda_device)
    assert kconv.path(x[0].shape, w[0].shape, stride, groups) == "tiled"
    got = kconv.conv1d_stripe(x[0], w[0], b[0], stride, groups)
    assert_close(got, ref.conv1d_stripe(x[0], w[0], b[0], stride, groups))
    assert torch.equal(got, kconv.conv1d_stripe(x[0], w[0], b[0], stride,
                                                 groups))
    assert torch.equal(got, kconv.conv1d_stripe(x[0], w[0], b[0], stride,
                                                 groups, force_direct=True))
    got = kconv.conv1d_stripe_stacked(x, w, b, stride, groups)
    assert_close(got, ref.conv1d_stripe_stacked(x, w, b, stride, groups))
    assert torch.equal(got, kconv.conv1d_stripe_stacked(
        x, w, b, stride, groups, force_direct=True))


@pytest.mark.cuda
def test_cuda_conv_is_deterministic(cuda_device):
    x, w, b = _conv_inputs(CONV_CASES[-1], 3, cuda_device)
    first = kconv.conv1d_stripe_stacked(x, w, b, 2, 8)
    for _ in range(3):
        assert torch.equal(kconv.conv1d_stripe_stacked(x, w, b, 2, 8), first)


@pytest.mark.cuda
def test_cuda_wrappers_check_shapes_and_count_launches(cuda_device):
    x, w, b = _conv_inputs(CONV_CASES[0], 2, cuda_device)
    with pytest.raises(ValueError):
        kconv.conv1d_stripe_stacked(x, w[:1], b, 2, 8)
    with pytest.raises(ValueError):
        kconv.conv1d_stripe_stacked(x.transpose(2, 3), w, b, 2, 8)
    before = kconv.launches_stacked.value
    kconv.conv1d_stripe_stacked(x, w, b, 2, 8)
    assert kconv.launches_stacked.value == before + 1


# (B, S, T, Hq, Hkv, D, causal, window, fill, roll): kpos is arange(T)
# with slots >= fill empty (-1), rolled by `roll`; qpos the last S
# positions before max(fill, S)
ATTN_CASES = [
    (2, 64, 64, 4, 2, 32, True, 0, 64, 0),
    (1, 128, 128, 8, 8, 64, True, 16, 128, 0),      # window, g = 1
    (2, 48, 96, 4, 1, 32, True, 0, 96, 0),          # ragged T, MQA
    (1, 64, 64, 2, 2, 32, False, 0, 64, 0),         # not causal
    (1, 33, 70, 6, 3, 16, True, 24, 70, 0),         # ragged S and T
    (2, 130, 130, 8, 2, 128, True, 0, 130, 0),      # D = 128, g = 4
    (2, 70, 70, 4, 4, 192, True, 0, 70, 0),         # MLA: Dv = 128
    (1, 129, 129, 2, 2, 192, True, 48, 129, 0),     # MLA, window
    # the redesign: every (D, Dv) instantiation above ((16, 16) .. (192,
    # 128)); S and T off 16; a window edge and empty slots inside a k8
    # step; Hq = 15, g = 3; rows of several query blocks; the liveness
    # of more than one pass of 1024 key tiles, and a pass with none live
    (1, 37, 53, 4, 2, 32, True, 0, 53, 0),          # S, T off 16
    (1, 100, 100, 2, 1, 64, True, 13, 100, 0),      # window cuts k8 steps
    (1, 60, 77, 4, 4, 64, True, 0, 70, 5),          # empty slots, rolled
    (2, 100, 100, 15, 5, 64, True, 0, 100, 0),      # Hq = 15, g = 3
    (1, 300, 300, 4, 1, 128, True, 0, 300, 0),      # 3 query blocks, g = 4
    (1, 150, 170, 4, 2, 192, True, 0, 170, 0),      # MLA, ragged, g = 2
    (1, 64, 64, 2, 2, 32, False, 20, 64, 0),        # window, not causal
    (1, 40, 70000, 2, 1, 16, True, 0, 70000, 0),    # two passes
    (1, 40, 70000, 2, 1, 16, True, 3000, 70000, 0),  # first pass dead
    # zamba2's (112, 112): a short last stage of Q K^T, P V in passes of 7
    (2, 130, 130, 4, 4, 112, True, 0, 130, 0),      # g = 1, ragged
    (1, 300, 300, 4, 4, 112, True, 48, 300, 0),     # windowed
    (1, 100, 140, 6, 2, 112, False, 0, 140, 0),     # not causal, T != S
    # the published Zamba2's (224, 224): tiles of 16 keys (a lane of a
    # kpos pass past them reads none), 7 stages of Q K^T, P V in passes
    # of 7; S and T off the tiles
    (2, 150, 150, 4, 4, 224, True, 0, 150, 0),      # causal, 2 q blocks
    (1, 70, 101, 2, 2, 224, True, 0, 101, 0),       # S, T off the tiles
    (1, 100, 140, 4, 2, 224, False, 0, 140, 0),     # not causal, g = 2
    (1, 200, 200, 2, 2, 224, True, 48, 200, 0),     # windowed
    (1, 300, 300, 2, 2, 224, True, 0, 300, 0),      # 3 q blocks
    (1, 40, 17000, 2, 2, 224, True, 0, 17000, 0),   # two passes
]

# decode steps (S = 1), the same fields; the first four were the S = 1
# cases of the flash_attention launch that decode_attention replaces
DECODE_CASES = [
    (2, 1, 200, 12, 3, 128, True, 0, 150, 0),       # empty tail
    (1, 1, 77, 4, 4, 64, True, 0, 77, 0),           # g = 1
    (2, 1, 96, 15, 5, 64, True, 40, 96, 37),        # rolled ring
    (1, 1, 100, 16, 1, 32, True, 0, 90, 0),         # g = 16
    (2, 1, 300, 16, 16, 192, True, 0, 300, 0),      # MLA materialized
    (2, 1, 2081, 16, 16, 192, True, 0, 150, 0),     # partly filled ring
    (1, 1, 70, 48, 1, 64, True, 0, 70, 0),          # MQA, g = 48 > 16
    (2, 1, 33, 8, 2, 16, False, 0, 33, 0),          # not causal
    # the redesign's paths: tensor cores (runs of 16 heads) in one piece
    # and in several, with a window and two runs; CUDA cores at g = 16
    # when D is no multiple of 8; v of its own width on the tensor cores
    (1, 1, 100, 16, 1, 32, True, 0, 100, 0),        # 2 pieces, mma
    (2, 1, 300, 32, 2, 64, True, 100, 300, 0),      # window, 2 runs, mma
    (1, 1, 70, 16, 1, 20, True, 0, 70, 0),          # g = 16, CUDA cores
    (2, 1, 500, 16, 1, 192, True, 0, 480, 0),       # mma, Dv = 128
    (1, 1, 200, 4, 4, 32, True, 0, 190, 0),         # one piece, 6 slots
    # zamba2's step (g = 1, D = 112) and seamless's cross step (not
    # causal, T = 1024 frames)
    (4, 1, 2081, 32, 32, 112, True, 0, 2065, 0),
    (4, 1, 1024, 16, 16, 64, False, 0, 1024, 0),
    # the published Zamba2's served step: 8 sessions, g = 1, D = 224, a
    # 4096-slot ring filled to 3700
    (8, 1, 4096, 32, 32, 224, True, 0, 3700, 0),
]


def _dv(D):
    """v's width: 128 beside MLA's D = 192, else D."""
    return 128 if D == 192 else D


def attn_inputs(case, device, seed=0):
    B, S, T, Hq, Hkv, D, causal, window, fill, roll = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, _dv(D))).astype(np.float32)
    kpos = np.where(np.arange(T) < fill, np.arange(T), -1)
    kpos = np.roll(kpos, roll).astype(np.int32)
    end = max(fill, S)
    qpos = np.arange(end - S, end).astype(np.int32)
    return [torch.from_numpy(a).to(device) for a in (q, k, v, qpos, kpos)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "-".join(map(
    str, c)))
def test_cuda_flash_attention_matches_plain(cuda_device, case):
    causal, window = case[6], case[7]
    q, k, v, qpos, kpos = attn_inputs(case, cuda_device)
    assert bool(ref.visible(qpos, kpos, causal, window).any(1).all())
    got = kflash.flash_attention(q, k, v, qpos, kpos, causal=causal,
                                 window=window)
    torch.cuda.synchronize()
    assert_close(got, ref.attention(q, k, v, qpos, kpos, causal=causal,
                                    window=window))


@pytest.mark.cuda
def test_cuda_ops_attention_launches_the_kernel_only(cuda_device,
                                                     monkeypatch):
    def plain(*a, **kw):
        raise AssertionError("the plain version ran on a CUDA tensor")
    monkeypatch.setattr(ref, "attention", plain)
    monkeypatch.setattr(ref, "attention_chunked", plain)
    q, k, v, qpos, kpos = attn_inputs(ATTN_CASES[0], cuda_device)
    before = kflash.launches.value
    for chunk in (0, 16):
        ops.attention(q, k, v, qpos, kpos, chunk=chunk)
    assert kflash.launches.value == before + 2
    # one query token: decode_attention, qpos left on the card
    monkeypatch.setattr(ref, "decode_attention", plain)
    q, k, v, qpos, kpos = attn_inputs(DECODE_CASES[0], cuda_device)
    before = (kflash.launches.value, kdecode.launches.value)
    torch.cuda.set_sync_debug_mode("error")
    try:
        ops.attention(q, k, v, qpos, kpos)
        ops.decode_attention(q[:, 0], k, v, kpos, qpos)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert (kflash.launches.value, kdecode.launches.value) == \
        (before[0], before[1] + 2)


@pytest.mark.cuda
def test_cuda_flash_attention_checks_its_inputs(cuda_device):
    q, k, v, qpos, kpos = attn_inputs(ATTN_CASES[0], cuda_device)
    with pytest.raises(ValueError, match="int32"):
        kflash.flash_attention(q, k, v, qpos.long(), kpos)
    with pytest.raises(ValueError, match="divide"):
        kflash.flash_attention(q[:, :, :3].contiguous(), k, v, qpos, kpos)
    with pytest.raises(ValueError, match="contiguous"):
        kflash.flash_attention(q.transpose(1, 2), k, v, qpos, kpos)
    with pytest.raises(ValueError, match="CUDA"):
        kflash.flash_attention(q, k, v, qpos.cpu(), kpos)
    with pytest.raises(ValueError, match="head dims"):
        kflash.flash_attention(q, k, v[..., :16].contiguous(), qpos, kpos)
    with pytest.raises(ValueError, match="decode_attention"):
        kflash.flash_attention(q[:, :1].contiguous(), k, v, qpos[:1], kpos)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [ATTN_CASES[0], ATTN_CASES[6],
                                  ATTN_CASES[12], ATTN_CASES[15],
                                  ATTN_CASES[17], ATTN_CASES[19],
                                  ATTN_CASES[20], ATTN_CASES[21],
                                  ATTN_CASES[25]],
                         ids=lambda c: "-".join(map(str, c)))
def test_cuda_flash_attention_is_bitwise_repeatable(cuda_device, case):
    causal, window = case[6], case[7]
    q, k, v, qpos, kpos = attn_inputs(case, cuda_device)
    first = kflash.flash_attention(q, k, v, qpos, kpos, causal=causal,
                                   window=window)
    for _ in range(3):
        assert torch.equal(kflash.flash_attention(
            q, k, v, qpos, kpos, causal=causal, window=window), first)


@pytest.mark.cuda
def test_cuda_flash_attention_row_without_a_visible_key(cuda_device):
    """The kernel skips every tile that no row of its block, or of a
    warp's 16 rows, can see, so rows whose keys all lie in their future
    get zeros, also beside rows of the block that see keys; the plain
    version gives them the mean of v over all T
    (``tests/test_torch_attention.py::test_rows_that_see_no_key``,
    ``::test_flash_tile_model_skips_what_no_row_of_a_warp_sees``)."""
    q, k, v, qpos, kpos = attn_inputs(ATTN_CASES[0], cuda_device)
    kpos = kpos + 1000
    got = kflash.flash_attention(q, k, v, qpos, kpos)
    assert torch.equal(got, torch.zeros_like(got))
    assert_close(ref.attention(q, k, v, qpos, kpos)[0, 0, 0],
                 v[0, :, 0].mean(0))
    # the first warp's rows (0..15) see nothing, the second's see keys
    qpos = torch.cat([torch.arange(16), torch.arange(1000, 1048)]).to(
        torch.int32).to(cuda_device)
    got = kflash.flash_attention(q, k, v, qpos, kpos)
    assert torch.equal(got[:, :16], torch.zeros_like(got[:, :16]))
    assert_close(got[:, 16:], ref.attention(q, k, v, qpos, kpos)[:, 16:])


@pytest.mark.cuda
@pytest.mark.parametrize("S", [64, 1])
def test_cuda_cross_attention_shape(cuda_device, S):
    """seamless's cross-attention call (``attention.cross_apply``): not
    causal, all-zero positions, 16 heads of 64 over T = 1024 encoder
    frames; S = 64 (prefill) runs ``flash_attention``, S = 1 (a decode
    step) ``decode_attention``; bitwise repeatable."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(cuda_device) for shape in (
            (4, S, 16, 64), (4, 1024, 16, 64), (4, 1024, 16, 64)))
    qpos = torch.zeros(S, dtype=torch.int32, device=cuda_device)
    kpos = torch.zeros(1024, dtype=torch.int32, device=cuda_device)
    counter = kflash.launches if S > 1 else kdecode.launches
    before = counter.value
    got = ops.attention(q, k, v, qpos, kpos, causal=False)
    torch.cuda.synchronize()
    assert counter.value == before + 1
    assert_close(got, ref.attention(q, k, v, qpos, kpos, causal=False))
    assert torch.equal(got, ops.attention(q, k, v, qpos, kpos,
                                          causal=False))


@pytest.mark.cuda
@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: "-".join(map(
    str, c)))
def test_cuda_decode_attention_matches_plain(cuda_device, case):
    causal, window = case[6], case[7]
    q, k, v, qpos, kpos = attn_inputs(case, cuda_device)
    before = kdecode.launches.value
    got = kdecode.decode_attention(q[:, 0], k, v, kpos, qpos, window=window,
                                   causal=causal)
    torch.cuda.synchronize()
    assert kdecode.launches.value == before + 1
    assert_close(got, ref.attention(q, k, v, qpos, kpos, causal=causal,
                                    window=window)[:, 0])
    assert torch.equal(got, kdecode.decode_attention(          # fixed order
        q[:, 0], k, v, kpos, qpos, window=window, causal=causal))


@pytest.mark.cuda
def test_cuda_decode_attention_cases_cover_both_paths_and_plans(
        cuda_device):
    """Each of the kernel's paths runs in one piece (one launch, the
    output written by the split kernel) and in several (the combine),
    and the ring takes its shallowest and deepest depths."""
    seen, depths = set(), set()
    for case in DECODE_CASES:
        causal, window = case[6], case[7]
        q, k, v, qpos, kpos = attn_inputs(case, cuda_device)
        kdecode.decode_attention(q[:, 0], k, v, kpos, qpos, window=window,
                                 causal=causal)
        plan = kdecode.plan_of(q[:, 0], k, v, kpos, qpos, window=window,
                               causal=causal)
        seen.add((plan.path, plan.n_split > 1))
        depths.add(plan.slots)
    assert seen == {(p, m) for p in kdecode.PATHS for m in (False, True)}
    assert {2, kdecode.MAX_SLOTS} <= depths


@pytest.mark.cuda
@pytest.mark.parametrize("case", SERVED_DECODE_PLANS, ids=lambda c: c[0])
def test_cuda_decode_plan_at_the_served_shapes(cuda_device, case):
    """The kernel's own layout (the C plan) gives the served decode
    steps the paths, ring depths, blocks an SM and pieces of the CPU
    test's table, and its P @ V key groups are the wrapper's."""
    _, B_, Hkv, g, T, D, Dv, v_in_k, path, pieces, (slots, per_sm) = case
    got, smem, groups = kdecode.c_plan(g, D, Dv, v_in_k)
    assert got == path and kdecode.blocks_per_sm(smem) == per_sm
    assert groups == (1 if path == "tensor_cores" else kdecode.pv_groups(Dv))
    ts, n = kdecode.split_plan(B_, Hkv, g, T, 132, per_sm,
                               kdecode.MIN_PIECE_TILES[path])
    assert n == pieces
    depth = lambda s: (kdecode.c_plan(g, D, Dv, v_in_k, s, path)
                       or (0, None))[1]
    assert kdecode.ring_plan(depth, ts // 32) == (slots, per_sm)


@pytest.mark.cuda
def test_cuda_decode_plan_refuses_what_does_not_fit(cuda_device):
    """16 heads at 576 / 512 with v in rows of its own: two K/V tiles do
    not fit a block on either path, and the call is refused before any
    launch; the P @ V key groups agree with the wrapper's at every Dv."""
    assert kdecode.c_plan(16, 576, 512, False) is None
    q = torch.zeros((4, 16, 576), device=cuda_device)
    k = torch.zeros((4, 40, 1, 576), device=cuda_device)
    v = torch.zeros((4, 40, 1, 512), device=cuda_device)
    kpos = torch.arange(40, dtype=torch.int32, device=cuda_device)
    before = kdecode.launches.value
    with pytest.raises(ValueError, match="shared memory"):
        kdecode.decode_attention(q, k, v, kpos, 39)
    assert kdecode.launches.value == before
    for Dv in range(4, 513, 4):
        assert kdecode.c_plan(1, 64, Dv, False, 2, "cuda_cores")[2] == \
            kdecode.pv_groups(Dv)


@pytest.mark.cuda
@pytest.mark.parametrize("T,fill", [(2081, 2065), (300, 37)])
def test_cuda_decode_attention_absorbed_mla_step(cuda_device, T, fill):
    """The absorbed MLA step: 16 query heads on one KV head, D = 576 (the
    512 latent + 64 rope columns of a cache row) and v the first 512
    columns of the same rows, a strided view; and a scale of its own."""
    rng = np.random.default_rng(0)
    lat = torch.from_numpy(rng.standard_normal((2, T, 576)).astype(
        np.float32)).to(cuda_device)[:, :, None]
    q = torch.from_numpy(rng.standard_normal((2, 16, 576)).astype(
        np.float32)).to(cuda_device)
    kpos = torch.from_numpy(np.where(np.arange(T) < fill, np.arange(T),
                                     -1).astype(np.int32)).to(cuda_device)
    qpos = torch.tensor([fill - 1], dtype=torch.int32, device=cuda_device)
    v = lat[..., :512]
    assert v.data_ptr() == lat.data_ptr() and not v.is_contiguous()
    got = ops.decode_attention(q, lat, v, kpos, qpos, scale=192 ** -0.5)
    torch.cuda.synchronize()
    assert tuple(got.shape) == (2, 16, 512)
    assert_close(got, ref.decode_attention(q, lat, v.contiguous(), kpos,
                                           qpos, scale=192 ** -0.5))


@pytest.mark.cuda
def test_cuda_decode_attention_row_without_a_visible_key(cuda_device):
    """Every key of the ring lies in the query's future: zeros, as the
    Pallas kernel gives; the plain version gives the mean of v."""
    q, k, v, qpos, kpos = attn_inputs(DECODE_CASES[4], cuda_device)
    kpos = kpos + 1000
    got = ops.attention(q, k, v, qpos, kpos)
    torch.cuda.synchronize()
    assert torch.equal(got, torch.zeros_like(got))
    assert_close(ref.attention(q, k, v, qpos, kpos)[0, 0, 0],
                 v[0, :, 0].mean(0))


@pytest.mark.cuda
def test_cuda_decode_attention_checks_its_inputs(cuda_device):
    q, k, v, qpos, kpos = attn_inputs(DECODE_CASES[0], cuda_device)
    with pytest.raises(ValueError, match="int32"):
        kdecode.decode_attention(q[:, 0], k, v, kpos.long(), qpos)
    with pytest.raises(ValueError, match="divide"):
        kdecode.decode_attention(q[:, 0, :5].contiguous(), k, v, kpos, qpos)
    with pytest.raises(ValueError, match="rows"):
        kdecode.decode_attention(q[:, 0], k[..., ::2], v, kpos, qpos)
    with pytest.raises(ValueError, match="CUDA"):
        kdecode.decode_attention(q[:, 0], k, v, kpos, qpos.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("arch,window", [("qwen3-4b-reduced", 0),
                                         ("smollm-360m-reduced", 16)])
def test_cuda_lm_matches_plain_and_decode_never_syncs(cuda_device, arch,
                                                      window):
    """The LM on the card: prefill logits within the tolerance of the
    plain versions; a decode step issues no host sync (a sync would
    serialise launch and compute) and matches the teacher-forced
    forward within the reference's 2e-3."""
    cfg, rt = get_config(arch), RuntimeOptions(window=window)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = transformer.init_lm(gen, cfg, rt, cuda_device)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen,
                         device=cuda_device)
    before = kflash.launches.value
    lg, cache = transformer.prefill(params, toks[:, :38], cfg, rt,
                                    max_len=41)
    assert kflash.launches.value == before + cfg.num_layers
    plain, _ = transformer.prefill(params, toks[:, :38], cfg,
                                   RuntimeOptions(window=window,
                                                  impl="torch"), max_len=41)
    assert_close(lg, plain)
    full, _ = transformer.forward(params, toks, cfg, rt)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(2):
            lg, cache = transformer.decode_step(params, cache,
                                                toks[:, 38 + t], cfg, rt)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    np.testing.assert_allclose(lg.cpu().numpy(), full[:, 39].cpu().numpy(),
                               rtol=2e-3, atol=2e-3)


# (B, S, H, P, G, N, chunk, with h0)
SSD_CASES = [
    (1, 48, 4, 8, 1, 16, 16, False),
    (2, 45, 4, 16, 2, 16, 16, True),        # ragged S, G = 2, h0
    (1, 37, 3, 8, 1, 16, 32, True),         # chunk > S
    (2, 300, 4, 64, 1, 128, 128, True),     # the served tile, ragged S
    (1, 256, 6, 64, 2, 128, 128, False),
    (1, 70, 2, 6, 1, 10, 32, True),         # P, N off 4: 4-byte copies
    (2, 200, 4, 64, 2, 128, 64, True),      # served P, N at chunk 64
    (2, 300, 4, 64, 1, 64, 128, True),      # zamba2's N = 64
]


def ssd_inputs(case, device, seed=0):
    B, S, H, P, G, N, _, with_h0 = case
    rng = np.random.default_rng(seed)
    f32 = np.float32
    arrs = [rng.standard_normal((B, S, H, P)).astype(f32),
            np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(f32),
            (-np.exp(rng.standard_normal(H))).astype(f32),
            rng.standard_normal((B, S, G, N)).astype(f32),
            rng.standard_normal((B, S, G, N)).astype(f32),
            rng.standard_normal(H).astype(f32)]
    arrs.append(rng.standard_normal((B, H, P, N)).astype(f32)
                if with_h0 else None)
    return [None if a is None else torch.from_numpy(a).to(device)
            for a in arrs]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_CASES, ids=lambda c: "-".join(map(
    str, c)))
def test_cuda_ssd_matches_plain(cuda_device, case):
    x, dt, A, Bm, Cm, D, h0 = ssd_inputs(case, cuda_device)
    before = kssd.launches.value
    y, hT = kssd.ssd(x, dt, A, Bm, Cm, D, case[6], h0)
    torch.cuda.synchronize()
    assert kssd.launches.value == before + 1
    yr, hr = ref.ssd_chunked(x, dt, A, Bm, Cm, D, case[6], h0)
    assert_close(y, yr, "y")
    assert_close(hT, hr, "hT")
    y2, h2 = kssd.ssd(x, dt, A, Bm, Cm, D, case[6], h0)
    assert torch.equal(y, y2) and torch.equal(hT, h2)     # deterministic


# (E, C, d, f)
GMM_CASES = [(4, 64, 32, 48), (3, 37, 24, 50), (2, 5, 16, 33),
             (16, 16, 256, 200), (4, 130, 128, 320), (1, 1, 8, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", GMM_CASES, ids=lambda c: "-".join(map(
    str, c)))
def test_cuda_moe_gmm_matches_plain(cuda_device, case):
    E, C, d, f = case
    rng = np.random.default_rng(0)
    x, wg, wu, wd = (torch.from_numpy(a.astype(np.float32)).to(cuda_device)
                     for a in (rng.standard_normal((E, C, d)),
                               rng.standard_normal((E, d, f)) / d ** 0.5,
                               rng.standard_normal((E, d, f)) / d ** 0.5,
                               rng.standard_normal((E, f, d)) / f ** 0.5))
    before = kgmm.launches.value
    got = kgmm.moe_gmm(x, wg, wu, wd)
    torch.cuda.synchronize()
    assert kgmm.launches.value == before + 1
    assert_close(got, ref.moe_gmm(x, wg, wu, wd))
    assert torch.equal(got, kgmm.moe_gmm(x, wg, wu, wd))
    with pytest.raises(ValueError, match="match"):
        kgmm.moe_gmm(x, wg, wu, wd[:, :, :-1].contiguous())


def _gmm_weights(E, d, f, device, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in (
        rng.standard_normal((E, d, f)) / d ** 0.5,
        rng.standard_normal((E, d, f)) / d ** 0.5,
        rng.standard_normal((E, f, d)) / f ** 0.5)]


# (label, E, C, d, f, empty experts, rows filled an occupied expert):
# the streaming path (C <= 64); d and f off 4 take its 4-byte copies
STREAM_CASES = [
    ("whole experts empty", 8, 16, 256, 200, (0, 2, 3, 6), None),
    ("some rows", 6, 24, 128, 96, (), (0, 5, 23)),
    ("one row each", 16, 16, 512, 640, (1, 4), (7,)),
    ("all rows C=16", 4, 16, 256, 320, (), None),
    ("all rows C=24", 4, 24, 192, 136, (), None),
    ("all rows C=64", 2, 64, 128, 72, (), None),
    ("d and f off 4", 3, 24, 24, 50, (1,), (2, 3, 17)),
    ("every expert empty", 4, 16, 64, 32, (0, 1, 2, 3), None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", STREAM_CASES, ids=lambda c: c[0])
def test_cuda_moe_gmm_stream_path(cuda_device, case):
    _, E, C, d, f, empty, filled = case
    assert kgmm.path(C) == "stream"
    rng = np.random.default_rng(1)
    x = rng.standard_normal((E, C, d)).astype(np.float32)
    if filled is not None:
        keep = np.zeros(C, bool)
        keep[list(filled)] = True
        x[:, ~keep] = 0.0
    x[list(empty)] = 0.0
    x = torch.from_numpy(x).to(cuda_device)
    wg, wu, wd = _gmm_weights(E, d, f, cuda_device)
    before = kgmm.launches.value
    got = kgmm.moe_gmm(x, wg, wu, wd)
    torch.cuda.synchronize()
    assert kgmm.launches.value == before + 1
    assert_close(got, ref.moe_gmm(x, wg, wu, wd))
    empty_rows = ~(x != 0).any(-1)
    if bool(empty_rows.any()):
        assert float(got[empty_rows].abs().max()) == 0.0
    assert torch.equal(got, kgmm.moe_gmm(x, wg, wu, wd))


@pytest.mark.cuda
def test_cuda_moe_gmm_empty_expert_with_nan_weights_gives_zeros(
        cuda_device):
    """A difference by design: an expert that holds no token reads no
    weight, so its rows come back zero where the plain version gives
    NaN (``tests/test_torch_precision.py`` models the same)."""
    E, C, d, f = 4, 16, 128, 96
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (E, C, d)).astype(np.float32)).to(cuda_device)
    x[1] = 0.0
    wg, wu, wd = _gmm_weights(E, d, f, cuda_device)
    for w in (wg, wu, wd):
        w[1] = float("nan")
    got = kgmm.moe_gmm(x, wg, wu, wd)
    plain = ref.moe_gmm(x, wg, wu, wd)
    assert bool(torch.isnan(plain[1]).all())
    assert float(got[1].abs().max()) == 0.0
    assert_close(got[[0, 2, 3]], plain[[0, 2, 3]])
    assert torch.equal(got, kgmm.moe_gmm(x, wg, wu, wd))


# (E, C, d, f): the tensor-core path (C > 64) with C, d and f off its
# 128-row, 64/128-column and 32-deep tiles (d, f off 4: 4-byte copies),
# and the served contractions (d = 4096, f = 6400): a sum kept in the
# tensor cores' accumulator over all of K drifts beyond 1e-4 there
TC_CASES = [(2, 130, 72, 200), (2, 100, 24, 50), (1, 300, 136, 520),
            (3, 65, 260, 33), (1, 257, 1000, 100), (1, 200, 4096, 640),
            (1, 96, 512, 6400)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", TC_CASES, ids=lambda c: "-".join(map(
    str, c)))
def test_cuda_moe_gmm_tensor_core_path(cuda_device, case):
    E, C, d, f = case
    assert kgmm.path(C) == "tensor_cores"
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (E, C, d)).astype(np.float32)).to(cuda_device)
    wg, wu, wd = _gmm_weights(E, d, f, cuda_device)
    got = kgmm.moe_gmm(x, wg, wu, wd)
    torch.cuda.synchronize()
    assert_close(got, ref.moe_gmm(x, wg, wu, wd))
    assert torch.equal(got, kgmm.moe_gmm(x, wg, wu, wd))


@pytest.mark.cuda
def test_cuda_ops_ssd_and_moe_gmm_launch_the_kernels_only(cuda_device,
                                                          monkeypatch):
    def plain(*a, **kw):
        raise AssertionError("the plain version ran on a CUDA tensor")
    monkeypatch.setattr(ref, "ssd_chunked", plain)
    monkeypatch.setattr(ref, "moe_gmm", plain)
    x, dt, A, Bm, Cm, D, h0 = ssd_inputs(SSD_CASES[1], cuda_device)
    before = kssd.launches.value
    ops.ssd(x, dt, A, Bm, Cm, D, 16, h0)
    assert kssd.launches.value == before + 1
    w = torch.zeros(2, 8, 4, device=cuda_device)
    before = kgmm.launches.value
    ops.moe_gmm(torch.zeros(2, 3, 8, device=cuda_device), w, w,
                torch.zeros(2, 4, 8, device=cuda_device))
    assert kgmm.launches.value == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-2.7b-reduced",
                                  "phi3.5-moe-42b-a6.6b-reduced"])
def test_cuda_ssm_and_moe_lm_match_plain(cuda_device, arch):
    """The mamba and MoE LMs on the card: prefill logits within the
    tolerance of the plain versions, through the expected kernels; the
    cached decode against the teacher-forced forward (2e-3) at a
    capacity that drops nothing; a mamba decode step launches no kernel
    and issues no host sync."""
    cfg = get_config(arch)
    cf = cfg.moe.n_routed_experts / cfg.moe.top_k if cfg.moe else 1.25
    rt = RuntimeOptions(capacity_factor=cf)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = transformer.init_lm(gen, cfg, rt, cuda_device)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen,
                         device=cuda_device)
    counters = (kssd.launches, kgmm.launches, kflash.launches,
                kconv.launches)
    before = [c.value for c in counters]
    lg, cache = transformer.prefill(params, toks[:, :38], cfg, rt,
                                    max_len=41)
    got = [c.value - b for c, b in zip(counters, before)]
    L = cfg.num_layers
    assert got == ([L, 0, 0, 3 * L] if cfg.ssm else [0, L, L, 0]), got
    plain, _ = transformer.prefill(
        params, toks[:, :38], cfg,
        RuntimeOptions(capacity_factor=cf, impl="torch"), max_len=41)
    assert_close(lg, plain)
    full, _ = transformer.forward(params, toks, cfg, rt)
    before = [c.value for c in counters]
    if cfg.ssm:
        torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(2):
            lg, cache = transformer.decode_step(params, cache,
                                                toks[:, 38 + t], cfg, rt)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if cfg.ssm:
        assert [c.value for c in counters] == before   # decode: no kernel
    np.testing.assert_allclose(lg.cpu().numpy(), full[:, 39].cpu().numpy(),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["zamba2-7b-reduced",
                                  "seamless-m4t-medium-reduced"])
def test_cuda_hybrid_and_encdec_match_plain(cuda_device, arch):
    """The hybrid (5 layers, the shared block every 2: two invocations
    and a tail layer) and the enc-dec on the card: prefill logits within
    the tolerance of the plain versions, through exactly the expected
    kernels; a decode step issues no host sync and launches the
    expected ``decode_attention``s; cached decode against the
    teacher-forced forward (2e-3)."""
    cfg = get_config(arch)
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, num_layers=5, shared_attn_every=2)
    rt = RuntimeOptions()
    m = get_model(cfg)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = m.init(gen, cfg, rt, cuda_device)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen,
                         device=cuda_device)
    pe = None
    if cfg.family == "encdec":
        pe = torch.randn((2, cfg.n_prefix_tokens, cfg.frontend_dim),
                         generator=gen, device=cuda_device)
    counters = (kflash.launches, kdecode.launches, kssd.launches,
                kconv.launches)
    before = [c.value for c in counters]
    lg, cache = m.prefill(params, toks[:, :38], cfg, rt, prefix_embeds=pe,
                          max_len=41)
    got = [c.value - b for c, b in zip(counters, before)]
    if cfg.family == "hybrid":
        want, per_step = [2, 0, 5, 15], 2
    else:
        want, per_step = [cfg.enc_layers + 2 * cfg.dec_layers, 0, 0, 0], \
            2 * cfg.dec_layers
    assert got == want, got
    plain, _ = m.prefill(params, toks[:, :38], cfg,
                         RuntimeOptions(impl="torch"), prefix_embeds=pe,
                         max_len=41)
    assert_close(lg, plain)
    full, _ = m.forward(params, toks, cfg, rt, prefix_embeds=pe)
    before = kdecode.launches.value
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(2):
            lg, cache = m.decode_step(params, cache, toks[:, 38 + t], cfg,
                                      rt)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert kdecode.launches.value == before + 2 * per_step
    np.testing.assert_allclose(lg.cpu().numpy(), full[:, 39].cpu().numpy(),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.cuda
def test_cuda_published_zamba2_matches_plain(cuda_device):
    """The published Zamba2 (reduced widths, 2 heads of 224 over the
    concatenated 512-wide input, 3 layers with both shared blocks
    invoked) on the card: prefill into batch rows of a preallocated
    cache through exactly 2 ``flash_attention`` (224, 224), 3 ``ssd``
    and 9 ``conv1d_stripe``, within the tolerance of the plain
    versions; a decode step issues no host sync and launches 2
    ``decode_attention``s; cached decode against the teacher-forced
    forward (2e-3, as ``test_cuda_hybrid_and_encdec_match_plain``)."""
    cfg = dataclasses.replace(get_config("zamba2-7b-instruct-reduced"),
                              n_heads=2, n_kv_heads=2, head_dim=224)
    rt = RuntimeOptions()
    m = get_model(cfg)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = m.init(gen, cfg, rt, cuda_device)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen,
                         device=cuda_device)
    counters = (kflash.launches, kdecode.launches, kssd.launches,
                kconv.launches)
    before = [c.value for c in counters]
    cache = m.init_cache(cfg, rt, 2, 41, cuda_device)
    for r in range(2):
        lg, cache = m.prefill(params, toks[r:r + 1, :38], cfg, rt,
                              cache=cache, rows=slice(r, r + 1))
        plain, _ = m.prefill(params, toks[r:r + 1, :38], cfg,
                             RuntimeOptions(impl="torch"), max_len=41)
        assert_close(lg, plain)
    got = [c.value - b for c, b in zip(counters, before)]
    assert got == [4, 0, 6, 18], got
    full, _ = m.forward(params, toks, cfg, rt)
    before = kdecode.launches.value
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(2):
            lg, cache = m.decode_step(params, cache, toks[:, 38 + t], cfg,
                                      rt)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert kdecode.launches.value == before + 4
    np.testing.assert_allclose(lg.cpu().numpy(), full[:, 39].cpu().numpy(),
                               rtol=2e-3, atol=2e-3)


def _clone_cache(cache):
    """Every tensor of a Zamba2 cache copied, and its ``idx``."""
    return {"mamba": {k: v.clone() for k, v in cache["mamba"].items()},
            "attn": {k: v.clone() for k, v in cache["attn"].items()},
            "pos": cache["pos"].clone(),
            "position": cache["position"].clone(), "idx": cache["idx"]}


def _assert_same_cache(got, want, when):
    for k in want["mamba"]:
        assert_bitwise(got["mamba"][k], want["mamba"][k], f"{when} {k}")
    for k in ("k", "v"):
        assert_bitwise(got["attn"][k], want["attn"][k], f"{when} {k}")
    assert_bitwise(got["pos"], want["pos"], f"{when} pos")
    assert_bitwise(got["position"], want["position"], f"{when} position")
    assert got["idx"] == want["idx"] == int(want["position"][0]), when


@pytest.mark.cuda
def test_cuda_published_zamba2_step_graphs_are_bitwise_the_eager_step(
        cuda_device):
    """The published Zamba2 at its published widths, cut to 5 layers
    with both shared blocks invoked (before layers 1 and 3: 3 Mamba
    runs, 2 invocations, 8 leaf spans a step): 8 sessions prefilled into
    an ``init_cache``, then 6 steps from that state twice, through
    ``decode_step`` (the first step eager, the second captures one CUDA
    graph a leaf span, every step from the second replays them) and
    through the eager step alone.  Every step's logits and next tokens
    and, after the steps, every cache leaf are bitwise equal; the step
    trees count ``graph_replays`` 0, then 8 (the leaf spans), and the
    same ``launches`` as the eager step (one ``decode_attention`` an
    invocation).  A second prefill into rows of the same caches, then 3
    more steps: the graphs replay on, still bitwise the eager step, and
    a replayed step issues no host sync."""
    from repro_torch.launch.serve import greedy_step
    from repro_torch.models import zamba2
    from repro_torch.obs.spans import collect

    cfg = dataclasses.replace(get_config("zamba2-7b-instruct"),
                              num_layers=5, hybrid_layer_ids=(1, 3))
    rt = RuntimeOptions()
    m = get_model(cfg)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = m.init(gen, cfg, rt, cuda_device)
    B, S = 8, 64
    toks = torch.randint(0, cfg.vocab_size, (2, B, S), generator=gen,
                         device=cuda_device)
    graphed = m.init_cache(cfg, rt, B, S + 16, cuda_device)
    lg, graphed = m.prefill(params, toks[0], cfg, rt, cache=graphed,
                            rows=slice(0, B))
    eager = _clone_cache(graphed)
    tok_g = tok_e = torch.argmax(lg, -1).to(torch.int32)
    leaves = 3 + 2 * 2 + 1

    def steps(n, first):
        nonlocal tok_g, tok_e
        for i in range(n):
            trees = []
            if first + i > 2:           # a replay, captured before
                torch.cuda.set_sync_debug_mode("error")
            try:
                lg_g, tok_g, _ = greedy_step(m, params, graphed, tok_g, cfg,
                                             rt, trees=trees)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            n0 = kdecode.launches.value
            with collect("lm.step", eager["idx"]) as tree:
                lg_e, _ = zamba2._eager_step(params, eager, tok_e, cfg, rt)
            launched = kdecode.launches.value - n0
            tok_e = torch.argmax(lg_e, -1).to(torch.int32)
            step = f"step {first + i}"
            assert_bitwise(lg_g, lg_e, step)
            assert_bitwise(tok_g, tok_e, step)
            got = trees[0].counts
            assert got["graph_replays"] == (0 if first + i == 1 else leaves)
            assert got["launches"] == launched == 2, step
            assert got["kv_positions"] == tree.counts["kv_positions"]

    steps(6, 1)
    _assert_same_cache(graphed, eager, "after 6 steps")
    graphs = graphed["graphs"]
    assert len(graphs.graphs) == leaves
    for cache in (graphed, eager):
        _, cache = m.prefill(params, toks[1, :4], cfg, rt, cache=cache,
                             rows=slice(0, 4))
    _assert_same_cache(graphed, eager, "after the second prefill")
    steps(3, 7)
    _assert_same_cache(graphed, eager, "after 3 more steps")
    assert graphed["graphs"] is graphs


@pytest.mark.cuda
@pytest.mark.parametrize("absorbed", [False, True])
def test_cuda_mla_lm_matches_plain_and_decode_never_syncs(cuda_device,
                                                          absorbed):
    """deepseek-v2-lite-16b-reduced with the full model's MLA widths
    (kv_lora 512, qk 128 + 64, v 128): prefill (materialized: through
    ``flash_attention`` at (192, 128)) within the tolerance of the plain
    versions; decode
    steps, materialized (192 / 128, g = 1) or absorbed (576 / 512, one
    KV head), through ``decode_attention`` once a layer, against the
    teacher-forced forward (2e-3) at a capacity that drops nothing; an
    MLA decode step issues no host sync."""
    cfg = dataclasses.replace(
        get_config("deepseek-v2-lite-16b-reduced"), head_dim=192,
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0, qk_nope_head_dim=128,
                      qk_rope_head_dim=64, v_head_dim=128))
    rt = RuntimeOptions(capacity_factor=cfg.moe.n_routed_experts
                        / cfg.moe.top_k, absorbed_mla=absorbed)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = transformer.init_lm(gen, cfg, rt, cuda_device)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen,
                         device=cuda_device)
    L = cfg.num_layers
    before = (kflash.launches.value, kdecode.launches.value)
    lg, cache = transformer.prefill(params, toks[:, :38], cfg, rt,
                                    max_len=41)
    # the absorbed form's full sequence is plain einsums, as the
    # reference's: no kernel there
    assert (kflash.launches.value, kdecode.launches.value) == \
        (before[0] + (0 if absorbed else L), before[1])
    plain, _ = transformer.prefill(params, toks[:, :38], cfg,
                                   dataclasses.replace(rt, impl="torch"),
                                   max_len=41)
    assert_close(lg, plain)
    full, _ = transformer.forward(params, toks, cfg, rt)
    before = kdecode.launches.value
    for t in range(2):
        lg, cache = transformer.decode_step(params, cache, toks[:, 38 + t],
                                            cfg, rt)
    assert kdecode.launches.value == before + 2 * L
    np.testing.assert_allclose(lg.cpu().numpy(), full[:, 39].cpu().numpy(),
                               rtol=2e-3, atol=2e-3)
    # one more MLA step of layer 0 on its own (the MoE routing around it
    # is not held to this)
    p0 = transformer._layer(params["segments"][0], 0)["attn"]
    c0 = transformer._layer(cache["segments"][0], 0)
    h = torch.randn((2, 1, cfg.d_model), generator=gen, device=cuda_device)
    pos = torch.full((1,), cache["idx"], dtype=torch.int32,
                     device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, _ = attn.mla_apply(p0, h, pos, cfg, cache=c0,
                              cache_pos=cache["pos"],
                              cache_idx=cache["idx"], absorbed=absorbed)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(y).all())


# ---------------------------------------------------- the slot engine
def _slot_census(device, impl=None, beds=64):
    """The reduced zoo (12 members, 1-s windows) with a vitals forest
    and a labs model behind a slot engine over ``beds`` beds, one
    closed window each (ECG and vitals)."""
    from repro_torch.configs.ecg_zoo import zoo_specs
    from repro_torch.models.ecg_resnext import init_ecg
    from repro_torch.models.tabular import LogisticRegression, VitalsForest
    from repro_torch.serving import aggregator as ta
    from repro_torch.serving import pipeline as tp
    from repro_torch.serving.slots import SlotEngine

    rng = np.random.default_rng(0)
    y = rng.integers(0, 2, 40)
    vit = VitalsForest(7, n_trees=4).fit(rng.standard_normal((40, 7, 1)), y)
    labs = LogisticRegression(steps=50).fit(rng.standard_normal((40, 8)), y)
    members = [tp.ZooMember(s, init_ecg(s, torch.Generator().manual_seed(i)))
               for i, s in enumerate(zoo_specs(reduced=True, input_len=250))]
    svc = tp.EnsembleService(members, vitals_model=vit, labs_model=labs,
                             impl=impl, device=device)
    di = ta.DeviceIngest([ta.ModalitySpec("ecg", 250.0, 3),
                          ta.ModalitySpec("vitals", 1.0, 7)], beds, 1.0,
                         device=device)
    refs = []
    for p in range(beds):
        di.ingest(0.0, p, "ecg",
                  rng.standard_normal((3, 250)).astype(np.float32))
        di.ingest(0.0, p, "vitals",
                  rng.standard_normal((7, 1)).astype(np.float32))
        refs.append(di.close_window(p, 1.0, extra={
            "labs": rng.standard_normal(8).astype(np.float32)}))
    return svc, di, SlotEngine(svc, di), refs


@pytest.mark.cuda
def test_cuda_slot_tick_equals_flush_bitwise(cuda_device):
    """With the CUDA kernels: the tick's reads are bitwise the flush of
    the same refs at 64 of 64 slots and at 40 of 64 (other rows, the
    same rung); the tick launches the gathers and the stacked convs,
    the reads launch nothing."""
    svc, di, eng, refs = _slot_census(cuda_device)
    for r in refs:
        eng.update(r)
    before = (kgather.launches.value, kconv.launches_stacked.value)
    rep = eng.tick()
    assert rep.n_scored == 64 and rep.spad == 64
    assert kgather.launches.value == before[0] + 2
    assert kconv.launches_stacked.value > before[1]
    before = (kgather.launches.value, kconv.launches_stacked.value)
    got = np.array([eng.read(p) for p in range(64)])
    assert (kgather.launches.value, kconv.launches_stacked.value) == before
    assert_bitwise(got, np.array(svc.predict_batch(refs)), "64 of 64")
    keep = sorted(np.random.default_rng(1).choice(64, 40, replace=False))
    for p in sorted(set(range(64)) - set(keep)):
        eng.discharge(p)
    eng.tick()
    assert_bitwise(np.array([eng.read(p) for p in keep]),
                   np.array(svc.predict_batch([refs[p] for p in keep])),
                   "40 of 64")


@pytest.mark.cuda
def test_cuda_slot_tick_matches_plain_versions(cuda_device):
    svc, di, eng, refs = _slot_census(cuda_device)
    plain_svc, _, _, _ = _slot_census(cuda_device, impl="torch", beds=1)
    from repro_torch.serving.slots import SlotEngine
    peng = SlotEngine(plain_svc, di)
    for r in refs:
        eng.update(r)
        peng.update(r)
    eng.tick()
    peng.tick()
    assert_close(np.array([eng.read(p) for p in range(64)]),
                 np.array([peng.read(p) for p in range(64)]))


@pytest.mark.cuda
def test_cuda_slot_aborted_tick_leaves_the_state_bytes(cuda_device):
    from repro_torch.control.faults import (DeviceLostError, FaultEvent,
                                            FaultPlane)
    svc, di, eng, refs = _slot_census(cuda_device, beds=8)
    for r in refs:
        eng.update(r)
    eng.tick()
    state = [g.state.cpu().numpy().tobytes() for g in eng.groups]
    reads = np.array([eng.read(p) for p in range(8)])
    now = [0.0]
    plane = FaultPlane([FaultEvent(1.0, "device_loss", target=0,
                                   duration=1.0)], clock=lambda: now[0])
    plane.arm()
    assert plane.devices[0].device == cuda_device     # lane 0 of the card
    calls = []

    def guard(device):
        calls.append(device)
        if len(calls) == svc.n_buckets + 1:
            now[0] = 1.5                   # lost before the last pass
        plane.guard(device)

    svc.dispatch_guard = guard
    for r in refs:
        eng.update(r)
    with pytest.raises(DeviceLostError):
        eng.tick()
    assert [g.state.cpu().numpy().tobytes() for g in eng.groups] == state
    assert_bitwise(np.array([eng.read(p) for p in range(8)]), reads,
                   "stale, never wrong")
    now[0] = 3.0                           # restored
    rep = eng.tick()
    assert len(rep.stamped) == 8
    assert_bitwise(np.array([eng.read(p) for p in range(8)]), reads,
                   "the same windows again")


# ------------------------------------------------ placement over lanes
def _placed(device, n_lanes=4):
    """The reduced zoo's unsharded service and the same zoo over
    ``n_lanes`` lanes of the card (an LPT plan over fixed costs)."""
    from repro_torch.device import lanes
    svc, di, _, refs = _slot_census(device)
    pl = svc.plan_placement(n_lanes, bucket_costs=[0.4, 0.3, 0.2, 0.1])
    sharded = type(svc)(svc.members, vitals_model=svc.vitals_model,
                        labs_model=svc.labs_model, placement=pl,
                        devices=lanes(n_lanes, device))
    return svc, sharded, di, refs


@pytest.mark.cuda
def test_cuda_sharded_flush_equals_unsharded_over_lanes(cuda_device):
    """Four lanes of one card: every shard's params on the card, the
    refs and host-pack flushes bitwise the unsharded ones with the same
    launches, and one host copy of the pack (one card)."""
    svc, sharded, di, refs = _placed(cuda_device)
    assert all(b.tdev == cuda_device for b in sharded._buckets)
    assert len({b.device for b in sharded._buckets}) == 4
    for P in (8, 64):
        counts = []
        outs = []
        for s_ in (svc, sharded):
            before = (kgather.launches.value, kconv.launches_stacked.value)
            outs.append(np.array(s_.predict_batch(refs[:P])))
            counts.append((kgather.launches.value - before[0],
                           kconv.launches_stacked.value - before[1]))
        assert counts[0] == counts[1] and counts[0][1] > 0
        assert_bitwise(outs[1], outs[0], f"refs P={P}")
    wins = [{"ecg": r.host_window("ecg")} for r in refs[:8]]
    h0 = (svc.h2d_bytes, sharded.h2d_bytes)
    assert_bitwise(np.array(sharded.predict_batch(wins)),
                   np.array(svc.predict_batch(wins)), "host packs")
    assert sharded.h2d_bytes - h0[1] == svc.h2d_bytes - h0[0]


@pytest.mark.cuda
def test_cuda_sharded_tick_and_retire_clock(cuda_device):
    """The slot engine over four lanes of the card: four groups, the
    tick bitwise the unsharded tick; the flush's retire EWMAs come from
    CUDA events and a stall at one lane's guard drifts its shards."""
    import time
    from repro_torch.serving.slots import SlotEngine
    svc, sharded, di, refs = _placed(cuda_device)
    flat, eng = SlotEngine(svc, di), SlotEngine(sharded, di)
    assert len(eng.groups) == 4
    for r in refs:
        flat.update(r)
        eng.update(r)
    flat.tick()
    eng.tick()
    assert_bitwise(np.array([eng.read(p) for p in range(64)]),
                   np.array([flat.read(p) for p in range(64)]), "tick")
    for _ in range(3):
        sharded.predict_batch(refs[:8])
    fast = sharded.shard_cost_snapshot()
    assert len(fast) == 4 and all(v > 0 for v in fast.values())
    lane0 = sharded._buckets[0].device
    sharded.dispatch_guard = \
        lambda lane: time.sleep(0.05) if lane == lane0 else None
    torch.cuda.synchronize()
    for _ in range(5):
        sharded.predict_batch(refs[:8])
    slow = sharded.shard_cost_snapshot()
    k0 = tuple(sorted(sharded._buckets[0].idx))
    assert slow[k0] > fast[k0] + 0.02
    assert len(sharded.measured_finish_times()) == 4


@pytest.mark.cuda
def test_cuda_lane_loss_quarantined_bitwise(cuda_device):
    """A permanent loss of lane 2 of 4 under ``protect`` with a
    ``HotSwapper`` on the card: quarantined, re-placed onto three lanes
    of the same card, and bitwise the unsharded flush."""
    from repro_torch.control.faults import FaultEvent, FaultPlane
    from repro_torch.control.swap import HotSwapper
    from repro_torch.device import lanes
    svc, sharded, di, refs = _placed(cuda_device)
    devs = lanes(4, cuda_device)
    sw = HotSwapper(svc.members, np.ones(len(svc.members), np.int8),
                    vitals_model=svc.vitals_model,
                    labs_model=svc.labs_model, devices=devs,
                    placement_fn=lambda s: sharded.placement,
                    warmup_batch_sizes=(8,))
    plane = FaultPlane([FaultEvent(0.0, "device_loss", target=2)])
    plane.arm(sw, devices=devs)
    got = plane.protect(sw.facade.predict_batch, sw)(refs[:8])
    assert sw.quarantined == [devs[2]] and len(sw.devices) == 3
    assert {b.tdev for b in sw.facade.current._buckets} == {cuda_device}
    assert_bitwise(np.array(got), np.array(svc.predict_batch(refs[:8])),
                   "after failover")


def _guarded_calls(dev, rg):
    """Each kernel wrapper on small inputs on the card, with its plain
    version: (kernel call, plain call, bitwise?).  ``rg`` marks the
    float inputs that require grad."""
    gen = torch.Generator(device=dev).manual_seed(0)
    f = lambda *s: torch.randn(*s, generator=gen, device=dev) \
        .requires_grad_(rg)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    buf, pat, ends, val = f(2, 3, 8), i32([1, 0]), i32([5, 8]), i32([4, 3])
    x3, w3 = f(2, 9, 4), f(3, 2, 4)
    x4, w4 = f(2, 1, 9, 4), f(2, 3, 4, 4)
    q, k, v = f(1, 5, 4, 32), f(1, 5, 2, 32), f(1, 5, 2, 32)
    pos = torch.arange(5, dtype=torch.int32, device=dev)
    qd = f(1, 4, 32)
    xs, dt, A = f(1, 8, 2, 8), f(1, 8, 2).abs(), -f(2).abs()
    Bs, Cs, Ds = f(1, 8, 1, 8), f(1, 8, 1, 8), f(2)
    xb, wg, wu, wd = f(2, 3, 8), f(2, 8, 5), f(2, 8, 5), f(2, 5, 8)
    return {
        "window_gather": (lambda: kgather.window_gather(buf, pat, ends, val,
                                                        4),
                          lambda: ref.window_gather(buf, pat, ends, val, 4),
                          True),
        "conv1d_stripe": (lambda: kconv.conv1d_stripe(x3, w3, None, 1, 2),
                          lambda: ref.conv1d_stripe(x3, w3, None, 1, 2),
                          False),
        "conv1d_stripe_stacked": (
            lambda: kconv.conv1d_stripe_stacked(x4, w4, None, 2),
            lambda: ref.conv1d_stripe_stacked(x4, w4, None, 2), False),
        "flash_attention": (lambda: kflash.flash_attention(q, k, v, pos, pos),
                            lambda: ref.attention(q, k, v, pos, pos), False),
        "decode_attention": (
            lambda: kdecode.decode_attention(qd, k, v, pos, 4),
            lambda: ref.decode_attention(qd, k, v, pos, i32([4])), False),
        "ssd": (lambda: kssd.ssd(xs, dt, A, Bs, Cs, Ds, 4)[0],
                lambda: ref.ssd_chunked(xs, dt, A, Bs, Cs, Ds, 4)[0], False),
        "moe_gmm": (lambda: kgmm.moe_gmm(xb, wg, wu, wd),
                    lambda: ref.moe_gmm(xb, wg, wu, wd), False),
    }


_LAUNCHES = {"window_gather": kgather.launches,
             "conv1d_stripe": kconv.launches,
             "conv1d_stripe_stacked": kconv.launches_stacked,
             "flash_attention": kflash.launches,
             "decode_attention": kdecode.launches, "ssd": kssd.launches,
             "moe_gmm": kgmm.launches}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_LAUNCHES))
def test_cuda_kernel_guard_grad_on_and_off(cuda_device, name):
    """Grad on and an input that requires grad: the wrapper raises before
    it launches.  Grad off (the same inputs) or no input that requires
    grad: it launches and agrees with its plain version."""
    counter = _LAUNCHES[name]
    kernel, _, _ = _guarded_calls(cuda_device, True)[name]
    before = counter.value
    with pytest.raises(RuntimeError, match="no backward"):
        kernel()
    assert counter.value == before
    for rg in (True, False):
        kernel, plain, bitwise = _guarded_calls(cuda_device, rg)[name]
        with torch.no_grad():
            got, want = kernel(), plain()
        assert counter.value == before + 1 + (not rg)
        (assert_bitwise if bitwise else assert_close)(got, want, name)
    kernel, _, _ = _guarded_calls(cuda_device, False)[name]
    kernel()                                  # grad on, nothing requires it
    assert counter.value == before + 3


@pytest.mark.cuda
def test_cuda_ecg_train_step_matches_cpu_with_tf32_left_on(cuda_device):
    """Two train steps of a reduced member on the card against the same
    steps on the CPU (plain versions both), with cuDNN's and cuBLAS's
    TF32 switched on for the process: each step turns them off and puts
    them back, and launches no kernel; the trained member's predictions
    (the CUDA conv, the head's matmul in fp32) match the CPU's."""
    from repro_torch.configs.ecg_zoo import zoo_specs
    from repro_torch.models.ecg_resnext import leaves, map_params
    from repro_torch.training.data import make_icu_dataset
    from repro_torch.training.train_loop import (ecg_predict_proba,
                                                 train_ecg_model)

    spec = zoo_specs(reduced=True, input_len=750)[11]       # w16_b4
    d = make_icu_dataset(n_patients=4, clips_per_patient=4, seed=0,
                         seconds=3)
    x, y = d["ecg"][:, spec.lead, :], d["label"]
    counters = list(_LAUNCHES.values())
    before = [c.value for c in counters]
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        pc, lc = train_ecg_model(spec, x, y, steps=2, batch=8, seed=3,
                                 device=cuda_device)
        assert [c.value for c in counters] == before
        proba = ecg_predict_proba(pc, x, spec)
        flags = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    assert flags == (True, True)
    assert kconv.launches.value == before[1] + 1 + 3 * spec.blocks
    assert_close(proba, ecg_predict_proba(map_params(pc, lambda t: t.cpu()),
                                          x, spec), "predictions")
    pp, lp = train_ecg_model(spec, x, y, steps=2, batch=8, seed=3,
                             device="cpu")
    assert_close(np.array(lc), np.array(lp), "losses")
    for a, b in zip(leaves(pc), leaves(pp)):
        assert a.is_cuda and not a.requires_grad
        assert_close(a, b)


@pytest.fixture
def nccl_mesh(cuda_device):
    """A one-rank NCCL mesh (``make_host_mesh()``), torn down after."""
    from repro_torch.launch import mesh
    mesh.teardown()
    yield mesh.make_host_mesh()
    mesh.teardown()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b-reduced",
                                  "deepseek-v2-lite-16b"])
def test_cuda_moe_sharded_on_one_nccl_rank_is_moe_apply(nccl_mesh, arch):
    """``moe_apply_sharded`` over a one-rank NCCL mesh on the card, at a
    reduced and at deepseek's full layer width (64 experts of 1408, two
    shared): bitwise ``moe_apply`` (the all-reduce over one rank is a
    copy), each through the ``moe_gmm`` kernel once."""
    from repro_torch.models import moe

    cfg = get_config(arch)
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    p = moe.init_moe(gen, cfg, torch.float32, dev)
    x = 0.1 * torch.randn((2, 64, cfg.d_model), generator=gen, device=dev)
    before = kgmm.launches.value
    with torch.no_grad():
        y1, a1 = moe.moe_apply(p, x, cfg)
        y2, a2 = moe.moe_apply_sharded(p, x, cfg, nccl_mesh)
    assert kgmm.launches.value == before + 2
    assert y2.is_cuda and torch.equal(y1, y2) and torch.equal(a1, a2)


@pytest.mark.cuda
def test_cuda_smollm_train_step_with_and_without_remat(cuda_device):
    """One smollm-360m-reduced train step on the card from the same
    params with and without ``remat``: the same loss and params, bitwise,
    and no kernel launched."""
    from repro_torch.models.ecg_resnext import leaves
    from repro_torch.training.data import lm_batches
    from repro_torch.training.optimizer import AdamW, constant_schedule
    from repro_torch.training.train_loop import make_train_step

    cfg = get_config("smollm-360m-reduced")
    params = get_model(cfg).init(torch.Generator(device=cuda_device)
                                 .manual_seed(0), cfg, RuntimeOptions(),
                                 cuda_device)
    batch = {k: torch.from_numpy(v).to(cuda_device)
             for k, v in next(lm_batches(cfg.vocab_size, 4, 32)).items()}
    opt = AdamW(lr=constant_schedule(3e-4))
    counters = list(_LAUNCHES.values())
    before = [c.value for c in counters]
    out = {r: make_train_step(cfg, RuntimeOptions(remat=r), opt)(
        params, opt.init(params), batch) for r in (False, True)}
    assert [c.value for c in counters] == before
    assert torch.equal(out[False][2], out[True][2])
    assert all(torch.equal(a, b) for a, b in zip(leaves(out[False][0]),
                                                 leaves(out[True][0])))
