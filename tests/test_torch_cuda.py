"""The CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: each test skips without a CUDA card (decided inside the
fixture, never at import).  This file imports nothing of JAX, so it runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The conv cases are the ones ``tests/test_torch_kernels.py`` holds the
plain versions to against the JAX package.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import conv1d_stripe as kconv
from repro_torch.kernels import ref
from repro_torch.kernels import window_gather as kgather
from repro_torch.testing import assert_bitwise, assert_close

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
    (4, 7500, 1, 128, 7, 1, 2, "SAME"),      # full-width stem
    (4, 3750, 64, 64, 7, 8, 2, "SAME"),      # full-width stripe
]

# (N, C, cap, L, patients, ends, valid)
GATHER_CASES = [
    (3, 2, 12, 8, [2, 0, 1, 0], [5, 11, 2, 3], [5, 8, 8, 0]),
    (4, 3, 37, 16, [0, 3, 2, 1, 3], [40, 0, 33, 7, -5], [16, 0, 9, 7, 16]),
    (2, 7, 64, 30, [1, 0, 1], [63, 29, 10], [30, 1, 30]),
    (2, 3, 16384, 7500, [1, 0], [16000, 100], [7500, 4200]),
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
@pytest.mark.parametrize("case", GATHER_CASES, ids=lambda c: f"cap{c[2]}")
def test_cuda_window_gather_bitwise(cuda_device, case):
    N, C, cap, L, pts, ends, valid = case
    buf = torch.from_numpy(np.random.default_rng(cap).standard_normal(
        (N, C, cap)).astype(np.float32)).to(cuda_device)
    idx = [torch.tensor(a, dtype=torch.int32, device=cuda_device)
           for a in (pts, ends, valid)]
    assert_bitwise(kgather.window_gather(buf, *idx, L),
                   ref.window_gather(buf, *idx, L))


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
