"""The port's kernel modules against the JAX package's.

* the plain ``conv1d_stripe`` / ``conv1d_stripe_stacked`` against
  ``repro.kernels.ref.conv1d_stripe``, the vmapped stacked oracle of
  ``repro.kernels.ops`` and the Pallas kernels in interpret mode (SAME
  at stride 1 and 2, CAUSAL, grouped, ``cin_g = 1``, ``K = 1``), within
  the one tolerance of ``repro_torch.testing``;
* the plain ``window_gather`` BITWISE against ``ref.window_gather`` and
  the Pallas kernel in interpret mode (non-pow2 capacities, ``ends <
  L``, ``valid`` of 0, partial and full);
* the plain model of the CUDA ``window_gather``'s plan (chunks of a
  row, a float4 a thread when ``L % 4 == 0``, one subtraction for the
  wrap when ``L <= cap``: ``window_gather_runs``) BITWISE against
  ``ref.window_gather``, with ``L % 4 != 0``, a wrap inside a vector of
  4, ``L = cap``, ``L > cap`` and odd capacities;
* the ``ops`` dispatch: CPU tensors run the plain versions.

The CUDA kernels themselves are held against the plain versions in
``tests/test_torch_cuda.py`` (card only) and by ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.conv1d_stripe import (_same_padding,
                                         conv1d_stripe as pl_conv,
                                         conv1d_stripe_stacked as pl_conv_st)
from repro.kernels.window_gather import window_gather as pl_gather
from repro_torch.kernels import conv1d_stripe as kconv
from repro_torch.kernels import ops, ref
from repro_torch.kernels import window_gather as kgather
from repro_torch.testing import (assert_bitwise, assert_close, gather_plan,
                                 window_gather_runs)

torch.set_num_threads(1)

# (B, L, Cin, Cout, K, groups, stride, padding)
CONV_CASES = [
    (2, 40, 8, 8, 7, 8, 2, "SAME"),      # grouped stripe, cin_g=1, stride 2
    (2, 41, 16, 16, 7, 8, 1, "SAME"),    # grouped, cin_g=2, odd L
    (3, 40, 1, 8, 7, 1, 2, "SAME"),      # the stem: Cin=1, even L (lo=2, hi=3)
    (2, 33, 1, 16, 7, 1, 2, "SAME"),     # the stem at odd L
    (2, 20, 16, 8, 1, 1, 1, "SAME"),     # 1x1 reduce
    (2, 20, 8, 16, 1, 1, 2, "SAME"),     # 1x1 at stride 2
    (2, 30, 4, 4, 4, 4, 1, "CAUSAL"),    # Mamba short conv: depthwise causal
    (2, 30, 8, 8, 7, 8, 2, "CAUSAL"),
    (1, 5, 4, 6, 7, 2, 1, "SAME"),       # K > L
]


def _conv_inputs(case, M=None, seed=0):
    B, L, Cin, Cout, K, groups, stride, padding = case
    rng = np.random.default_rng(seed)
    lead = () if M is None else (M,)
    x = rng.standard_normal(lead + (B, L, Cin)).astype(np.float32)
    w = (rng.standard_normal(lead + (K, Cin // groups, Cout))
         / np.sqrt(K * Cin // groups)).astype(np.float32)
    b = rng.standard_normal(lead + (Cout,)).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: "-".join(map(
    str, c)))
def test_conv_plain_matches_jax_ref(case):
    _, _, _, _, _, groups, stride, padding = case
    x, w, b = _conv_inputs(case)
    want = jref.conv1d_stripe(x, w, b, stride, groups, padding)
    got = ref.conv1d_stripe(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(b), stride, groups, padding)
    assert tuple(got.shape) == want.shape
    assert_close(got, want, str(case))


@pytest.mark.parametrize("case", CONV_CASES[:4] + CONV_CASES[6:8],
                         ids=lambda c: "-".join(map(str, c)))
def test_conv_stacked_plain_matches_vmap_oracle_and_pallas(case):
    _, _, _, _, _, groups, stride, padding = case
    x, w, b = _conv_inputs(case, M=3, seed=1)
    oracle = jax.vmap(lambda xm, wm: jref.conv1d_stripe(
        xm, wm, None, stride, groups, padding))(x, w) + b[:, None, None, :]
    pallas = pl_conv_st(x, w, b, stride, groups, padding, interpret=True)
    got = ops.conv1d(torch.from_numpy(x), torch.from_numpy(w),
                     torch.from_numpy(b), stride, groups, padding)
    assert tuple(got.shape) == oracle.shape
    assert_close(got, oracle, "vmap oracle")
    assert_close(got, pallas, "pallas interpret")


def test_conv_3d_plain_matches_pallas_interpret():
    case = CONV_CASES[0]
    _, _, _, _, _, groups, stride, padding = case
    x, w, b = _conv_inputs(case, seed=2)
    want = pl_conv(x, w, b, stride, groups, padding, interpret=True)
    got = ops.conv1d(torch.from_numpy(x), torch.from_numpy(w),
                     torch.from_numpy(b), stride, groups, padding)
    assert_close(got, want)


@pytest.mark.parametrize("L,K,stride", [(7500, 7, 2), (3750, 7, 1),
                                        (1875, 7, 2), (40, 1, 2),
                                        (5, 7, 1), (15, 7, 2)])
def test_conv_padding_is_lax_same_split(L, K, stride):
    assert ref.conv_padding(L, K, stride, "SAME") == \
        _same_padding(L, K, stride)


def test_conv_padding_rejects_unknown_mode():
    with pytest.raises(ValueError):
        ref.conv_padding(10, 3, 1, "VALID")


def _ring(rng, N, C, cap):
    return rng.standard_normal((N, C, cap)).astype(np.float32)


# (N, C, cap, L, patients, ends, valid)
GATHER_CASES = [
    # non-pow2 cap; ends < L (the run wraps back from the ring's end);
    # valid 0 (padding row), partial and full
    (3, 2, 12, 8, [2, 0, 1, 0], [5, 11, 2, 3], [5, 8, 8, 0]),
    (4, 3, 37, 16, [0, 3, 2, 1, 3], [40, 0, 33, 7, -5], [16, 0, 9, 7, 16]),
    (2, 7, 64, 30, [1, 0, 1], [63, 29, 10], [30, 1, 30]),
    (2, 3, 16384, 7500, [1, 0], [16000, 100], [7500, 4200]),
]


@pytest.mark.parametrize("case", GATHER_CASES, ids=lambda c: f"cap{c[2]}")
def test_window_gather_plain_bitwise_vs_jax(case):
    N, C, cap, L, pts, ends, valid = case
    buf = _ring(np.random.default_rng(cap), N, C, cap)
    pts, ends, valid = (np.asarray(a, np.int32) for a in (pts, ends, valid))
    want = np.asarray(jref.window_gather(jnp.asarray(buf), pts, ends,
                                         valid, L))
    got = ops.window_gather(torch.from_numpy(buf), torch.from_numpy(pts),
                            torch.from_numpy(ends), torch.from_numpy(valid),
                            L)
    assert_bitwise(got, want, str(case[:4]))
    if L <= 64:                       # the interpret kernel is one-hot
        pallas = pl_gather(jnp.asarray(buf), jnp.asarray(pts),
                           jnp.asarray(ends), jnp.asarray(valid), L,
                           interpret=True)
        assert_bitwise(got, np.asarray(pallas), "pallas interpret")
    assert float(got[torch.from_numpy(valid == 0)].abs().sum()) == 0.0


# the CUDA window_gather's paths: (N, C, cap, L, patients, ends, valid)
GATHER_RUN_CASES = GATHER_CASES + [
    (3, 2, 50, 21, [2, 0, 1], [10, 49, 70], [21, 5, 0]),   # L % 4 = 1
    (2, 2, 37, 16, [1, 0], [51, 14], [16, 16]),    # wraps at j = 2 of a float4
    (1, 2, 3000, 2100, [0], [1502], [2100]),       # 3 chunks, wrap at j = 598
    (2, 3, 40, 40, [0, 1, 1], [7, 40, 0], [40, 13, 40]),  # L = cap
    (2, 2, 24, 40, [1, 0], [5, 30], [40, 25]),     # L > cap, float4s
    (2, 1, 10, 33, [0, 1], [3, -7], [33, 20]),     # L > cap, odd L
    (2, 3, 7501, 7500, [0, 1], [7000, 7501], [7500, 7499]),  # odd cap
]


@pytest.mark.parametrize("case", GATHER_RUN_CASES,
                         ids=lambda c: f"cap{c[2]}-L{c[3]}")
def test_window_gather_run_model_bitwise_vs_jax(case):
    N, C, cap, L, pts, ends, valid = case
    buf = _ring(np.random.default_rng(cap + L), N, C, cap)
    pts, ends, valid = (np.asarray(a, np.int32) for a in (pts, ends, valid))
    want = np.asarray(jref.window_gather(jnp.asarray(buf), pts, ends,
                                         valid, L))
    got = window_gather_runs(torch.from_numpy(buf), torch.from_numpy(pts),
                             torch.from_numpy(ends), torch.from_numpy(valid),
                             L)
    assert_bitwise(got, want, str(case[:4]))
    assert_bitwise(ops.window_gather(
        torch.from_numpy(buf), torch.from_numpy(pts), torch.from_numpy(ends),
        torch.from_numpy(valid), L), want, "plain")


@pytest.mark.parametrize("P,C,L,cap,want", [
    (64, 3, 7500, 16384, (True, 256, 8, 1536, False)),    # ECG flush
    (64, 7, 30, 64, (False, 32, 1, 448, False)),          # vitals
    (4, 2, 40, 24, (True, 32, 1, 8, True)),               # L > cap
])
def test_window_gather_plan_at_the_served_rings(P, C, L, cap, want):
    plan = gather_plan(P, C, L, cap)
    assert (plan["vec"], plan["threads"], plan["chunks"], plan["blocks"],
            plan["wrap"]) == want
    assert plan["chunks"] * plan["per_block"] >= L > \
        (plan["chunks"] - 1) * plan["per_block"]


def test_ops_cpu_runs_plain_and_counts_no_launch():
    case = CONV_CASES[0]
    x, w, b = (torch.from_numpy(a) for a in _conv_inputs(case, M=2))
    before = (kconv.launches_stacked.value, kconv.launches.value,
              kgather.launches.value)
    ops.conv1d(x, w, b, 2, 8)
    ops.conv1d(x[0], w[0], b[0], 2, 8)
    ops.window_gather(torch.zeros(2, 3, 8), torch.zeros(1, dtype=torch.int32),
                      torch.zeros(1, dtype=torch.int32),
                      torch.zeros(1, dtype=torch.int32), 4)
    assert (kconv.launches_stacked.value, kconv.launches.value,
            kgather.launches.value) == before
    with pytest.raises(ValueError):
        ops.conv1d(x, w, b, 2, 8, impl="pallas")
