"""The arithmetic of the CUDA ``moe_gmm``'s two paths, modelled in plain
PyTorch on the CPU (``repro_torch.testing``).

* ``round_tf32`` rounds as ``cvt.rna.tf32.f32``: to nearest, ties away
  from zero, 10 mantissa bits kept.
* 3xTF32 (the tensor-core path at prefill) lands within the port's 1e-4
  of a float64 ``moe_gmm`` and as close as plain float32 at the reduced
  phi3.5-moe / deepseek-v2-lite expert shapes and at their full d with f
  cut; plain TF32 misses 1e-4 at every one of them (its error, ~1.5e-3
  on outputs of size ~3, is reported in the assertion).  Inputs at unit
  scale: x ~ N(0, 1), each weight ~ N(0, 1/fan-in of its contracted
  axis).
* The streaming path at decode computes only the rows that hold a
  nonzero value: on a routed decode step's buffer that leaves
  ``ref.moe_gmm``'s output unchanged (an empty row gives zeros there
  too, since silu(0)·0 = 0); an empty expert whose weights hold NaN is
  the one difference, by design (the plain version gives NaN, the kernel
  zeros).
* The CUDA ``ssd`` takes its four products as 3xTF32 too: its plain
  model (``ssd_chunk_parallel`` with ``passes=3``) at the served per-head
  tile (chunk 128, P = 64, N = 128; mamba2-2.7b's input scales) lands
  within 1e-4 of a float64 ``ssd_chunked`` and as close as float32;
  plain TF32 misses.
* So does the CUDA ``flash_attention``: its plain model
  (``flash_attention_tiles`` with ``passes=3``) at qwen3-4b's head width
  (D = 128, g = 4) and at the MLA prefill's (192, 128), causal over 256
  keys, lands within 1e-4 of a float64 ``ref.attention`` and within 2x
  of float32's error; plain TF32 misses 1e-4 (~1e-3).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.kernels import moe_gmm as kgmm
from repro_torch.kernels import ref
from repro_torch.models import moe
from repro_torch.testing import (assert_close, flash_attention_tiles,
                                 moe_gmm_occupied_rows, moe_gmm_tf32,
                                 round_tf32, ssd_chunk_parallel)

torch.set_num_threads(1)

# (value, its TF32 rounding)
TF32_CASES = [
    (1 + 2 ** -11, 1 + 2 ** -10),                 # tie: away from zero
    (-(1 + 2 ** -11), -(1 + 2 ** -10)),
    (1 + 3 * 2 ** -11, 1 + 2 ** -9),              # tie, odd: away
    (1 + 2 ** -11 - 2 ** -23, 1.0),               # below the tie: down
    (3.0, 3.0),                                   # exact
    (float("inf"), float("inf")),
    (-0.0, -0.0),
]


@pytest.mark.parametrize("value,want", TF32_CASES)
def test_round_tf32_is_nearest_ties_away(value, want):
    got = round_tf32(torch.tensor([value], dtype=torch.float32))
    assert got.item() == want
    assert np.signbit(got.item()) == np.signbit(want)


def test_round_tf32_keeps_nan_and_ten_mantissa_bits():
    assert torch.isnan(round_tf32(torch.tensor([float("nan")]))).all()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        1000).astype(np.float32))
    bits = round_tf32(x).view(torch.int32)
    assert int((bits & 0x1FFF).abs().max()) == 0
    assert float(((round_tf32(x) - x) / x).abs().max()) <= 2 ** -11


def _gmm_inputs(E, C, d, f, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(a) for a in (
        rng.standard_normal((E, C, d)),
        rng.standard_normal((E, d, f)) / d ** 0.5,
        rng.standard_normal((E, d, f)) / d ** 0.5,
        rng.standard_normal((E, f, d)) / f ** 0.5)]


# (label, E, C, d, f): the reduced configs' experts (E 4, d 256, f 64)
# at a prefill's C and a decode's, and one expert of each full-width
# model with its full d (the contraction of gate/up) and f cut or full
PRECISION_CASES = [
    ("phi3.5-moe reduced, prefill", 4, 48, 256, 64),
    ("deepseek-v2-lite reduced, decode", 4, 8, 256, 64),
    ("phi3.5-moe d=4096, f cut to 256", 1, 16, 4096, 256),
    ("deepseek-v2-lite d=2048, f=1408", 1, 16, 2048, 1408),
]


@pytest.mark.parametrize("case", PRECISION_CASES, ids=lambda c: c[0])
def test_3xtf32_moe_gmm_is_as_close_to_fp64_as_fp32(case):
    _, E, C, d, f = case
    t64 = _gmm_inputs(E, C, d, f, seed=1)
    t32 = [t.float() for t in t64]
    want = ref.moe_gmm(*t64)
    err = {name: float((got.double() - want).abs().max()) for name, got in (
        ("fp32", ref.moe_gmm(*t32)),
        ("3xtf32", moe_gmm_tf32(*t32, passes=3)),
        ("tf32", moe_gmm_tf32(*t32, passes=1)))}
    assert_close(moe_gmm_tf32(*t32, passes=3), want, f"3xTF32 {err}")
    assert err["3xtf32"] <= 2 * err["fp32"], err
    # plain TF32 misses the port's tolerance, by an order of magnitude
    assert not np.allclose(moe_gmm_tf32(*t32, passes=1).numpy(),
                           want.numpy(), rtol=1e-4, atol=1e-4), err
    assert err["tf32"] > 10 * err["3xtf32"], err


@pytest.mark.parametrize("C,want", [(1, "stream"), (16, "stream"),
                                    (24, "stream"), (64, "stream"),
                                    (65, "tensor_cores"),
                                    (976, "tensor_cores"),
                                    (1296, "tensor_cores")])
def test_moe_gmm_path_follows_c(C, want):
    """phi3.5-moe and deepseek-v2-lite decode (C 16, 24 at B = 4) take
    the stream, their prefills (1296, 976) the tensor cores."""
    assert kgmm.path(C) == want


def _routed_decode(arch, seed=0):
    """A decode step's dispatched buffer (B = 4, S = 1) of the reduced
    config, and unit-scale expert weights."""
    cfg = get_config(arch)
    m = cfg.moe
    E, d, f = m.n_routed_experts, cfg.d_model, m.expert_d_ff
    g = torch.Generator().manual_seed(seed)
    router = {"router": torch.randn((d, E), generator=g) / d ** 0.5}
    x = torch.randn((4, 1, d), generator=g)
    r = moe.route(router, x, cfg, 1.25)
    xe = moe.dispatch(x, r, E).xe
    w = [torch.randn(s, generator=g) / s[1] ** 0.5
         for s in ((E, d, f), (E, d, f), (E, f, d))]
    return xe, w


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b-reduced",
                                  "deepseek-v2-lite-16b-reduced"])
def test_zeroing_empty_rows_leaves_moe_gmm_unchanged(arch):
    xe, w = _routed_decode(arch)
    occupied = (xe != 0).any(-1)
    assert 0 < int(occupied.sum()) < occupied.numel()   # some rows empty
    want = ref.moe_gmm(xe, *w)
    assert float(want[~occupied].abs().max()) == 0.0
    assert_close(moe_gmm_occupied_rows(xe, *w), want)


def test_empty_expert_with_nan_weights_is_zero_by_design():
    """The one value the streaming path changes: an expert that holds no
    token reads no weight, so NaN there gives zeros (the plain version
    gives NaN)."""
    xe, w = _routed_decode("phi3.5-moe-42b-a6.6b-reduced")
    empty = [e for e in range(xe.shape[0]) if not bool(xe[e].any())]
    if not empty:
        xe[-1] = 0.0
        empty = [xe.shape[0] - 1]
    w[2][empty[0]] = float("nan")
    got, plain = moe_gmm_occupied_rows(xe, *w), ref.moe_gmm(xe, *w)
    assert bool(torch.isnan(plain[empty[0]]).all())
    assert float(got[empty[0]].abs().max()) == 0.0
    keep = [e for e in range(xe.shape[0]) if e != empty[0]]
    assert_close(got[keep], plain[keep])


def _ssd_inputs(S, with_h0, seed):
    """One batch row, two heads of mamba2-2.7b's tile (P = 64, N = 128)
    at its input scales (as ``chip_smoke.py`` phase 2 draws them):
    x, h0 ~ N(0, 1), B ~ N(0, 1), C ~ N(0, 1/N), dt = softplus(N(0, 1)),
    A = -U(1, 16); float64."""
    rng = np.random.default_rng(seed)
    B, H, P, G, N = 1, 2, 64, 1, 128
    arrs = (rng.standard_normal((B, S, H, P)),
            np.log1p(np.exp(rng.standard_normal((B, S, H)))),
            -(1 + 15 * rng.random(H)),
            rng.standard_normal((B, S, G, N)),
            rng.standard_normal((B, S, G, N)) / N ** 0.5,
            rng.standard_normal(H),
            rng.standard_normal((B, H, P, N)) if with_h0 else None)
    return [None if a is None else torch.from_numpy(np.asarray(a))
            for a in arrs]


@pytest.mark.parametrize("S,with_h0", [(256, True), (384, False)])
def test_3xtf32_ssd_is_as_close_to_fp64_as_fp32(S, with_h0):
    t64 = _ssd_inputs(S, with_h0, seed=1)
    t32 = [None if t is None else t.float() for t in t64]
    want = ref.ssd_chunked(*t64[:6], 128, t64[6])
    got = {"fp32": ref.ssd_chunked(*t32[:6], 128, t32[6]),
           "3xtf32": ssd_chunk_parallel(*t32[:6], 128, t32[6], passes=3),
           "tf32": ssd_chunk_parallel(*t32[:6], 128, t32[6], passes=1)}
    err = {k: [float((g.double() - w).abs().max()) for g, w in zip(v, want)]
           for k, v in got.items()}
    for name, g, w in zip(("y", "hT"), got["3xtf32"], want):
        assert_close(g, w, f"3xTF32 {name} {err}")
    for i in range(2):
        assert err["3xtf32"][i] <= 2 * err["fp32"][i], err
    assert not np.allclose(got["tf32"][0].numpy(), want[0].numpy(),
                           rtol=1e-4, atol=1e-4), err


@pytest.mark.parametrize("D,Dv,Hkv", [(128, 128, 1), (192, 128, 2)])
def test_3xtf32_flash_attention_is_as_close_to_fp64_as_fp32(D, Dv, Hkv):
    rng = np.random.default_rng(2)
    S = T = 256
    t64 = [torch.from_numpy(a) for a in (
        rng.standard_normal((1, S, 4, D)), rng.standard_normal((1, T, Hkv, D)),
        rng.standard_normal((1, T, Hkv, Dv)))]
    t32 = [t.float() for t in t64]
    pos = torch.arange(S, dtype=torch.int32)
    want = ref.attention(*t64, pos, pos)
    got = {"fp32": ref.attention(*t32, pos, pos),
           "3xtf32": flash_attention_tiles(*t32, pos, pos, passes=3),
           "tf32": flash_attention_tiles(*t32, pos, pos, passes=1)}
    err = {k: float((g.double() - want).abs().max()) for k, g in got.items()}
    assert_close(got["3xtf32"], want, f"3xTF32 {err}")
    assert err["3xtf32"] <= 2 * err["fp32"], err
    assert not np.allclose(got["tf32"].numpy(), want.numpy(), rtol=1e-4,
                           atol=1e-4), err
