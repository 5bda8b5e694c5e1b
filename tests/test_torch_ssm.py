"""The port's Mamba-2 (SSD) path against the JAX package's.

Inputs come from numpy with a seed; weights are the JAX package's own
(``init_mamba2``, ``init_lm``) carried across with ``models/convert.py``.
Within the one tolerance of ``repro_torch.testing``:

* the plain ``ssd_chunked`` against ``repro.kernels.ref.ssd_chunked``
  and the Pallas ``ssd`` in interpret mode (``tests/test_kernels.py:
  74-110``), with ragged S, an initial state and G in {1, 2}; the plain
  ``ssd_decode_step`` against JAX's;
* inside the port, the chunked scan against S recurrent decode steps;
* ``mamba2_apply`` prefill (output and cache) and an in-place decode
  step against JAX;
* ``mamba2-2.7b-reduced`` end to end: forward, prefill logits and every
  cache leaf, and three decode steps with the cache after each; and the
  cached decode against the teacher-forced forward (2e-3, the
  reference's bound).

The CUDA ``ssd`` kernel is held against the plain version in
``tests/test_torch_cuda.py`` (card only) and by ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import get_config as j_get_config
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd as pl_ssd
from repro.models import ssm as jssm
from repro.models.api import get_model as j_get_model
from repro.models.runtime import RuntimeOptions as JRuntimeOptions
from repro_torch.configs.registry import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd as kssd
from repro_torch.models import ssm
from repro_torch.models.api import get_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.runtime import RuntimeOptions
from repro_torch.testing import (assert_bitwise, assert_close,
                                 ssd_chunk_parallel)

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)
ARCH = "mamba2-2.7b-reduced"

# (B, S, H, P, G, N, chunk, with h0): tests/test_kernels.py:74-77 and
# ragged S, G = 2, an initial state
SSD_CASES = [
    (1, 48, 4, 8, 1, 16, 16, False),
    (2, 32, 2, 16, 2, 8, 8, False),
    (1, 40, 4, 8, 4, 8, 16, False),         # padded chunk
    (2, 45, 4, 16, 2, 16, 16, True),        # ragged S, G = 2, h0
    (1, 37, 3, 8, 1, 16, 32, True),         # ragged S, G = 1, h0
]


def ssd_inputs(case, seed=0):
    B, S, H, P, G, N, _, with_h0 = case
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal((B, S, H, P)).astype(f32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(f32)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(f32)
    Bm = (rng.standard_normal((B, S, G, N)) * 0.5).astype(f32)
    Cm = (rng.standard_normal((B, S, G, N)) * 0.5).astype(f32)
    D = rng.standard_normal(H).astype(f32)
    h0 = (rng.standard_normal((B, H, P, N)) * 0.1).astype(f32) \
        if with_h0 else None
    return x, dt, A, Bm, Cm, D, h0


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("case", SSD_CASES, ids=lambda c: "-".join(map(
    str, c)))
def test_ssd_chunked_matches_jax_ref_and_pallas(case):
    chunk = case[6]
    args = ssd_inputs(case)
    y, hT = ops.ssd(*map(_t, args[:6]), chunk, _t(args[6]))
    assert y.shape == args[0].shape and hT.dtype == torch.float32
    yw, hw = jref.ssd_chunked(*map(_j, args[:6]), chunk, _j(args[6]))
    assert_close(y, yw, "y vs ref")
    assert_close(hT, hw, "hT vs ref")
    yp, hp = pl_ssd(*map(_j, args[:6]), chunk, _j(args[6]),
                    interpret=True)
    assert_close(y, yp, "y vs Pallas")
    assert_close(hT, hp, "hT vs Pallas")


@pytest.mark.parametrize("case", SSD_CASES, ids=lambda c: "-".join(map(
    str, c)))
def test_ssd_chunk_parallel_model_matches_jax_ref_and_pallas(case):
    """The CUDA ``ssd``'s decomposition (each chunk's own end state, the
    states passed on in chunk order, each chunk's output; W on its
    causal half) against the JAX package's oracle and its Pallas
    kernel, h0, a ragged S and G = 2 included."""
    chunk = case[6]
    args = ssd_inputs(case)
    y, hT = ssd_chunk_parallel(*map(_t, args[:6]), chunk, _t(args[6]))
    assert y.shape == args[0].shape and hT.shape == (
        case[0], case[2], case[3], case[5])
    yw, hw = jref.ssd_chunked(*map(_j, args[:6]), chunk, _j(args[6]))
    assert_close(y, yw, "y vs ref")
    assert_close(hT, hw, "hT vs ref")
    yp, hp = pl_ssd(*map(_j, args[:6]), chunk, _j(args[6]),
                    interpret=True)
    assert_close(y, yp, "y vs Pallas")
    assert_close(hT, hp, "hT vs Pallas")


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_decode_step_matches_jax(G):
    rng = np.random.default_rng(G)
    B, H, P, N = 2, 4, 8, 16
    h = rng.standard_normal((B, H, P, N)).astype(np.float32)
    x = rng.standard_normal((B, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    Bm = rng.standard_normal((B, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, G, N)).astype(np.float32)
    D = rng.standard_normal(H).astype(np.float32)
    args = (h, x, dt, A, Bm, Cm, D)
    y, hn = ref.ssd_decode_step(*map(_t, args))
    yw, hw = jref.ssd_decode_step(*map(_j, args))
    assert_close(y, yw, "y")
    assert_close(hn, hw, "h")


def test_ssd_chunked_matches_sequential_decode():
    """``tests/test_kernels.py:94`` inside the port, with a ragged S and
    an initial state."""
    x, dt, A, Bm, Cm, D, h0 = map(_t, ssd_inputs(
        (1, 30, 2, 8, 1, 8, 8, True), seed=3))
    y_chunk, hT = ref.ssd_chunked(x, dt, A, Bm, Cm, D, 8, h0)
    h, ys = h0, []
    for t in range(x.shape[1]):
        y, h = ref.ssd_decode_step(h, x[:, t], dt[:, t], A, Bm[:, t],
                                   Cm[:, t], D)
        ys.append(y)
    assert_close(y_chunk, torch.stack(ys, dim=1), "y")
    assert_close(hT, h, "hT")


def test_ssd_kernel_wrapper_refuses_cpu_tensors():
    x, dt, A, Bm, Cm, D, _ = map(_t, ssd_inputs(SSD_CASES[0]))
    with pytest.raises(ValueError, match="CUDA tensors"):
        kssd.ssd(x, dt, A, Bm, Cm, D, 16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.ssd(x, dt, A, Bm, Cm, D, 16, impl="cuda")


def _mixer(seed=0):
    cfg_j = j_get_config(ARCH)
    p_j = jssm.init_mamba2(jax.random.PRNGKey(seed), cfg_j)
    # non-trivial A, D and dt_bias (the init's are -1, 1 and 0)
    rng = np.random.default_rng(seed)
    H = cfg_j.ssm.n_heads(cfg_j.d_model)
    for name, scale in (("A_log", 0.5), ("D", 1.0), ("dt_bias", 0.5)):
        p_j[name] = jnp.asarray(rng.standard_normal(H).astype(np.float32)
                                * scale)
    return cfg_j, p_j, get_config(ARCH), params_from_numpy(
        jax.tree.map(np.asarray, p_j))


@pytest.mark.parametrize("S", [20, 16, 3])
def test_mamba2_apply_matches_jax(S):
    """Prefill output and cache (S ragged, a whole chunk, shorter than
    the conv), then one decode step that advances the cache in place."""
    cfg_j, p_j, cfg, p = _mixer()
    assert p["A_log"].dtype == p["D"].dtype == torch.float32
    rng = np.random.default_rng(S)
    u = rng.standard_normal((2, S + 1, cfg.d_model)).astype(np.float32)
    yw, cw = jssm.mamba2_apply(p_j, jnp.asarray(u[:, :S]), cfg_j,
                               return_cache=True)
    y, c = ssm.mamba2_apply(p, torch.from_numpy(u[:, :S]), cfg,
                            return_cache=True)
    assert_close(y, yw, "prefill y")
    assert set(c) == set(cw)
    for name in c:
        assert tuple(c[name].shape) == cw[name].shape, name
        assert_close(c[name], cw[name], f"prefill cache {name}")
    yw, cw = jssm.mamba2_apply(p_j, jnp.asarray(u[:, S:]), cfg_j, cache=cw)
    tensors = {k: v for k, v in c.items()}
    y, c2 = ssm.mamba2_apply(p, torch.from_numpy(u[:, S:]), cfg, cache=c)
    assert c2 is c and all(c[k] is tensors[k] for k in c)     # in place
    assert_close(y, yw, "decode y")
    for name in c:
        assert_close(c[name], cw[name], f"decode cache {name}")


def _lm():
    cfg_j, rt_j = j_get_config(ARCH), JRuntimeOptions()
    params_j = j_get_model(cfg_j).init(KEY, cfg_j, rt_j)
    cfg, rt = get_config(ARCH), RuntimeOptions()
    return (cfg_j, rt_j, params_j, cfg, rt,
            params_from_numpy(jax.tree.map(np.asarray, params_j)))


def test_mamba2_lm_matches_jax():
    cfg_j, rt_j, params_j, cfg, rt, params = _lm()
    jm, tm = j_get_model(cfg_j), get_model(cfg)
    B, S = 2, 24
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S + 3)).astype(np.int32)
    want, aux_w = jm.forward(params_j, jnp.asarray(toks[:, :S]), cfg_j, rt_j)
    got, aux = tm.forward(params, torch.from_numpy(toks[:, :S]), cfg, rt)
    assert_close(got, want, "forward")
    assert float(aux) == float(aux_w) == 0.0
    lw, cw = jm.prefill(params_j, jnp.asarray(toks[:, :S]), cfg_j, rt_j,
                        max_len=S + 3)
    lg, cg = tm.prefill(params, torch.from_numpy(toks[:, :S]), cfg, rt,
                        max_len=S + 3)
    assert_close(lg, lw, "prefill logits")

    def same_cache(what):
        assert cg["idx"] == int(cw["idx"]), what
        assert_bitwise(cg["pos"], np.asarray(cw["pos"]), f"{what}: pos")
        (sg,), (sw,) = cg["segments"], cw["segments"]
        assert set(sg) == set(sw) == {"conv_x", "conv_B", "conv_C", "ssm"}
        for name in sg:
            assert tuple(sg[name].shape) == sw[name].shape
            assert_close(sg[name], sw[name], f"{what}: {name}")

    same_cache("prefill")
    for t in range(3):
        lw, cw = jm.decode_step(params_j, cw, jnp.asarray(toks[:, S + t]),
                                cfg_j, rt_j)
        lg, cg = tm.decode_step(params, cg, torch.from_numpy(toks[:, S + t]),
                                cfg, rt)
        assert_close(lg, lw, f"decode step {t}")
        same_cache(f"decode step {t}")


def test_mamba2_cached_decode_matches_teacher_forced_forward():
    """``tests/test_arch_smoke.py:71`` inside the port."""
    cfg, rt = get_config(ARCH), RuntimeOptions()
    m = get_model(cfg)
    params = m.init(torch.Generator().manual_seed(0), cfg, rt, "cpu")
    S = 21
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, S + 2)).astype(np.int32))
    full, _ = m.forward(params, toks, cfg, rt)
    tol = dict(rtol=2e-3, atol=2e-3)
    lg, cache = m.prefill(params, toks[:, :S], cfg, rt)
    np.testing.assert_allclose(lg, full[:, S - 1], **tol)
    for t in range(2):
        lg, cache = m.decode_step(params, cache, toks[:, S + t], cfg, rt)
        np.testing.assert_allclose(lg, full[:, S + t], **tol)


def test_mamba2_init_layout_matches_jax():
    """Leaf names, shapes and dtypes of the stacked LM tree, and the
    constant leaves' values."""
    cfg_j, rt_j, params_j, cfg, rt, _ = _lm()
    mine = get_model(cfg).init(torch.Generator().manual_seed(0), cfg, rt,
                               "cpu")
    flat_j = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_leaves_with_path(params_j)}
    flat = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + f"['{k}']")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path + f"[{i}]")
        else:
            flat[path] = node
    walk(mine, "")
    assert set(flat) == set(flat_j)
    for k, v in flat.items():
        assert tuple(v.shape) == flat_j[k].shape, k
        assert str(v.dtype).split(".")[-1] == str(flat_j[k].dtype), k
    seg = mine["segments"][0]["mixer"]
    assert torch.equal(seg["A_log"], torch.zeros_like(seg["A_log"]))
    assert torch.equal(seg["D"], torch.ones_like(seg["D"]))
