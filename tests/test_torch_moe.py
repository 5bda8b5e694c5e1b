"""The port's MoE path against the JAX package's.

Inputs come from numpy with a seed; weights are the JAX package's own,
carried across with ``models/convert.py``.  Within the one tolerance of
``repro_torch.testing`` unless stated:

* the plain ``moe_gmm`` against ``repro.kernels.ref.moe_gmm`` and the
  Pallas ``moe_gmm`` in interpret mode (``block_c = block_f = 32``), C
  and f ragged against the blocks included;
* ``_capacity`` equal to the reference's;
* the routing IDENTICAL to the reference's: ``top_e`` equal, ``pos_in_e``
  and ``keep`` equal to an independent count, and the dispatched
  ``[E, B·C, d]`` buffer handed to ``moe_gmm`` bitwise equal to the one
  JAX builds (it encodes every kept choice's expert and slot), with
  capacity overflowing and not;
* ``moe_apply`` output and aux loss, with and without a shared expert;
* ``phi3.5-moe-42b-a6.6b-reduced`` end to end: forward logits and aux,
  prefill logits and cache, two decode steps; and the cached decode
  against the teacher-forced forward (2e-3) with nothing dropped.

The CUDA ``moe_gmm`` kernel is held against the plain version in
``tests/test_torch_cuda.py`` (card only) and by ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import get_config as j_get_config
from repro.kernels import ref as jref
from repro.kernels.moe_gmm import moe_gmm as pl_gmm
from repro.models import moe as jmoe
from repro.models.api import get_model as j_get_model
from repro.models.runtime import RuntimeOptions as JRuntimeOptions
from repro_torch.configs.registry import get_config
from repro_torch.kernels import moe_gmm as kgmm
from repro_torch.kernels import ops
from repro_torch.models import moe
from repro_torch.models.api import get_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.runtime import RuntimeOptions
from repro_torch.testing import assert_bitwise, assert_close

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)
ARCH = "phi3.5-moe-42b-a6.6b-reduced"

# (E, C, d, f): tests/test_kernels.py:113, then C and f off the blocks
GMM_CASES = [(4, 64, 32, 48), (2, 100, 64, 128), (3, 37, 24, 50),
             (2, 5, 16, 33)]


def gmm_inputs(case, seed=0):
    E, C, d, f = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((E, C, d)).astype(np.float32)
    wg = (rng.standard_normal((E, d, f)) / d ** 0.5).astype(np.float32)
    wu = (rng.standard_normal((E, d, f)) / d ** 0.5).astype(np.float32)
    wd = (rng.standard_normal((E, f, d)) / f ** 0.5).astype(np.float32)
    return x, wg, wu, wd


@pytest.mark.parametrize("case", GMM_CASES, ids=lambda c: "-".join(map(
    str, c)))
def test_moe_gmm_matches_jax_ref_and_pallas(case):
    args = gmm_inputs(case)
    got = ops.moe_gmm(*map(torch.from_numpy, args))
    assert tuple(got.shape) == args[0].shape
    assert_close(got, jref.moe_gmm(*map(jnp.asarray, args)), "vs ref")
    assert_close(got, pl_gmm(*map(jnp.asarray, args), block_c=32,
                             block_f=32, interpret=True), "vs Pallas")


def test_moe_gmm_kernel_wrapper_refuses_cpu_tensors():
    args = list(map(torch.from_numpy, gmm_inputs(GMM_CASES[0])))
    with pytest.raises(ValueError, match="CUDA tensors"):
        kgmm.moe_gmm(*args)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.moe_gmm(*args, impl="cuda")


def test_capacity_matches_the_reference():
    for S in (1, 2, 7, 24, 64, 2048, 2050):
        for k, E in ((2, 16), (2, 4), (6, 64), (1, 8)):
            for cf in (0.5, 1.0, 1.25, 8.0, 16.0):
                assert moe._capacity(S, k, E, cf) == \
                    jmoe._capacity(S, k, E, cf), (S, k, E, cf)
    assert moe._capacity(1, 2, 16, 1.25) == 4           # phi3.5 decode
    assert moe._capacity(2048, 2, 16, 1.25) == 324      # phi3.5 prefill


def _moe_params(arch, seed=0, skew=0.0):
    """Both packages' cfg and (the same) MoE params; ``skew`` tilts the
    router towards expert 0 so its capacity overflows."""
    cfg_j = j_get_config(arch)
    p_j = jmoe.init_moe(jax.random.PRNGKey(seed), cfg_j)
    if skew:
        p_j["router"] = p_j["router"].at[:, 0].add(skew)
    return cfg_j, p_j, get_config(arch), params_from_numpy(
        jax.tree.map(np.asarray, p_j))


def _capture(module, monkeypatch):
    """Record what ``module.ops.moe_gmm`` is handed (and still compute)."""
    seen = []
    real = module.ops.moe_gmm

    def spy(xe, *a, **kw):
        seen.append(np.array(xe))
        return real(xe, *a, **kw)
    monkeypatch.setattr(module.ops, "moe_gmm", spy)
    return seen


def _rank_in_expert(top_e):
    """Independent count: a choice's rank is the number of earlier
    choices (in (token, k) order) of its sequence for the same expert."""
    B = top_e.shape[0]
    flat = top_e.reshape(B, -1)
    pos = np.zeros_like(flat)
    for b in range(B):
        seen = {}
        for i, e in enumerate(flat[b]):
            pos[b, i] = seen.get(int(e), 0)
            seen[int(e)] = pos[b, i] + 1
    return pos


# (arch, capacity_factor, router skew): overflow with cf 0.5 and a skew
ROUTE_CASES = [(ARCH, 1.25, 0.0), (ARCH, 0.5, 0.0), (ARCH, 1.25, 2.0),
               ("deepseek-v2-lite-16b-reduced", 1.25, 0.0)]


@pytest.mark.parametrize("arch,cf,skew", ROUTE_CASES)
def test_routing_and_dispatch_identical_to_jax(arch, cf, skew,
                                               monkeypatch):
    cfg_j, p_j, cfg, p = _moe_params(arch, skew=skew)
    B, S = 3, 24
    x = np.random.default_rng(1).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    r = moe.route(p, torch.from_numpy(x), cfg, cf)
    logits = jnp.asarray(x) @ p_j["router"]
    _, top_e_j = jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                               cfg.moe.top_k)
    assert_bitwise(r.top_e.numpy(), np.asarray(top_e_j).astype(np.int64),
                   "top_e")
    pos = _rank_in_expert(r.top_e.numpy())
    assert_bitwise(r.pos_in_e.numpy(), pos, "pos_in_e")
    assert_bitwise(r.keep.numpy(), pos < r.capacity, "keep")
    if cf < 1 or skew:
        assert not bool(r.keep.all())              # capacity overflowed
    seen_j = _capture(jmoe, monkeypatch)
    seen = _capture(moe, monkeypatch)
    yw, aux_w = jmoe.moe_apply(p_j, jnp.asarray(x), cfg_j,
                               capacity_factor=cf)
    y, aux = moe.moe_apply(p, torch.from_numpy(x), cfg, capacity_factor=cf)
    assert len(seen) == len(seen_j) == 1
    assert_bitwise(seen[0], seen_j[0], "dispatched [E, B*C, d] buffer")
    assert_close(y, yw, "moe_apply y")
    assert_close(aux, aux_w, "aux")


# (arch, S, B): a decode step and a prefill
DISPATCH_CASES = [(ARCH, 1, 4), (ARCH, 24, 3),
                  ("deepseek-v2-lite-16b-reduced", 1, 4),
                  ("deepseek-v2-lite-16b-reduced", 24, 3)]


@pytest.mark.parametrize("arch,S,B", DISPATCH_CASES)
def test_dispatch_helper_builds_the_buffer_moe_gmm_receives(arch, S, B,
                                                            monkeypatch):
    """``moe.dispatch`` (shared by the layer and ``chip_smoke.py``'s
    routed decode shapes) gives, bitwise, the ``[E, B·C, d]`` buffer that
    ``moe_gmm`` receives in the port's layer and in the JAX package's."""
    cfg_j, p_j, cfg, p = _moe_params(arch)
    x = np.random.default_rng(S).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    r = moe.route(p, torch.from_numpy(x), cfg, 1.25)
    dp = moe.dispatch(torch.from_numpy(x), r, cfg.moe.n_routed_experts)
    assert tuple(dp.xe.shape) == (cfg.moe.n_routed_experts,
                                  B * r.capacity, cfg.d_model)
    seen_j = _capture(jmoe, monkeypatch)
    seen = _capture(moe, monkeypatch)
    jmoe.moe_apply(p_j, jnp.asarray(x), cfg_j, capacity_factor=1.25)
    moe.moe_apply(p, torch.from_numpy(x), cfg, capacity_factor=1.25)
    assert_bitwise(dp.xe.numpy(), seen[0], "port layer's buffer")
    assert_bitwise(dp.xe.numpy(), seen_j[0], "JAX package's buffer")


def _lm():
    cfg_j, rt_j = j_get_config(ARCH), JRuntimeOptions()
    params_j = j_get_model(cfg_j).init(KEY, cfg_j, rt_j)
    cfg, rt = get_config(ARCH), RuntimeOptions()
    return (cfg_j, rt_j, params_j, cfg, rt,
            params_from_numpy(jax.tree.map(np.asarray, params_j)))


def test_moe_lm_matches_jax():
    cfg_j, rt_j, params_j, cfg, rt, params = _lm()
    jm, tm = j_get_model(cfg_j), get_model(cfg)
    B, S = 2, 24
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S + 2)).astype(np.int32)
    want, aux_w = jm.forward(params_j, jnp.asarray(toks[:, :S]), cfg_j, rt_j)
    got, aux = tm.forward(params, torch.from_numpy(toks[:, :S]), cfg, rt)
    assert_close(got, want, "forward")
    assert_close(aux, aux_w, "aux")
    assert float(aux) > 0
    lw, cw = jm.prefill(params_j, jnp.asarray(toks[:, :S]), cfg_j, rt_j,
                        max_len=S + 3)
    lg, cg = tm.prefill(params, torch.from_numpy(toks[:, :S]), cfg, rt,
                        max_len=S + 3)
    assert_close(lg, lw, "prefill logits")
    for t in range(-1, 2):
        if t >= 0:
            lw, cw = jm.decode_step(params_j, cw,
                                    jnp.asarray(toks[:, S + t]), cfg_j, rt_j)
            lg, cg = tm.decode_step(params, cg,
                                    torch.from_numpy(toks[:, S + t]), cfg, rt)
            assert_close(lg, lw, f"decode step {t}")
        assert cg["idx"] == int(cw["idx"])
        assert_bitwise(cg["pos"], np.asarray(cw["pos"]), "pos")
        (sg,), (sw,) = cg["segments"], cw["segments"]
        for name in sg:
            assert_close(sg[name], sw[name], f"step {t}: cache {name}")


def test_moe_cached_decode_matches_teacher_forced_forward():
    """``tests/test_arch_smoke.py:71`` inside the port: capacity relaxed
    (E / top_k) so that no choice is dropped at any S."""
    cfg = get_config(ARCH)
    rt = RuntimeOptions(capacity_factor=cfg.moe.n_routed_experts
                        / cfg.moe.top_k)
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


def test_moe_experts_scale_by_their_first_axis():
    """The reference scales an ``[E, d, f]`` expert leaf by
    ``1/sqrt(E)`` (its per-layer ``shape[0]``), not by d."""
    cfg = get_config(ARCH)
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, torch.float32,
                     torch.device("cpu"), (2,))
    E = cfg.moe.n_routed_experts
    assert tuple(p["w_gate"].shape) == (2, E, cfg.d_model,
                                        cfg.moe.expert_d_ff)
    std = 0.87962566 / E ** 0.5
    assert abs(float(p["w_gate"].std()) / std - 1) < 0.03
    assert abs(float(p["router"].std()) * cfg.d_model ** 0.5 / 0.87962566
               - 1) < 0.05


@pytest.mark.parametrize("arch", [ARCH, "qwen3-4b-reduced"])
def test_prefill_and_decode_collect_each_moe_layers_input(arch):
    """``moe_inputs`` receives one ``[B, S, d]`` input a MoE layer, in
    layer order (none for a dense model), changes no logit, and feeds
    ``moe_apply`` as it is."""
    from repro_torch.models import transformer

    cfg, rt = get_config(arch), RuntimeOptions()
    m = get_model(cfg)
    params = m.init(torch.Generator().manual_seed(0), cfg, rt, "cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 13)).astype(np.int32))
    n_moe = sum(n for bt, n, _ in transformer.segments(cfg)
                if bt == "attn_moe")
    seen = []
    lg, cache = m.prefill(params, toks[:, :12], cfg, rt, moe_inputs=seen)
    want, cache_w = m.prefill(params, toks[:, :12], cfg, rt)
    assert_bitwise(lg, want, "prefill logits")
    assert len(seen) == n_moe
    assert all(tuple(h.shape) == (2, 12, cfg.d_model) for h in seen)
    step = []
    lg, _ = m.decode_step(params, cache, toks[:, 12], cfg, rt,
                          moe_inputs=step)
    want, _ = m.decode_step(params, cache_w, toks[:, 12], cfg, rt)
    assert_bitwise(lg, want, "decode logits")
    assert len(step) == n_moe
    assert all(tuple(h.shape) == (2, 1, cfg.d_model) for h in step)
    if n_moe:
        p0 = transformer._layer(params["segments"][0], 0)["mlp"]
        y, _ = moe.moe_apply(p0, seen[0], cfg,
                             capacity_factor=rt.capacity_factor)
        assert tuple(y.shape) == (2, 12, cfg.d_model)
        assert torch.isfinite(y).all()
