"""The port's zamba2-style hybrid (``models/hybrid.py``) against the JAX
package's.

Weights are the JAX package's own (``init_hybrid``), carried across with
``models/convert.py``; tokens come from numpy with a seed.  Against JAX
``impl="xla"``, within the one tolerance of ``repro_torch.testing``:
``forward`` logits, ``prefill`` logits and every cache leaf (``pos``
bitwise), and two teacher-fed ``decode_step``s with the cache after
each.  Two schedules: ``reduced()`` as it is (2 layers, the shared block
every 2: one super-block, no tail) and 5 layers with the shared block
every 2 (two invocations of the shared block, each with its own ring,
and a tail layer), the latter also under a window shorter than the
prompt (the rolled ring) and with ``kv_mult = 2``.

And the reference's own invariant inside the port: cached decode equals
the teacher-forced forward within 2e-3 (``tests/test_arch_smoke.py:71``).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import get_config as j_get_config
from repro.models.api import get_model as j_get_model
from repro.models.runtime import RuntimeOptions as JRuntimeOptions
from repro_torch.configs.registry import get_config
from repro_torch.models import hybrid
from repro_torch.models.api import get_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.runtime import RuntimeOptions
from repro_torch.testing import assert_bitwise, assert_close

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)
B, S = 2, 24
ARCH = "zamba2-7b-reduced"
# two invocations of the shared block (own rings) and a tail layer
TWO_AND_TAIL = {"num_layers": 5, "shared_attn_every": 2}

# (config overrides, RuntimeOptions kwargs shared by both packages)
VARIANTS = [
    ({}, {}),
    (TWO_AND_TAIL, {}),
    (TWO_AND_TAIL, {"window": 16}),        # S > window: ring roll
    (TWO_AND_TAIL, {"kv_mult": 2}),
]


def _ids(variant):
    cfg_kw, rt_kw = variant
    return "-".join([f"L{cfg_kw['num_layers']}" if cfg_kw else "reduced"]
                    + [f"{k}{v}" for k, v in rt_kw.items()])


def _model(cfg_kw, rt_kw):
    """Both packages' config, options and (the same) params."""
    cfg_j = dataclasses.replace(j_get_config(ARCH), **cfg_kw)
    rt_j = JRuntimeOptions(**rt_kw)
    params_j = j_get_model(cfg_j).init(KEY, cfg_j, rt_j)
    cfg = dataclasses.replace(get_config(ARCH), **cfg_kw)
    rt = RuntimeOptions(**rt_kw)
    params = params_from_numpy(jax.tree.map(np.asarray, params_j))
    return cfg_j, rt_j, params_j, cfg, rt, params


def _tokens(cfg, n_tok, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, n_tok)).astype(np.int32)


def _assert_tree(got, want, what):
    assert set(got) == set(want), what
    for name in got:
        g, w = got[name], want[name]
        if name == "idx":
            assert g == int(w), what
        elif name == "pos":
            assert_bitwise(g, np.asarray(w), f"{what}: pos")
        elif isinstance(g, dict):
            _assert_tree(g, w, f"{what}: {name}")
        else:
            assert tuple(g.shape) == w.shape, f"{what}: {name}"
            assert_close(g, np.asarray(w), f"{what}: {name}")


def test_schedules_cover_invocations_and_tail():
    assert hybrid._schedule(get_config(ARCH)) == (1, 2, 0)
    cfg = dataclasses.replace(get_config(ARCH), **TWO_AND_TAIL)
    assert hybrid._schedule(cfg) == (2, 2, 1)
    assert hybrid._schedule(get_config("zamba2-7b")) == (13, 6, 3)


@pytest.mark.parametrize("variant", VARIANTS, ids=_ids)
def test_hybrid_matches_jax(variant):
    cfg_kw, rt_kw = variant
    cfg_j, rt_j, params_j, cfg, rt, params = _model(cfg_kw, rt_kw)
    jm, tm = j_get_model(cfg_j), get_model(cfg)
    toks = _tokens(cfg, S + 2)

    want, _ = jm.forward(params_j, jnp.asarray(toks[:, :S]), cfg_j, rt_j)
    got, aux = tm.forward(params, torch.from_numpy(toks[:, :S]), cfg, rt)
    assert tuple(got.shape) == want.shape and float(aux) == 0.0
    assert_close(got, want, "forward")

    lw, cw = jm.prefill(params_j, jnp.asarray(toks[:, :S]), cfg_j, rt_j,
                        max_len=S + 3)
    lg, cg = tm.prefill(params, torch.from_numpy(toks[:, :S]), cfg, rt,
                        max_len=S + 3)
    assert_close(lg, lw, "prefill logits")
    _assert_tree(cg, cw, "prefill")
    if rt_kw.get("window"):
        assert cg["pos"].shape[0] == rt_kw["window"] < S     # rolled ring
    for t in range(2):
        lw, cw = jm.decode_step(params_j, cw, jnp.asarray(toks[:, S + t]),
                                cfg_j, rt_j)
        lg, cg = tm.decode_step(params, cg, torch.from_numpy(toks[:, S + t]),
                                cfg, rt)
        assert_close(lg, lw, f"decode step {t}")
        _assert_tree(cg, cw, f"decode step {t}")


@pytest.mark.parametrize("cfg_kw", [{}, TWO_AND_TAIL],
                         ids=["reduced", "L5"])
def test_cached_decode_matches_teacher_forced_forward(cfg_kw):
    """``tests/test_arch_smoke.py:71`` inside the port."""
    cfg = dataclasses.replace(get_config(ARCH), **cfg_kw)
    rt = RuntimeOptions()
    m = get_model(cfg)
    params = m.init(torch.Generator().manual_seed(0), cfg, rt, "cpu")
    toks = torch.from_numpy(_tokens(cfg, S + 2, seed=1))
    full, _ = m.forward(params, toks, cfg, rt)
    lg, cache = m.prefill(params, toks[:, :S], cfg, rt)
    tol = dict(rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(lg, full[:, S - 1], **tol)
    for t in range(2):
        lg, cache = m.decode_step(params, cache, toks[:, S + t], cfg, rt)
        np.testing.assert_allclose(lg, full[:, S + t], **tol)


def test_layout_matches_jax_and_shares_one_block():
    """The port's init and empty cache have the reference's tree, leaf
    for leaf: the mamba blocks stacked ``[ns, k, ...]`` and ``[tail,
    ...]``, ONE shared block (no leading axis), a ring an invocation.
    Each invocation writes its own ring, and decode steps every ring
    and each mamba state in place."""
    cfg_kw = TWO_AND_TAIL
    cfg_j = dataclasses.replace(j_get_config(ARCH), **cfg_kw)
    cfg = dataclasses.replace(get_config(ARCH), **cfg_kw)
    rt, rt_j = RuntimeOptions(), JRuntimeOptions()
    shapes = lambda tree: jax.tree.map(lambda a: tuple(a.shape), tree)
    mine = hybrid.init_hybrid(torch.Generator().manual_seed(0), cfg, rt,
                              "cpu")
    ref = j_get_model(cfg_j).init(KEY, cfg_j, rt_j)
    assert shapes(jax.tree.map(np.asarray, ref)) == shapes(
        jax.tree.map(lambda t: t.numpy(), mine))
    assert mine["shared"]["attn"]["wq"]["w"].dim() == 2
    c_mine = hybrid.init_cache(cfg, rt, B, 40, "cpu")
    c_ref = j_get_model(cfg_j).init_cache(cfg_j, rt_j, B, 40)
    c_mine = dict(c_mine, idx=np.zeros((), np.int32))
    assert shapes(jax.tree.map(np.asarray, c_ref)) == shapes(
        jax.tree.map(np.asarray, c_mine))

    toks = torch.from_numpy(_tokens(cfg, S + 1))
    _, cache = hybrid.prefill(mine, toks[:, :S], cfg, rt, max_len=S + 1)
    ring = cache["attn"]["k"]
    assert not torch.equal(ring[0], ring[1])        # own ring each
    ptrs = [ring.data_ptr(), cache["mamba_main"]["ssm"].data_ptr(),
            cache["mamba_tail"]["ssm"].data_ptr(), cache["pos"].data_ptr()]
    before = ring[:, :, S].clone()
    _, stepped = hybrid.decode_step(mine, cache, toks[:, S], cfg, rt)
    assert stepped["idx"] == S + 1
    assert [stepped["attn"]["k"].data_ptr(),
            stepped["mamba_main"]["ssm"].data_ptr(),
            stepped["mamba_tail"]["ssm"].data_ptr(),
            stepped["pos"].data_ptr()] == ptrs
    assert int(stepped["pos"][S]) == S
    after = stepped["attn"]["k"][:, :, S]
    assert not torch.equal(after[0], before[0])
    assert not torch.equal(after[1], before[1])
    assert not torch.equal(after[0], after[1])
