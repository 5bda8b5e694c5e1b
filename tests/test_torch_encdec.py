"""The port's seamless-style encoder-decoder (``models/encdec.py``) and
cross-attention (``models/attention.py::cross_apply``) against the JAX
package's.

Weights are the JAX package's own (``init_encdec``, ``init_cross``),
carried across with ``models/convert.py``; tokens and audio frame
embeddings come from numpy with a seed.  Against JAX ``impl="xla"``,
within the one tolerance of ``repro_torch.testing``: ``encode`` alone;
``cross_apply`` alone at S > 1 and at S = 1 against 8 frames; and
``forward`` logits, ``prefill`` logits and every cache leaf (``pos``
bitwise), and two teacher-fed ``decode_step``s with the cache after
each, as ``reduced()`` gives the model, under a decoder window shorter
than the prompt, with ``kv_mult = 2`` and with ``attn_chunk``.

And the reference's own invariant inside the port: cached decode equals
the teacher-forced forward within 2e-3 (``tests/test_arch_smoke.py:71``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import get_config as j_get_config
from repro.models import attention as jattn
from repro.models import encdec as jencdec
from repro.models.api import get_model as j_get_model
from repro.models.runtime import RuntimeOptions as JRuntimeOptions
from repro_torch.configs.registry import get_config
from repro_torch.models import attention, encdec
from repro_torch.models.api import get_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.runtime import RuntimeOptions
from repro_torch.testing import assert_bitwise, assert_close

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)
B, S = 2, 24
ARCH = "seamless-m4t-medium-reduced"

VARIANTS = [{}, {"window": 16}, {"kv_mult": 2}, {"attn_chunk": 16}]


def _model(rt_kw):
    """Both packages' config, options and (the same) params."""
    cfg_j, rt_j = j_get_config(ARCH), JRuntimeOptions(**rt_kw)
    params_j = j_get_model(cfg_j).init(KEY, cfg_j, rt_j)
    params = params_from_numpy(jax.tree.map(np.asarray, params_j))
    return cfg_j, rt_j, params_j, get_config(ARCH), RuntimeOptions(**rt_kw), \
        params


def _inputs(cfg, n_tok, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, n_tok)).astype(np.int32)
    frames = rng.standard_normal((B, cfg.n_prefix_tokens,
                                  cfg.frontend_dim)).astype(np.float32)
    return toks, frames


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


def test_encode_matches_jax():
    cfg_j, rt_j, params_j, cfg, rt, params = _model({})
    _, frames = _inputs(cfg, 1)
    want = jencdec.encode(params_j, jnp.asarray(frames), cfg_j, rt_j)
    got = encdec.encode(params, torch.from_numpy(frames), cfg, rt)
    assert tuple(got.shape) == (B, cfg.n_prefix_tokens, cfg.d_model)
    assert_close(got, want, "encode")


@pytest.mark.parametrize("S_q", [5, 1])
def test_cross_apply_matches_jax(S_q):
    """Not causal, all-zero positions, T = 8 frames != S: S > 1 is a
    prefill (``flash_attention`` on the card), S = 1 a decode step
    (``decode_attention``)."""
    cfg_j, cfg = j_get_config(ARCH), get_config(ARCH)
    p_j = jattn.init_cross(KEY, cfg_j)
    p = params_from_numpy(jax.tree.map(np.asarray, p_j))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S_q, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, 8, cfg.d_model)).astype(np.float32)
    want = jattn.cross_apply(p_j, jnp.asarray(x), jnp.asarray(enc), cfg_j)
    got = attention.cross_apply(p, torch.from_numpy(x),
                                torch.from_numpy(enc), cfg)
    assert tuple(got.shape) == (B, S_q, cfg.d_model)
    assert_close(got, want, f"cross_apply S={S_q}")


@pytest.mark.parametrize("rt_kw", VARIANTS, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()) or "reduced")
def test_encdec_matches_jax(rt_kw):
    cfg_j, rt_j, params_j, cfg, rt, params = _model(rt_kw)
    jm, tm = j_get_model(cfg_j), get_model(cfg)
    toks, frames = _inputs(cfg, S + 2)
    fj, ft = jnp.asarray(frames), torch.from_numpy(frames)

    want, _ = jm.forward(params_j, jnp.asarray(toks[:, :S]), cfg_j, rt_j,
                         prefix_embeds=fj)
    got, aux = tm.forward(params, torch.from_numpy(toks[:, :S]), cfg, rt,
                          prefix_embeds=ft)
    assert tuple(got.shape) == want.shape and float(aux) == 0.0
    assert_close(got, want, "forward")

    lw, cw = jm.prefill(params_j, jnp.asarray(toks[:, :S]), cfg_j, rt_j,
                        prefix_embeds=fj, max_len=S + 3)
    lg, cg = tm.prefill(params, torch.from_numpy(toks[:, :S]), cfg, rt,
                        prefix_embeds=ft, max_len=S + 3)
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


def test_cached_decode_matches_teacher_forced_forward():
    """``tests/test_arch_smoke.py:71`` inside the port."""
    cfg, rt = get_config(ARCH), RuntimeOptions()
    m = get_model(cfg)
    params = m.init(torch.Generator().manual_seed(0), cfg, rt, "cpu")
    toks, frames = _inputs(cfg, S + 2, seed=1)
    toks, frames = torch.from_numpy(toks), torch.from_numpy(frames)
    full, _ = m.forward(params, toks, cfg, rt, prefix_embeds=frames)
    lg, cache = m.prefill(params, toks[:, :S], cfg, rt, prefix_embeds=frames)
    tol = dict(rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(lg, full[:, S - 1], **tol)
    for t in range(2):
        lg, cache = m.decode_step(params, cache, toks[:, S + t], cfg, rt)
        np.testing.assert_allclose(lg, full[:, S + t], **tol)


def test_layout_matches_jax():
    """The port's init and empty cache have the reference's tree, leaf
    for leaf (``enc`` and ``dec`` stacked over their layers, the cross
    weights in ``dec``); the cache keeps the encoder output and the
    decoder's rings, and a decode step writes them in place."""
    cfg_j, cfg = j_get_config(ARCH), get_config(ARCH)
    rt, rt_j = RuntimeOptions(), JRuntimeOptions()
    shapes = lambda tree: jax.tree.map(lambda a: tuple(np.shape(a)), tree)
    mine = encdec.init_encdec(torch.Generator().manual_seed(0), cfg, rt,
                              "cpu")
    ref = j_get_model(cfg_j).init(KEY, cfg_j, rt_j)
    assert shapes(jax.tree.map(np.asarray, ref)) == shapes(
        jax.tree.map(lambda t: t.numpy(), mine))
    c_mine = dict(encdec.init_cache(cfg, rt, B, 40, "cpu"),
                  idx=np.zeros((), np.int32))
    c_ref = jencdec.init_cache(cfg_j, rt_j, B, 40)
    assert shapes(jax.tree.map(np.asarray, c_ref)) == shapes(
        jax.tree.map(np.asarray, c_mine))

    toks, frames = _inputs(cfg, S + 1)
    toks, frames = torch.from_numpy(toks), torch.from_numpy(frames)
    _, cache = encdec.prefill(mine, toks[:, :S], cfg, rt,
                              prefix_embeds=frames, max_len=S + 1)
    assert tuple(cache["enc_out"].shape) == (B, cfg.n_prefix_tokens,
                                             cfg.d_model)
    ptrs = [cache["self"]["k"].data_ptr(), cache["pos"].data_ptr()]
    enc_out = cache["enc_out"].clone()
    _, stepped = encdec.decode_step(mine, cache, toks[:, S], cfg, rt)
    assert stepped["idx"] == S + 1 and int(stepped["pos"][S]) == S
    assert [stepped["self"]["k"].data_ptr(),
            stepped["pos"].data_ptr()] == ptrs
    assert torch.equal(stepped["enc_out"], enc_out)
