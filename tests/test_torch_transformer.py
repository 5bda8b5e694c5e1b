"""The port's dense/VLM language model against the JAX package's.

Weights are the JAX package's own (``init_lm``), carried across with
``models/convert.py``; tokens and prefix embeddings come from numpy with
a seed.  Against JAX ``impl="xla"`` (the reference's serving default),
within the one tolerance of ``repro_torch.testing``:

* ``forward`` logits, ``prefill`` logits and every cache leaf (``pos``
  bitwise), and two teacher-fed ``decode_step``s with the cache after
  each, for qwen3-4b (qk_norm), smollm-360m (tied embeddings),
  granite-20b (attention bias, MQA), internvl2-26b (prefix embeds), a
  window shorter than the prompt (the rolled ring), ``attn_chunk`` and
  ``kv_mult``, all reduced;
* the layers, the configs and the init's scale.

And the reference's own invariants inside the port: cached decode equals
the teacher-forced forward within 2e-3 (``tests/test_arch_smoke.py:71``)
and a window at least the sequence long equals full attention (``:124``).
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import ARCH_IDS as J_ARCH_IDS
from repro.configs.registry import get_config as j_get_config
from repro.models import layers as jlayers
from repro.models.api import get_model as j_get_model
from repro.models.runtime import RuntimeOptions as JRuntimeOptions
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.launch import serve
from repro_torch.models import encdec, hybrid, layers, transformer
from repro_torch.models.api import get_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.runtime import RuntimeOptions
from repro_torch.testing import assert_bitwise, assert_close

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)
B, S = 2, 24

# (arch, RuntimeOptions kwargs shared by both packages)
VARIANTS = [
    ("qwen3-4b-reduced", {}),
    ("smollm-360m-reduced", {}),
    ("granite-20b-reduced", {}),
    ("internvl2-26b-reduced", {}),
    ("qwen3-4b-reduced", {"window": 16}),        # S > window: ring roll
    ("qwen3-4b-reduced", {"attn_chunk": 16}),
    ("granite-20b-reduced", {"kv_mult": 2}),
]


def _model(arch, rt_kw):
    """Both packages' config, options and (the same) params."""
    cfg_j = j_get_config(arch)
    rt_j = JRuntimeOptions(**rt_kw)
    params_j = j_get_model(cfg_j).init(KEY, cfg_j, rt_j)
    cfg, rt = get_config(arch), RuntimeOptions(**rt_kw)
    params = params_from_numpy(jax.tree.map(np.asarray, params_j))
    return cfg_j, rt_j, params_j, cfg, rt, params


def _inputs(cfg, n_tok, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, n_tok)).astype(np.int32)
    pe = None
    if cfg.n_prefix_tokens and cfg.frontend_dim:
        pe = rng.standard_normal((B, cfg.n_prefix_tokens,
                                  cfg.frontend_dim)).astype(np.float32)
    return toks, pe


def _opt(fn, a):
    return None if a is None else fn(a)


def _assert_cache(got, want, what):
    assert got["idx"] == int(want["idx"]), what
    assert_bitwise(got["pos"], np.asarray(want["pos"]), f"{what}: pos")
    assert len(got["segments"]) == len(want["segments"])
    for si, (cg, cw) in enumerate(zip(got["segments"], want["segments"])):
        assert set(cg) == set(cw)
        for name in cg:
            assert_close(cg[name], np.asarray(cw[name]),
                         f"{what}: segment {si} {name}")


@pytest.mark.parametrize("arch,rt_kw", VARIANTS,
                         ids=[f"{a}-{'-'.join(f'{k}{v}' for k, v in kw.items())}"
                              for a, kw in VARIANTS])
def test_lm_matches_jax(arch, rt_kw):
    cfg_j, rt_j, params_j, cfg, rt, params = _model(arch, rt_kw)
    jm, tm = j_get_model(cfg_j), get_model(cfg)
    toks, pe = _inputs(cfg, S + 2)
    pe_j, pe_t = _opt(jnp.asarray, pe), _opt(torch.from_numpy, pe)

    want, _ = jm.forward(params_j, jnp.asarray(toks[:, :S]), cfg_j, rt_j,
                         prefix_embeds=pe_j)
    got, _ = tm.forward(params, torch.from_numpy(toks[:, :S]), cfg, rt,
                        prefix_embeds=pe_t)
    assert tuple(got.shape) == want.shape
    assert_close(got, want, "forward")

    max_len = S + 3 + (cfg.n_prefix_tokens if cfg.family == "vlm" else 0)
    lw, cw = jm.prefill(params_j, jnp.asarray(toks[:, :S]), cfg_j, rt_j,
                        prefix_embeds=pe_j, max_len=max_len)
    lg, cg = tm.prefill(params, torch.from_numpy(toks[:, :S]), cfg, rt,
                        prefix_embeds=pe_t, max_len=max_len)
    assert_close(lg, lw, "prefill logits")
    _assert_cache(cg, cw, "prefill")
    if rt_kw.get("window"):
        assert cg["pos"].shape[0] == rt_kw["window"] < S     # rolled ring
    for t in range(2):
        lw, cw = jm.decode_step(params_j, cw, jnp.asarray(toks[:, S + t]),
                                cfg_j, rt_j)
        lg, cg = tm.decode_step(params, cg, torch.from_numpy(toks[:, S + t]),
                                cfg, rt)
        assert_close(lg, lw, f"decode step {t}")
        _assert_cache(cg, cw, f"decode step {t}")


@pytest.mark.parametrize("arch", ["qwen3-4b-reduced", "smollm-360m-reduced",
                                  "granite-20b-reduced",
                                  "command-r-35b-reduced",
                                  "internvl2-26b-reduced"])
def test_cached_decode_matches_teacher_forced_forward(arch):
    """``tests/test_arch_smoke.py:71`` inside the port."""
    cfg = get_config(arch)
    rt = RuntimeOptions()
    m = get_model(cfg)
    params = m.init(torch.Generator().manual_seed(0), cfg, rt, "cpu")
    toks, pe = _inputs(cfg, S + 2, seed=1)
    toks = torch.from_numpy(toks)
    pe = _opt(torch.from_numpy, pe)
    full, _ = m.forward(params, toks, cfg, rt, prefix_embeds=pe)
    off = cfg.n_prefix_tokens if cfg.family == "vlm" else 0
    lg, cache = m.prefill(params, toks[:, :S], cfg, rt, prefix_embeds=pe)
    tol = dict(rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(lg, full[:, off + S - 1], **tol)
    for t in range(2):
        lg, cache = m.decode_step(params, cache, toks[:, S + t], cfg, rt)
        np.testing.assert_allclose(lg, full[:, off + S + t], **tol)


def test_window_at_least_the_sequence_equals_full_attention():
    """``tests/test_arch_smoke.py:124`` inside the port."""
    cfg = get_config("qwen3-4b-reduced")
    m = get_model(cfg)
    params = m.init(torch.Generator().manual_seed(0), cfg, RuntimeOptions(),
                    "cpu")
    toks = torch.from_numpy(_inputs(cfg, S)[0])
    full, _ = m.forward(params, toks, cfg, RuntimeOptions())
    win, _ = m.forward(params, toks, cfg, RuntimeOptions(window=S))
    np.testing.assert_allclose(full, win, rtol=1e-5, atol=1e-5)


def test_configs_match_the_reference():
    assert ARCH_IDS == J_ARCH_IDS
    for arch in ARCH_IDS:
        for name in (arch, arch + "-reduced"):
            mine, ref = get_config(name), j_get_config(name)
            assert dataclasses.asdict(mine) == dataclasses.asdict(ref), name
            assert mine.param_count() == ref.param_count()
            assert mine.padded_vocab == ref.padded_vocab
            assert mine.flops_per_token(2048) == ref.flops_per_token(2048)
    assert get_config("qwen3-4b").param_count() == 4_411_228_160


def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 32)).astype(np.float32) * 3
    scale = rng.standard_normal(32).astype(np.float32)
    pos = np.array([0, 1, 7, 100, 2047], np.int32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    assert_close(layers.rms_norm(xt, {"scale": torch.from_numpy(scale)}),
                 jlayers.rms_norm(xj, {"scale": jnp.asarray(scale)}))
    for theta in (10_000.0, 1_000_000.0):
        assert_close(layers.apply_rope(xt, torch.from_numpy(pos), theta),
                     jlayers.apply_rope(xj, jnp.asarray(pos), theta))
    p = {k: {"w": rng.standard_normal((32, 48) if k != "down" else (48, 32))
             .astype(np.float32) / 6} for k in ("gate", "up", "down")}
    assert_close(layers.swiglu(params_from_numpy(p), xt),
                 jlayers.swiglu(jax.tree.map(jnp.asarray, p), xj))


def test_stacked_init_scales_by_the_per_layer_fan_in():
    """A stacked ``[L, d_in, d_out]`` leaf is drawn per layer with
    ``stddev = 1/sqrt(d_in)`` (the reference vmaps over layer keys), and
    the normal is truncated to [-2, 2]: std ``0.8796 / sqrt(d_in)``."""
    cfg = get_config("qwen3-4b-reduced")
    params = transformer.init_lm(torch.Generator().manual_seed(0), cfg,
                                 RuntimeOptions(), "cpu")
    seg = params["segments"][0]
    for w, d_in in ((seg["mlp"]["gate"]["w"], cfg.d_model),
                    (seg["mlp"]["down"]["w"], cfg.d_ff),
                    (params["embed"]["head"], cfg.d_model),
                    (params["embed"]["table"], cfg.padded_vocab)):
        std = 0.87962566 / d_in ** 0.5
        assert abs(float(w.std()) / std - 1) < 0.03, (w.shape, d_in)
        assert float(w.abs().max()) <= 2 * std / 0.87962566 + 1e-7
    assert seg["mlp"]["gate"]["w"].shape == (cfg.num_layers, cfg.d_model,
                                             cfg.d_ff)
    assert not torch.equal(seg["mlp"]["gate"]["w"][0],
                           seg["mlp"]["gate"]["w"][1])
    assert torch.equal(seg["ln1"]["scale"], torch.ones(cfg.num_layers,
                                                       cfg.d_model))


def test_later_families_name_their_slice():
    """Every one of the ten arch ids gets a ``ModelApi``: hybrid and
    enc-dec from their own modules (ROADMAP §1 item 13.5), the rest
    from ``transformer.py`` (MLA and MoE among them)."""
    by_family = {"hybrid": (hybrid, hybrid.init_hybrid),
                 "encdec": (encdec, encdec.init_encdec)}
    for arch in ARCH_IDS:
        for name in (arch, arch + "-reduced"):
            cfg = get_config(name)
            mod, init = by_family.get(cfg.family,
                                      (transformer, transformer.init_lm))
            api = get_model(cfg)
            assert (api.init, api.forward, api.prefill, api.decode_step,
                    api.init_cache) == (init, mod.forward, mod.prefill,
                                        mod.decode_step, mod.init_cache)
    with pytest.raises(ValueError, match="unknown family"):
        get_model(dataclasses.replace(get_config("qwen3-4b"),
                                      family="rnn"))
    cfg = get_config("deepseek-v2-lite-16b-reduced")           # MLA
    params = transformer.init_lm(torch.Generator(), cfg, RuntimeOptions(),
                                 "cpu")
    assert "w_uk" in params["segments"][0]["attn"]


def test_serve_main_runs_on_the_cpu(capsys):
    assert serve.main(["--arch", "qwen3-4b-reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "16",
                       "--new-tokens", "3"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("generated tokens[0,:16]: ")
    assert len(json.loads(out[0].split(": ", 1)[1].replace("'", '"'))) == 4
    rec = json.loads(out[-1])
    for key in ("arch", "batch", "prefill_s", "decode_tok_per_s",
                "decode_ms_per_token"):
        assert key in rec
    assert rec["device"] == "cpu"


@pytest.mark.parametrize("arch", ["zamba2-7b-reduced",
                                  "seamless-m4t-medium-reduced"])
def test_serve_main_runs_hybrid_and_encdec_on_the_cpu(capsys, arch):
    assert serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                       "--prompt-len", "16", "--new-tokens", "3"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("generated tokens[0,:16]: ")
    assert len(json.loads(out[0].split(": ", 1)[1])) == 4
    rec = json.loads(out[-1])
    assert rec["arch"] == arch and rec["device"] == "cpu"
    for key in ("prefill_s", "decode_tok_per_s", "decode_ms_per_token"):
        assert rec[key] > 0
