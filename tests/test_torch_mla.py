"""The port's MLA attention (DeepSeek-V2) and ``decode_attention`` against
the JAX package's.

Inputs come from numpy with a seed; weights are the JAX package's own,
carried across with ``models/convert.py``.  Against JAX ``impl="xla"``
(its MLA cannot run on its Pallas route: the Pallas ``flash_attention``
needs ``Dv == D``), within the one tolerance of ``repro_torch.testing``
unless stated:

* ``mla_apply``, materialized and absorbed, over a full sequence and at a
  cached decode step (a window shorter than the ring included): output
  and cache;
* absorbed against materialized inside the port within 2e-3 (the
  reference's own bound, ``tests/test_perf_levers.py:71``);
* ``deepseek-v2-lite-16b-reduced`` end to end, in both forms: forward,
  prefill logits and cache, four decode steps, with every MoE layer's
  routing identical to the reference's on the same input;
* the MLA params tree carried by ``convert.py``, and the cache layout
  (one latent buffer, two column views, written in place);
* the port's ``ref.decode_attention`` at ``Dv != D`` and with ``scale``
  against ``repro.kernels.ref.attention``, and against the Pallas
  ``decode_attention`` in interpret mode where ``Dv == D``;
* ``ops.decode_attention`` and ``ops.attention`` at ``S == 1``: CPU
  tensors run the plain versions; the kernels' wrappers refuse them;
* the kernel's split plan (pure arithmetic).

The CUDA kernels are held against the plain versions in
``tests/test_torch_cuda.py`` (card only) and by ``chip_smoke.py``.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import get_config as j_get_config
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pl_decode
from repro.models import attention as jattn
from repro.models.api import get_model as j_get_model
from repro.models.runtime import RuntimeOptions as JRuntimeOptions
from repro_torch.configs.registry import get_config
from repro_torch.kernels import decode_attention as kdecode
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve
from repro_torch.models import attention as attn
from repro_torch.models import moe, transformer
from repro_torch.models.api import get_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.runtime import RuntimeOptions
from repro_torch.testing import (SERVED_DECODE_PLANS, assert_bitwise,
                                 assert_close)

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)
ARCH = "deepseek-v2-lite-16b-reduced"
B, S = 2, 20


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _mla_params(seed=0):
    cfg_j = j_get_config(ARCH)
    p_j = jattn.init_mla(jax.random.PRNGKey(seed), cfg_j)
    return cfg_j, p_j, get_config(ARCH), params_from_numpy(
        jax.tree.map(np.asarray, p_j))


# (absorbed, window): a window shorter than the ring rolls off old keys
MLA_CASES = [(False, 0), (True, 0), (False, 8), (True, 8)]


@pytest.mark.parametrize("absorbed,window", MLA_CASES)
def test_mla_apply_full_sequence_matches_jax(absorbed, window):
    cfg_j, p_j, cfg, p = _mla_params()
    x = np.random.default_rng(0).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    yw, cw = jattn.mla_apply(p_j, jnp.asarray(x), jnp.asarray(pos), cfg_j,
                             window=window, absorbed=absorbed)
    y, c = attn.mla_apply(p, *_t(x, pos), cfg, window=window,
                          absorbed=absorbed)
    assert tuple(y.shape) == (B, S, cfg.d_model)
    assert_close(y, yw, "out")
    for name in ("ckv", "krope"):
        assert_close(c[name], cw[name], name)


@pytest.mark.parametrize("absorbed,window", MLA_CASES)
def test_mla_apply_cached_decode_matches_jax(absorbed, window):
    """One decode step against a partly filled ring (M = 24 slots, 17
    filled, the step's own slot written in place)."""
    cfg_j, p_j, cfg, p = _mla_params()
    m = cfg.mla
    M, fill = 24, 17
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    ckv = rng.standard_normal((B, M, m.kv_lora_rank)).astype(np.float32)
    krope = rng.standard_normal((B, M, m.qk_rope_head_dim)).astype(
        np.float32)
    kpos = np.where(np.arange(M) < fill, np.arange(M), -1).astype(np.int32)
    qpos = np.array([fill], np.int32)
    yw, cw = jattn.mla_apply(
        p_j, jnp.asarray(x), jnp.asarray(qpos), cfg_j,
        cache={"ckv": jnp.asarray(ckv), "krope": jnp.asarray(krope)},
        cache_pos=jnp.asarray(kpos), cache_idx=jnp.asarray(fill),
        window=window, absorbed=absorbed)
    cache = attn.mla_cache(torch.from_numpy(
        np.concatenate([ckv, krope], -1)), m.kv_lora_rank)
    tpos = torch.from_numpy(kpos.copy())
    y, c = attn.mla_apply(p, *_t(x, qpos), cfg, cache=cache, cache_pos=tpos,
                          cache_idx=fill, window=window, absorbed=absorbed)
    assert c is cache                                   # advanced in place
    assert_close(y, yw, "out")
    for name in ("ckv", "krope"):
        assert_close(c[name], cw[name], name)
    assert int(tpos[fill]) == fill


def test_mla_cache_is_one_latent_buffer_written_in_place():
    cfg = get_config(ARCH)
    rt = RuntimeOptions()
    m = get_model(cfg)
    params = m.init(torch.Generator().manual_seed(0), cfg, rt, "cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, 9)).astype(np.int32))
    width = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
    for cache in (m.init_cache(cfg, rt, B, 12, "cpu"),
                  m.prefill(params, toks[:, :8], cfg, rt, max_len=12)[1]):
        for seg in cache["segments"]:
            lat = attn.latent_rows(seg)
            assert tuple(lat.shape) == (seg["ckv"].shape[0], B, 12, width)
            assert lat.data_ptr() == seg["ckv"].data_ptr()     # a view
            assert_bitwise(lat[..., cfg.mla.kv_lora_rank:], seg["krope"])
    before = [attn.latent_rows(s).clone() for s in cache["segments"]]
    _, stepped = m.decode_step(params, cache, toks[:, 8], cfg, rt)
    for seg, old in zip(stepped["segments"], before):
        lat = attn.latent_rows(seg)
        assert not torch.equal(lat[:, :, 8], old[:, :, 8])     # slot 8
        assert torch.equal(lat[:, :, :8], old[:, :, :8])
    # two separate tensors still read as one (a copy)
    seg = stepped["segments"][0]
    apart = {k: v.clone() for k, v in seg.items()}
    assert_bitwise(attn.latent_rows(apart), attn.latent_rows(seg))


def _lm(rt_kw):
    cfg_j, rt_j = j_get_config(ARCH), JRuntimeOptions(**rt_kw)
    params_j = j_get_model(cfg_j).init(KEY, cfg_j, rt_j)
    cfg, rt = get_config(ARCH), RuntimeOptions(**rt_kw)
    return (cfg_j, rt_j, params_j, cfg, rt,
            params_from_numpy(jax.tree.map(np.asarray, params_j)))


def _same_routing(cfg, p_j, params, moe_inputs, what):
    """Each MoE layer's top-k on the port's input: the reference's
    ``top_k`` over its softmax router on the same input picks the same
    experts."""
    (si, n), = [(i, n) for i, (bt, n, _) in
                enumerate(transformer.segments(cfg)) if bt == "attn_moe"]
    assert len(moe_inputs) == n
    for layer, h in enumerate(moe_inputs):
        p_l = transformer._layer(params["segments"][si], layer)["mlp"]
        r = moe.route(p_l, h, cfg, 1.25)
        router = np.asarray(p_j["segments"][si]["mlp"]["router"][layer])
        _, top_j = jax.lax.top_k(jax.nn.softmax(
            jnp.asarray(h.numpy()) @ router, axis=-1), cfg.moe.top_k)
        assert_bitwise(r.top_e.numpy(), np.asarray(top_j).astype(np.int64),
                       f"{what}: layer {layer} top_e")


@pytest.mark.parametrize("rt_kw", [{}, {"absorbed_mla": True}],
                         ids=["materialized", "absorbed"])
def test_deepseek_lm_matches_jax(rt_kw):
    cfg_j, rt_j, params_j, cfg, rt, params = _lm(rt_kw)
    jm, tm = j_get_model(cfg_j), get_model(cfg)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S + 4)).astype(np.int32)
    want, aux_w = jm.forward(params_j, jnp.asarray(toks[:, :S]), cfg_j, rt_j)
    got, aux = tm.forward(params, torch.from_numpy(toks[:, :S]), cfg, rt)
    assert_close(got, want, "forward")
    assert_close(aux, aux_w, "aux")
    lw, cw = jm.prefill(params_j, jnp.asarray(toks[:, :S]), cfg_j, rt_j,
                        max_len=S + 5)
    seen = []
    lg, cg = tm.prefill(params, torch.from_numpy(toks[:, :S]), cfg, rt,
                        max_len=S + 5, moe_inputs=seen)
    assert_close(lg, lw, "prefill logits")
    _same_routing(cfg, params_j, params, seen, "prefill")
    for t in range(-1, 4):
        if t >= 0:
            seen = []
            lw, cw = jm.decode_step(params_j, cw,
                                    jnp.asarray(toks[:, S + t]), cfg_j, rt_j)
            lg, cg = tm.decode_step(params, cg,
                                    torch.from_numpy(toks[:, S + t]), cfg,
                                    rt, moe_inputs=seen)
            assert_close(lg, lw, f"decode step {t}")
            _same_routing(cfg, params_j, params, seen, f"decode step {t}")
        assert cg["idx"] == int(cw["idx"])
        assert_bitwise(cg["pos"], np.asarray(cw["pos"]), "pos")
        for sg, sw in zip(cg["segments"], cw["segments"]):
            assert set(sg) == set(sw) == {"ckv", "krope"}
            for name in sg:
                assert_close(sg[name], sw[name], f"step {t}: cache {name}")


def test_forward_collects_each_moe_layers_input():
    """``moe_inputs`` of ``forward`` receives one ``[B, S, d]`` input a
    MoE layer, equal to the prefill's at the same positions, and changes
    no logit."""
    cfg, rt = get_config(ARCH), RuntimeOptions()
    m = get_model(cfg)
    params = m.init(torch.Generator().manual_seed(0), cfg, rt, "cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (B, 10)).astype(np.int32))
    seen, pre = [], []
    lg, _ = m.forward(params, toks, cfg, rt, moe_inputs=seen)
    assert_bitwise(lg, m.forward(params, toks, cfg, rt)[0], "logits")
    m.prefill(params, toks[:, :7], cfg, rt, moe_inputs=pre)
    n_moe = sum(n for bt, n, _ in transformer.segments(cfg)
                if bt == "attn_moe")
    assert len(seen) == len(pre) == n_moe
    for h, hp in zip(seen, pre):
        assert tuple(h.shape) == (B, 10, cfg.d_model)
        assert_close(h[:, :7], hp)


def test_absorbed_matches_materialized_within_the_reference_bound():
    """``tests/test_perf_levers.py:71-82`` inside the port: the two forms
    of one model give the same logits within 2e-3, in prefill and over
    decode steps from the same cache."""
    cfg = get_config(ARCH)
    rt = RuntimeOptions()
    rt_abs = dataclasses.replace(rt, absorbed_mla=True)
    m = get_model(cfg)
    params = m.init(torch.Generator().manual_seed(3), cfg, rt, "cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, S + 3)).astype(np.int32))
    tol = dict(rtol=2e-3, atol=2e-3)
    lm, cm = m.prefill(params, toks[:, :S], cfg, rt, max_len=S + 4)
    la, ca = m.prefill(params, toks[:, :S], cfg, rt_abs, max_len=S + 4)
    np.testing.assert_allclose(la, lm, **tol)
    for t in range(3):
        lm, cm = m.decode_step(params, cm, toks[:, S + t], cfg, rt)
        la, ca = m.decode_step(params, ca, toks[:, S + t], cfg, rt_abs)
        np.testing.assert_allclose(la, lm, **tol)


@pytest.mark.parametrize("absorbed", [False, True])
def test_deepseek_cached_decode_matches_teacher_forced_forward(absorbed):
    """``tests/test_arch_smoke.py:71`` inside the port, at a capacity
    that drops nothing (E / top_k)."""
    cfg = get_config(ARCH)
    rt = RuntimeOptions(capacity_factor=cfg.moe.n_routed_experts
                        / cfg.moe.top_k, absorbed_mla=absorbed)
    m = get_model(cfg)
    params = m.init(torch.Generator().manual_seed(0), cfg, rt, "cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S + 2)).astype(np.int32))
    full, _ = m.forward(params, toks, cfg, rt)
    tol = dict(rtol=2e-3, atol=2e-3)
    lg, cache = m.prefill(params, toks[:, :S], cfg, rt)
    np.testing.assert_allclose(lg, full[:, S - 1], **tol)
    for t in range(2):
        lg, cache = m.decode_step(params, cache, toks[:, S + t], cfg, rt)
        np.testing.assert_allclose(lg, full[:, S + t], **tol)


def test_convert_carries_the_mla_tree():
    cfg_j = j_get_config(ARCH)
    params_j = j_get_model(cfg_j).init(KEY, cfg_j, JRuntimeOptions())
    params = params_from_numpy(jax.tree.map(np.asarray, params_j))
    m, H = cfg_j.mla, cfg_j.n_heads
    for si, (btype, n, _) in enumerate(transformer.segments(
            get_config(ARCH))):
        a_j, a = params_j["segments"][si]["attn"], \
            params["segments"][si]["attn"]
        assert set(a) == set(a_j) == {"wq", "w_dkv", "ckv_norm", "w_uk",
                                      "w_uv", "wo"}
        assert tuple(a["w_uk"].shape) == (n, m.kv_lora_rank, H,
                                          m.qk_nope_head_dim)
        assert tuple(a["w_uv"].shape) == (n, m.kv_lora_rank, H,
                                          m.v_head_dim)
        assert tuple(a["ckv_norm"]["scale"].shape) == (n, m.kv_lora_rank)
        for leaf, want in (("w_uk", a_j["w_uk"]), ("w_uv", a_j["w_uv"]),
                           ("ckv_norm", a_j["ckv_norm"]["scale"]),
                           ("w_dkv", a_j["w_dkv"]["w"])):
            got = a[leaf]["scale" if leaf == "ckv_norm" else "w"] \
                if isinstance(a[leaf], dict) else a[leaf]
            assert_bitwise(got, np.asarray(want, np.float32), leaf)
    # the port's own init draws the same tree
    own = transformer.init_lm(torch.Generator().manual_seed(0),
                              get_config(ARCH), RuntimeOptions(), "cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), params_j)
    assert jax.tree.map(lambda a: tuple(a.shape), own) == shapes


# (B, T, Hq, Hkv, D, Dv, window, fill, scale): the materialized and the
# absorbed MLA step (reduced widths), a wider v, and square cases
DECODE_CASES = [
    (2, 40, 4, 4, 48, 32, 0, 30, None),
    (2, 40, 4, 1, 80, 64, 0, 40, 48 ** -0.5),
    (1, 33, 6, 2, 32, 64, 12, 33, 0.3),
    (2, 64, 8, 2, 64, 64, 0, 50, 0.1),
    (1, 48, 4, 4, 32, 32, 16, 48, None),
]


def _decode_inputs(case, seed=0):
    Bq, T, Hq, Hkv, D, Dv, _, fill, _ = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((Bq, Hq, D)).astype(np.float32)
    k = rng.standard_normal((Bq, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((Bq, T, Hkv, Dv)).astype(np.float32)
    kpos = np.where(np.arange(T) < fill, np.arange(T), -1).astype(np.int32)
    return q, k, v, kpos


@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: "-".join(map(
    str, c)))
def test_plain_decode_attention_with_dv_and_scale_matches_jax(case):
    _, _, _, _, D, Dv, window, fill, scale = case
    q, k, v, kpos = _decode_inputs(case)
    qpos = np.array([fill - 1], np.int32)
    want = jref.attention(*(jnp.asarray(a) for a in (q[:, None], k, v, qpos,
                                                     kpos)),
                          causal=True, window=window, scale=scale)[:, 0]
    got = ref.decode_attention(*_t(q, k, v, kpos), fill - 1, window=window,
                               scale=scale)
    assert tuple(got.shape) == q.shape[:2] + (Dv,)
    assert_close(got, want)
    assert_close(ops.decode_attention(*_t(q, k, v, kpos),
                                      torch.tensor([fill - 1],
                                                   dtype=torch.int32),
                                      window=window, scale=scale), want)
    if Dv == D:                                  # the Pallas kernel's case
        pallas = pl_decode(*(jnp.asarray(a) for a in (q, k, v, kpos)),
                           jnp.asarray(fill - 1), window=window, scale=scale,
                           block_k=16, interpret=True)
        assert_close(got, pallas)


def test_decode_attention_row_without_a_visible_key():
    """Every key lies in the query's future: the plain oracle gives the
    uniform mean of v (``ref.attention``), the Pallas kernel zeros (its
    acc and l stay 0), and so does the CUDA kernel
    (``tests/test_torch_cuda.py``): a difference by design; no row of the
    LM path has one."""
    case = (1, 32, 4, 2, 32, 32, 0, 32, None)
    q, k, v, kpos = _decode_inputs(case)
    kpos = kpos + 100
    got = ref.decode_attention(*_t(q, k, v, kpos), 5)
    assert_close(got[0, 0], v[0, :, 0].mean(0))
    pallas = pl_decode(*(jnp.asarray(a) for a in (q, k, v, kpos)),
                       jnp.asarray(5), block_k=16, interpret=True)
    assert_bitwise(np.asarray(pallas), np.zeros_like(q))


def test_ops_decode_dispatch_and_the_wrappers_refuse_cpu_tensors():
    case = DECODE_CASES[0]
    q, k, v, kpos = _t(*_decode_inputs(case))
    qpos = torch.tensor([29], dtype=torch.int32)
    want = ref.decode_attention(q, k, v, kpos, qpos)
    before = kdecode.launches.value
    assert_close(ops.decode_attention(q, k, v, kpos, qpos), want)
    # ops.attention with one query token on the CPU: the plain version
    assert_close(ops.attention(q[:, None], k, v, qpos, kpos)[:, 0], want)
    assert kdecode.launches.value == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        kdecode.decode_attention(q, k, v, kpos, qpos)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.decode_attention(q, k, v, kpos, qpos, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.attention(q[:, None], k, v, qpos, kpos, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        ops.decode_attention(q, k, v, kpos, qpos, impl="pallas")
    # a single token is decode_attention's: the prefill kernel refuses it
    with pytest.raises(ValueError, match="decode_attention"):
        kflash.flash_attention(q[:, None], k, v, qpos, kpos)


@pytest.mark.parametrize("B_,Hkv,g,T,per_sm,min_tiles", [
    (4, 1, 16, 2081, 1, 2),         # absorbed MLA step
    (4, 16, 1, 2081, 2, 4),         # materialized MLA step
    (4, 8, 4, 2081, 2, 4),          # qwen3-4b
    (4, 5, 3, 97, 2, 4),            # smollm-360m
    (1, 1, 48, 5, 2, 4),            # MQA, g over 16, a short ring
    (64, 32, 1, 100000, 2, 4),      # more blocks than one wave
])
def test_decode_split_plan_covers_t_in_whole_tiles(B_, Hkv, g, T, per_sm,
                                                   min_tiles):
    n_sm = 132
    ts, n = kdecode.split_plan(B_, Hkv, g, T, n_sm, per_sm, min_tiles)
    assert ts % kdecode.TILE == 0 and ts > 0
    assert (n - 1) * ts < T <= n * ts
    runs = -(-g // kdecode.HEADS_PER_BLOCK)
    if n > 1:               # one wave at most, pieces long enough
        assert B_ * Hkv * runs * n <= per_sm * n_sm
        assert ts >= min_tiles * kdecode.TILE
    if (B_, Hkv, g, T) == (4, 1, 16, 2081):
        assert (ts, n) == (64, 33)


@pytest.mark.parametrize("case", SERVED_DECODE_PLANS, ids=lambda c: c[0])
def test_decode_split_plan_at_the_served_shapes(case):
    """The absorbed step takes the tensor cores in 33 pieces of two
    tiles (half the first version's 66 pieces of one, half its partial
    sums); the materialized and qwen steps fill one wave at two blocks
    an SM, and so do zamba2's (2 pieces) and seamless's cross step (4);
    smollm's 97 slots are one piece, so one launch and no
    combine, with all four of its tiles in flight at once.  (The card
    test ``test_cuda_decode_plan_at_the_served_shapes`` holds the C
    plan to the same table.)"""
    _, B_, Hkv, g, T, D, Dv, v_in_k, path, pieces, (slots, per_sm) = case
    ts, n = kdecode.split_plan(B_, Hkv, g, T, 132, per_sm,
                               kdecode.MIN_PIECE_TILES[path])
    assert n == pieces
    # the ring as deep as the piece allows, up to the deepest that fits
    # (bytes of a block of this many an SM; None: does not fit)
    need = {1: 150000, 2: 100000}[per_sm]
    assert kdecode.ring_plan(lambda s: need if s <= slots else None,
                             ts // 32) == (min(slots, ts // 32), per_sm)


def test_decode_split_plan_one_piece_and_the_refused_shape():
    """A ring of up to 2 MIN_PIECE_TILES - 1 tiles is one piece on
    either path; a ring depth that does not fit stops the ring (and a
    shape whose two tiles do not fit is refused before any launch:
    ``test_cuda_decode_plan_refuses_what_does_not_fit``)."""
    for path in ("cuda_cores", "tensor_cores"):
        lo = kdecode.MIN_PIECE_TILES[path]
        max_t = kdecode.TILE * (2 * lo - 1)
        assert kdecode.split_plan(1, 1, 16, max_t, 132, 2, lo) == (
            -(-max_t // kdecode.TILE) * kdecode.TILE, 1)
        assert kdecode.split_plan(1, 1, 16, max_t + kdecode.TILE, 132, 2,
                                  lo)[1] == 2
    assert kdecode.ring_plan(lambda s: 1000 if s < 4 else None, 8) == (3, 2)
    assert kdecode.ring_plan(lambda s: 1000, 3) == (3, 2)


def test_serve_runs_deepseek_on_the_cpu(capsys):
    assert serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                       "--prompt-len", "12", "--new-tokens", "3"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(out[-1])
    assert rec["arch"] == ARCH and rec["device"] == "cpu"
    assert rec["decode_ms_per_token"] > 0
