"""Decoder language model assembly: dense, VLM, MoE and pure-SSM
families (``repro/models/transformer.py``).

Layers are grouped into homogeneous SEGMENTS with per-segment stacked
``[L, ...]`` params, as in the reference; a Python loop over the layer
index takes the place of ``lax.scan``.  Three modes:

  forward(...)      full-sequence teacher forcing
  prefill(...)      full sequence, returns (last-token logits, decode cache)
  decode_step(...)  one token against the cache (ring buffer if windowed)

Cache: {"segments": [per-segment stacked {"k", "v"}, MLA {"ckv",
"krope"} (two column views of one ``[L, B, M, lora + rope]`` buffer) or
mamba state {"conv_x", "conv_B", "conv_C", "ssm"}], "pos": [M] int32
([1] of -1 when no segment holds K/V), "idx": int}.  ``decode_step``
advances the cache IN PLACE (the new key, value or latent row, the
position and the mamba state go into the tensors it was given) and
returns it with ``idx + 1``: a cache is never reused after it has been
stepped.

Attention is GQA or MLA by ``cfg.attn_type`` (MLA materialized, or
absorbed with ``RuntimeOptions.absorbed_mla``); the MoE MLP is
``moe.moe_apply``, or ``moe.moe_apply_sharded`` over ``rt.mesh`` when
``rt.moe_impl == "shard_map"``.  ``forward`` returns the MoE
load-balance loss summed over the MoE layers as its aux term.  With
``RuntimeOptions.remat`` each layer is recomputed in the backward pass
(``remat``).
"""
from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (embed, init_embedding, init_linear,
                                       init_rmsnorm, init_swiglu, linear,
                                       rms_norm, swiglu, unembed)
from repro_torch.models.runtime import RuntimeOptions


# ----------------------------------------------------------- segments
def segments(cfg: ArchConfig) -> List[Tuple[str, int, int]]:
    """[(block_type, n_layers, d_ff)] — contiguous homogeneous runs."""
    if cfg.family in ("dense", "vlm"):
        return [("attn_dense", cfg.num_layers, cfg.d_ff)]
    if cfg.family == "moe":
        m = cfg.moe
        segs = []
        if m.first_dense_layers:
            segs.append(("attn_dense", m.first_dense_layers,
                         m.dense_d_ff or cfg.d_ff))
        segs.append(("attn_moe", cfg.num_layers - m.first_dense_layers, 0))
        return segs
    if cfg.family == "ssm":
        return [("mamba", cfg.num_layers, 0)]
    raise ValueError(f"transformer.py does not assemble family "
                     f"{cfg.family!r}")


def _is_mla(cfg: ArchConfig, btype: str) -> bool:
    return btype != "mamba" and cfg.attn_type == "mla"


# ----------------------------------------------------------- block
def _init_block(gen, cfg: ArchConfig, rt: RuntimeOptions, btype: str,
                d_ff: int, device, n: int):
    """One segment's params, stacked over its ``n`` layers."""
    lead = (n,)
    if btype == "mamba":
        return {"ln1": init_rmsnorm(cfg.d_model, rt.dtype, device, lead),
                "mixer": ssm_mod.init_mamba2(gen, cfg, rt.dtype, device,
                                             lead)}
    if _is_mla(cfg, btype):
        a = attn.init_mla(gen, cfg, rt.dtype, device, lead)
    else:
        a = attn.init_gqa(gen, cfg, rt.dtype, device, rt.kv_mult, lead)
    p = {"ln1": init_rmsnorm(cfg.d_model, rt.dtype, device, lead),
         "attn": a,
         "ln2": init_rmsnorm(cfg.d_model, rt.dtype, device, lead)}
    if btype == "attn_dense":
        p["mlp"] = init_swiglu(gen, cfg.d_model, d_ff, rt.dtype, device,
                               cfg.attn_bias, lead)
    else:
        p["mlp"] = moe_mod.init_moe(gen, cfg, rt.dtype, device, lead)
    return p


def _apply_block(p, x, btype: str, cfg: ArchConfig, rt: RuntimeOptions,
                 positions, mode: str, cache_l, cache_pos, cache_idx,
                 moe_inputs: Optional[list] = None):
    """Returns (x, new_cache_l, aux); aux is the MoE load-balance loss,
    None for the other blocks (no tensor, so no launch, per layer).  A
    MoE block appends its input to ``moe_inputs`` when one is given."""
    dec = mode == "decode"
    aux = None
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if btype == "mamba":
        y, new_c = ssm_mod.mamba2_apply(
            p["mixer"], h, cfg, cache=cache_l if dec else None,
            return_cache=(mode == "prefill"), impl=rt.impl)
        return x + y, new_c, aux
    kw = dict(cache=cache_l if dec else None,
              cache_pos=cache_pos if dec else None,
              cache_idx=cache_idx if dec else None,
              window=rt.eff_window(cfg), causal=True, impl=rt.impl,
              chunk=rt.attn_chunk)
    if _is_mla(cfg, btype):
        y, new_c = attn.mla_apply(p["attn"], h, positions, cfg,
                                  absorbed=rt.absorbed_mla, **kw)
    else:
        y, new_c = attn.gqa_apply(p["attn"], h, positions, cfg,
                                  kv_mult=rt.kv_mult, **kw)
    x = x + y
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if btype == "attn_dense":
        y = swiglu(p["mlp"], h)
    else:
        if moe_inputs is not None:
            moe_inputs.append(h)
        if rt.moe_impl == "shard_map" and rt.mesh is not None:
            y, aux = moe_mod.moe_apply_sharded(
                p["mlp"], h, cfg, rt.mesh,
                capacity_factor=rt.capacity_factor, impl=rt.impl)
        else:
            y, aux = moe_mod.moe_apply(p["mlp"], h, cfg,
                                       capacity_factor=rt.capacity_factor,
                                       impl=rt.impl)
    return x + y, new_c, aux


# ----------------------------------------------------------- LM init
def init_lm(gen: torch.Generator, cfg: ArchConfig, rt: RuntimeOptions,
            device: DeviceLike = None):
    """Random params in the reference's layout, drawn from ``gen`` on
    ``device`` (``cuda:0`` unless the caller names another; ``gen`` must
    live on that device)."""
    device = resolve_device(device)
    params = {
        "embed": init_embedding(gen, cfg.padded_vocab, cfg.d_model,
                                rt.dtype, device, tied=cfg.tie_embeddings),
        "final_norm": init_rmsnorm(cfg.d_model, rt.dtype, device),
        "segments": [],
    }
    if cfg.frontend_dim:
        params["frontend_proj"] = init_linear(
            gen, cfg.frontend_dim, cfg.d_model, rt.dtype, device)
    for btype, n, d_ff in segments(cfg):
        params["segments"].append(
            _init_block(gen, cfg, rt, btype, d_ff, device, n))
    return params


# ----------------------------------------------------------- cache init
def _layer_cache_shape(cfg: ArchConfig, rt: RuntimeOptions, btype: str,
                       batch: int, M: int, device, n: int = 1):
    """One segment's empty cache, stacked over its ``n`` layers."""
    if btype == "mamba":
        return ssm_mod.ssm_cache_init(cfg, batch, rt.dtype, device, (n,))
    if _is_mla(cfg, btype):
        m = cfg.mla
        buf = torch.zeros((n, batch, M, m.kv_lora_rank + m.qk_rope_head_dim),
                          dtype=rt.dtype, device=device)
        return attn.mla_cache(buf, m.kv_lora_rank)
    nkv = cfg.n_kv_heads * rt.kv_mult
    shape = (n, batch, M, nkv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=rt.dtype, device=device),
            "v": torch.zeros(shape, dtype=rt.dtype, device=device)}


def cache_len(cfg: ArchConfig, rt: RuntimeOptions, seq_len: int) -> int:
    w = rt.eff_window(cfg)
    return min(seq_len, w) if w else seq_len


def init_cache(cfg: ArchConfig, rt: RuntimeOptions, batch: int,
               seq_len: int, device: DeviceLike = None):
    """Empty decode cache sized for ``seq_len`` total positions."""
    device = resolve_device(device)
    M = cache_len(cfg, rt, seq_len)
    return {"segments": [_layer_cache_shape(cfg, rt, btype, batch, M,
                                            device, n)
                         for btype, n, _ in segments(cfg)],
            "pos": torch.full((M,), -1, dtype=torch.int32, device=device),
            "idx": 0}


# ----------------------------------------------------------- backbone
def _layer(tree, i: int):
    """Layer ``i`` of a stacked params/cache tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def remat(fn, rt: RuntimeOptions):
    """``fn``, recomputed in the backward pass when ``rt.remat`` (the
    reference's ``jax.checkpoint`` of a scan body): only its inputs are
    saved.  The models draw no random numbers, so no RNG state is
    kept."""
    if not rt.remat:
        return fn
    return functools.partial(torch.utils.checkpoint.checkpoint, fn,
                             use_reentrant=False, preserve_rng_state=False)


def _run_segments(params, x, cfg, rt, positions, mode, cache, cache_pos,
                  cache_idx, moe_inputs=None):
    """Returns (x, aux summed over the MoE layers or None without any,
    per-segment caches): the stacked fresh cache of every layer in
    prefill, the (updated in place) cache in decode, None in train
    mode.  ``moe_inputs``, when given, collects each MoE layer's input
    (``_apply_block``)."""
    aux_total = None
    new_seg_caches = []
    block = remat(_apply_block, rt)
    for si, (btype, n, _) in enumerate(segments(cfg)):
        p_seg = params["segments"][si]
        c_seg = cache["segments"][si] if cache is not None else None
        ys = []
        for i in range(n):
            c_l = _layer(c_seg, i) if c_seg is not None else None
            x, new_c, aux = block(_layer(p_seg, i), x, btype, cfg, rt,
                                  positions, mode, c_l, cache_pos,
                                  cache_idx, moe_inputs)
            if aux is not None:
                aux_total = aux if aux_total is None else aux_total + aux
            if mode == "prefill":
                ys.append(new_c)
        new_seg_caches.append(_stack(ys) if mode == "prefill" else c_seg)
    return x, aux_total, new_seg_caches


def _embed_inputs(params, cfg, rt, tokens, prefix_embeds):
    x = embed(params["embed"], tokens.long())
    if prefix_embeds is not None:
        pe = linear(params["frontend_proj"], prefix_embeds.to(rt.dtype))
        x = torch.cat([pe, x], dim=1)
    return x.to(rt.dtype)


def forward(params, tokens: torch.Tensor, cfg: ArchConfig,
            rt: RuntimeOptions, prefix_embeds: Optional[torch.Tensor] = None,
            moe_inputs: Optional[list] = None):
    """Teacher-forced full-sequence logits.  tokens: ``[B, S_text]``;
    prefix_embeds: ``[B, P, frontend_dim]`` (VLM stub).  Returns
    (logits ``[B, S_total, V_padded]``, aux); aux is the MoE
    load-balance loss summed over the layers (0 without MoE blocks).
    ``moe_inputs`` as in ``prefill``."""
    x = _embed_inputs(params, cfg, rt, tokens, prefix_embeds)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    x, aux, _ = _run_segments(params, x, cfg, rt, positions, "train", None,
                              None, None, moe_inputs)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if aux is None:
        aux = torch.zeros((), device=x.device)
    return unembed(params["embed"], x), aux


def fit_kv_cache(kv, S: int, M: int, axis: int = 2):
    """Re-layout full-prefill K/V ``[.., S, ..]`` into a ring buffer of
    size M where slot ``p % M`` holds position p: padded with empty
    slots when ``M > S``; when ``M < S`` the last M positions, rolled by
    ``S % M``.  Returns (kv, pos ``[M]`` int32)."""
    dev = next(iter(kv.values())).device

    def arange(a, b):
        return torch.arange(a, b, dtype=torch.int32, device=dev)

    if M == S:
        return kv, arange(0, S)
    if M > S:
        def pad(a):
            shape = list(a.shape)
            shape[axis] = M
            out = a.new_zeros(shape)
            out.narrow(axis, 0, S).copy_(a)
            return out
        pos = torch.cat([arange(0, S), torch.full(
            (M - S,), -1, dtype=torch.int32, device=dev)])
        return {k: pad(a) for k, a in kv.items()}, pos
    kv = {k: torch.roll(a.narrow(axis, S - M, M), S % M, dims=axis)
          for k, a in kv.items()}
    return kv, torch.roll(arange(S - M, S), S % M)


def prefill(params, tokens: torch.Tensor, cfg: ArchConfig,
            rt: RuntimeOptions, prefix_embeds: Optional[torch.Tensor] = None,
            max_len: Optional[int] = None,
            moe_inputs: Optional[list] = None):
    """Returns (last-token logits ``[B, V_padded]``, decode cache).
    ``max_len`` sizes the cache for the decoding to come (defaults to
    S + 128); ``moe_inputs``, when given, collects each MoE layer's
    input, in layer order (for checks of the routing)."""
    x = _embed_inputs(params, cfg, rt, tokens, prefix_embeds)
    S = x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    x, _, seg_caches = _run_segments(params, x, cfg, rt, positions,
                                     "prefill", None, None, None, moe_inputs)
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = unembed(params["embed"], x)[:, 0]
    M = cache_len(cfg, rt, max_len or S + 128)
    trimmed, pos = [], None
    for (btype, _, _), c in zip(segments(cfg), seg_caches):
        if btype == "mamba":                 # the state as it is
            trimmed.append(c)
        elif _is_mla(cfg, btype):            # one latent buffer, two views
            c, pos = fit_kv_cache({"lat": attn.latent_rows(c)}, S, M)
            trimmed.append(attn.mla_cache(c["lat"], cfg.mla.kv_lora_rank))
        else:
            c, pos = fit_kv_cache(c, S, M)
            trimmed.append(c)
    if pos is None:                          # pure SSM: no K/V ring
        pos = torch.full((1,), -1, dtype=torch.int32, device=x.device)
    return logits, {"segments": trimmed, "pos": pos, "idx": S}


def decode_step(params, cache, token: torch.Tensor, cfg: ArchConfig,
                rt: RuntimeOptions, moe_inputs: Optional[list] = None):
    """token: ``[B]`` int.  Returns (logits ``[B, V_padded]``, the cache
    advanced in place, with ``idx + 1``); ``moe_inputs`` as in
    ``prefill``."""
    x = embed(params["embed"], token.long()[:, None]).to(rt.dtype)
    idx = cache["idx"]
    positions = torch.full((1,), idx, dtype=torch.int32, device=x.device)
    x, _, seg_caches = _run_segments(params, x, cfg, rt, positions,
                                     "decode", cache, cache["pos"], idx,
                                     moe_inputs)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(params["embed"], x)[:, 0]
    pos = cache["pos"]
    if all(btype == "mamba" for btype, _, _ in segments(cfg)):
        # no attention layer wrote it; a fill, since an indexed store of
        # a Python number would stall the host on the card
        pos.narrow(0, idx % pos.shape[0], 1).fill_(idx)
    return logits, {"segments": seg_caches, "pos": pos, "idx": idx + 1}
