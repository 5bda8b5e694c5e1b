"""Zamba2-style hybrid assembly (``repro/models/hybrid.py``): a Mamba2
backbone with ONE parameter-shared attention+MLP block invoked every
``shared_attn_every`` layers.

Layer schedule for L=81, k=6: 13 super-blocks of (6 mamba layers + one
invocation of the shared block) + 3 tail mamba layers.  ``params
["shared"]`` is one set of tensors that every invocation uses (never
copied); each invocation has its own K/V ring.  Python loops over the
layers with ``_layer`` views take the place of the reference's nested
``lax.scan`` (``models/transformer.py``).

Cache: {"mamba_main": mamba state stacked ``[ns, k, ...]``, "attn":
{"k", "v"} of ``[ns, B, M, nkv, hd]`` (one ring an invocation), "pos":
``[M]`` int32, "idx": int, and "mamba_tail": ``[tail, ...]`` when the
schedule has a tail}.  ``decode_step`` advances the cache IN PLACE, as
``transformer.decode_step`` does: the mamba states through
``ssm.mamba2_apply``, and each invocation of the shared block writes
slot ``idx % M`` of its own ring and the same position into the same
slot of ``pos``, the value the reference writes once.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (embed, init_embedding, init_rmsnorm,
                                       init_swiglu, rms_norm, swiglu, unembed)
from repro_torch.models.runtime import RuntimeOptions
from repro_torch.models.transformer import (_layer, _stack, cache_len,
                                            fit_kv_cache, remat)


def _schedule(cfg: ArchConfig) -> Tuple[int, int, int]:
    """(super-blocks ns, mamba layers a super-block k, tail layers)."""
    k = cfg.shared_attn_every
    ns = cfg.num_layers // k
    tail = cfg.num_layers - ns * k
    return ns, k, tail


def _init_mamba_block(gen, cfg: ArchConfig, rt: RuntimeOptions, device,
                      lead):
    return {"ln1": init_rmsnorm(cfg.d_model, rt.dtype, device, lead),
            "mixer": ssm_mod.init_mamba2(gen, cfg, rt.dtype, device, lead)}


def init_hybrid(gen: torch.Generator, cfg: ArchConfig, rt: RuntimeOptions,
                device: DeviceLike = None):
    """Random params in the reference's layout (``mamba_main`` stacked
    ``[ns, k, ...]``, ``mamba_tail`` ``[tail, ...]``), drawn from ``gen``
    on ``device`` (``cuda:0`` unless the caller names another)."""
    device = resolve_device(device)
    ns, k, tail = _schedule(cfg)
    params = {
        "embed": init_embedding(gen, cfg.padded_vocab, cfg.d_model,
                                rt.dtype, device, tied=cfg.tie_embeddings),
        "final_norm": init_rmsnorm(cfg.d_model, rt.dtype, device),
        "mamba_main": _init_mamba_block(gen, cfg, rt, device, (ns, k)),
        "shared": {
            "ln1": init_rmsnorm(cfg.d_model, rt.dtype, device),
            "attn": attn.init_gqa(gen, cfg, rt.dtype, device, rt.kv_mult),
            "ln2": init_rmsnorm(cfg.d_model, rt.dtype, device),
            "mlp": init_swiglu(gen, cfg.d_model, cfg.d_ff, rt.dtype,
                               device),
        },
    }
    if tail:
        params["mamba_tail"] = _init_mamba_block(gen, cfg, rt, device,
                                                 (tail,))
    return params


def init_cache(cfg: ArchConfig, rt: RuntimeOptions, batch: int,
               seq_len: int, device: DeviceLike = None):
    """Empty decode cache sized for ``seq_len`` total positions."""
    device = resolve_device(device)
    ns, k, tail = _schedule(cfg)
    M = cache_len(cfg, rt, seq_len)
    shape = (ns, batch, M, cfg.n_kv_heads * rt.kv_mult, cfg.head_dim)
    cache = {
        "mamba_main": ssm_mod.ssm_cache_init(cfg, batch, rt.dtype, device,
                                             (ns, k)),
        "attn": {"k": torch.zeros(shape, dtype=rt.dtype, device=device),
                 "v": torch.zeros(shape, dtype=rt.dtype, device=device)},
        "pos": torch.full((M,), -1, dtype=torch.int32, device=device),
        "idx": 0,
    }
    if tail:
        cache["mamba_tail"] = ssm_mod.ssm_cache_init(cfg, batch, rt.dtype,
                                                     device, (tail,))
    return cache


def _mamba_block(p, x, cfg, rt, mode, cache_l):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    y, new_c = ssm_mod.mamba2_apply(
        p["mixer"], h, cfg, cache=cache_l if mode == "decode" else None,
        return_cache=(mode == "prefill"), impl=rt.impl)
    return x + y, new_c


def _shared_block(p, x, cfg, rt, positions, mode, cache_l, cache_pos,
                  cache_idx):
    dec = mode == "decode"
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    y, new_c = attn.gqa_apply(
        p["attn"], h, positions, cfg,
        cache=cache_l if dec else None,
        cache_pos=cache_pos if dec else None,
        cache_idx=cache_idx if dec else None,
        window=rt.eff_window(cfg), causal=True, kv_mult=rt.kv_mult,
        impl=rt.impl, chunk=rt.attn_chunk)
    x = x + y
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + swiglu(p["mlp"], h), new_c


def _super_block(p_s, shared, x, cfg, rt, positions, mode, c_s, c_a,
                 cache_pos, cache_idx):
    """One super-block: its mamba layers, then the shared block.
    Returns (x, the mamba layers' caches, the shared block's)."""
    row = []
    for i in range(_schedule(cfg)[1]):
        x, new_c = _mamba_block(_layer(p_s, i), x, cfg, rt, mode,
                                None if c_s is None else _layer(c_s, i))
        row.append(new_c)
    x, new_a = _shared_block(shared, x, cfg, rt, positions, mode, c_a,
                             cache_pos, cache_idx)
    return x, row, new_a


def _backbone(params, x, cfg, rt, positions, mode, cache, cache_pos,
              cache_idx):
    """Returns (x, mamba_main, attn, mamba_tail): in prefill the fresh
    caches stacked as the cache holds them (``mamba_tail`` None without a
    tail), else None (decode advanced ``cache`` in place).  With
    ``rt.remat`` each super-block is recomputed in the backward pass, as
    the reference's; the tail layers are not."""
    ns, _, tail = _schedule(cfg)
    main, rings, tails = [], [], []
    block = remat(_super_block, rt)
    for s in range(ns):
        x, row, new_a = block(
            _layer(params["mamba_main"], s), params["shared"], x, cfg, rt,
            positions, mode,
            None if cache is None else _layer(cache["mamba_main"], s),
            None if cache is None else _layer(cache["attn"], s), cache_pos,
            cache_idx)
        main.append(row)
        rings.append(new_a)
    for i in range(tail):
        x, new_c = _mamba_block(
            _layer(params["mamba_tail"], i), x, cfg, rt, mode,
            None if cache is None else _layer(cache["mamba_tail"], i))
        tails.append(new_c)
    if mode != "prefill":
        return x, None, None, None
    return (x, _stack([_stack(row) for row in main]), _stack(rings),
            _stack(tails) if tail else None)


def forward(params, tokens: torch.Tensor, cfg: ArchConfig,
            rt: RuntimeOptions, prefix_embeds: Optional[torch.Tensor] = None):
    """Teacher-forced logits ``[B, S, V_padded]`` and a zero aux term."""
    x = embed(params["embed"], tokens.long()).to(rt.dtype)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    x, *_ = _backbone(params, x, cfg, rt, positions, "train", None, None,
                      None)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params["embed"], x), torch.zeros((), device=x.device)


def prefill(params, tokens: torch.Tensor, cfg: ArchConfig,
            rt: RuntimeOptions, prefix_embeds: Optional[torch.Tensor] = None,
            max_len: Optional[int] = None):
    """Returns (last-token logits ``[B, V_padded]``, decode cache);
    ``max_len`` sizes the rings (defaults to S + 128)."""
    x = embed(params["embed"], tokens.long()).to(rt.dtype)
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    x, new_main, new_attn, new_tail = _backbone(
        params, x, cfg, rt, positions, "prefill", None, None, None)
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = unembed(params["embed"], x)[:, 0]
    M = cache_len(cfg, rt, max_len or S + 128)
    kv, pos = fit_kv_cache(new_attn, S, M)
    cache = {"mamba_main": new_main, "attn": kv, "pos": pos, "idx": S}
    if new_tail is not None:
        cache["mamba_tail"] = new_tail
    return logits, cache


def decode_step(params, cache, token: torch.Tensor, cfg: ArchConfig,
                rt: RuntimeOptions):
    """token: ``[B]`` int.  Returns (logits ``[B, V_padded]``, the cache
    advanced in place, with ``idx + 1``)."""
    x = embed(params["embed"], token.long()[:, None]).to(rt.dtype)
    idx = cache["idx"]
    positions = torch.full((1,), idx, dtype=torch.int32, device=x.device)
    x, *_ = _backbone(params, x, cfg, rt, positions, "decode", cache,
                      cache["pos"], idx)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(params["embed"], x)[:, 0]
    return logits, dict(cache, idx=idx + 1)
