"""Seamless-M4T-style encoder-decoder backbone, audio -> text
(``repro/models/encdec.py``).

The modality frontend is a stub, as in the reference: the encoder takes
precomputed audio frame embeddings ``[B, T_a, frontend_dim]``.  The
encoder's self-attention is not causal; the decoder is a causal
transformer with self-attention (a ring cache at decode time) and
cross-attention over the encoder output.  Python loops over the layers
with ``_layer`` views take the place of the reference's ``lax.scan``
(``models/transformer.py``).

Cache: {"self": {"k", "v"} of ``[L_dec, B, M, nkv, hd]``, "enc_out":
``[B, T_a, d]``, "pos": ``[M]`` int32, "idx": int}, as in the
reference.  As there, the cross-attention's K and V are projected from
``enc_out`` again in every layer at every decode step
(``attention.cross_apply``); nothing of them is cached.
``decode_step`` advances the self-attention rings and ``pos`` IN PLACE,
as ``transformer.decode_step`` does.  With ``RuntimeOptions.remat``
each encoder and decoder layer is recomputed in the backward pass, as
in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import (embed, init_embedding, init_linear,
                                       init_rmsnorm, init_swiglu, linear,
                                       rms_norm, swiglu, unembed)
from repro_torch.models.runtime import RuntimeOptions
from repro_torch.models.transformer import (_layer, _stack, cache_len,
                                            fit_kv_cache, remat)


def init_encdec(gen: torch.Generator, cfg: ArchConfig, rt: RuntimeOptions,
                device: DeviceLike = None):
    """Random params in the reference's layout (``enc`` and ``dec``
    stacked over their layers), drawn from ``gen`` on ``device``
    (``cuda:0`` unless the caller names another)."""
    device = resolve_device(device)
    d, dt = cfg.d_model, rt.dtype
    le, ld = (cfg.enc_layers,), (cfg.dec_layers,)
    return {
        "frontend_proj": init_linear(gen, cfg.frontend_dim, d, dt, device),
        "embed": init_embedding(gen, cfg.padded_vocab, d, dt, device,
                                tied=cfg.tie_embeddings),
        "enc": {"ln1": init_rmsnorm(d, dt, device, le),
                "attn": attn.init_gqa(gen, cfg, dt, device, rt.kv_mult, le),
                "ln2": init_rmsnorm(d, dt, device, le),
                "mlp": init_swiglu(gen, d, cfg.d_ff, dt, device, lead=le)},
        "dec": {"ln1": init_rmsnorm(d, dt, device, ld),
                "self": attn.init_gqa(gen, cfg, dt, device, rt.kv_mult, ld),
                "ln_x": init_rmsnorm(d, dt, device, ld),
                "cross": attn.init_cross(gen, cfg, dt, device, rt.kv_mult,
                                         ld),
                "ln2": init_rmsnorm(d, dt, device, ld),
                "mlp": init_swiglu(gen, d, cfg.d_ff, dt, device, lead=ld)},
        "enc_norm": init_rmsnorm(d, dt, device),
        "final_norm": init_rmsnorm(d, dt, device),
    }


def encode(params, audio_embeds: torch.Tensor, cfg: ArchConfig,
           rt: RuntimeOptions) -> torch.Tensor:
    """Audio frame embeddings ``[B, T_a, frontend_dim]`` -> the encoder
    output ``[B, T_a, d]``: non-causal self-attention over every frame."""
    x = linear(params["frontend_proj"], audio_embeds.to(rt.dtype))
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    block = remat(_enc_block, rt)
    for i in range(cfg.enc_layers):
        x = block(_layer(params["enc"], i), x, positions, cfg, rt)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _enc_block(p_l, x, positions, cfg, rt):
    h = rms_norm(x, p_l["ln1"], cfg.norm_eps)
    y, _ = attn.gqa_apply(p_l["attn"], h, positions, cfg, causal=False,
                          window=0, kv_mult=rt.kv_mult, impl=rt.impl,
                          chunk=rt.attn_chunk)
    x = x + y
    h = rms_norm(x, p_l["ln2"], cfg.norm_eps)
    return x + swiglu(p_l["mlp"], h)


def _dec_block(p_l, x, enc_out, positions, cfg, rt, mode, c_l, cache_pos,
               cache_idx):
    dec = mode == "decode"
    h = rms_norm(x, p_l["ln1"], cfg.norm_eps)
    y, new_kv = attn.gqa_apply(
        p_l["self"], h, positions, cfg,
        cache=c_l if dec else None,
        cache_pos=cache_pos if dec else None,
        cache_idx=cache_idx if dec else None,
        window=rt.eff_window(cfg), causal=True, kv_mult=rt.kv_mult,
        impl=rt.impl, chunk=rt.attn_chunk)
    x = x + y
    h = rms_norm(x, p_l["ln_x"], cfg.norm_eps)
    x = x + attn.cross_apply(p_l["cross"], h, enc_out, cfg,
                             kv_mult=rt.kv_mult, impl=rt.impl)
    h = rms_norm(x, p_l["ln2"], cfg.norm_eps)
    return x + swiglu(p_l["mlp"], h), new_kv


def _decoder(params, x, enc_out, positions, cfg, rt, mode, cache,
             cache_pos, cache_idx):
    """Returns (x, the self-attention K/V stacked over the layers in
    prefill, the cache's (advanced in place) in decode, None in train
    mode)."""
    c_dec = cache["self"] if cache is not None else None
    fresh = []
    block = remat(_dec_block, rt)
    for i in range(cfg.dec_layers):
        x, new_kv = block(_layer(params["dec"], i), x, enc_out,
                          positions, cfg, rt, mode,
                          None if c_dec is None else _layer(c_dec, i),
                          cache_pos, cache_idx)
        fresh.append(new_kv)
    return x, (_stack(fresh) if mode == "prefill" else c_dec)


def forward(params, tokens: torch.Tensor, cfg: ArchConfig,
            rt: RuntimeOptions, prefix_embeds: Optional[torch.Tensor] = None):
    """Teacher-forced: the encoder over the audio embeddings
    (``prefix_embeds``), the decoder over ``tokens``.  Returns (logits
    ``[B, S, V_padded]``, a zero aux term)."""
    enc_out = encode(params, prefix_embeds, cfg, rt)
    x = embed(params["embed"], tokens.long()).to(rt.dtype)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=x.device)
    x, _ = _decoder(params, x, enc_out, positions, cfg, rt, "train", None,
                    None, None)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params["embed"], x), torch.zeros((), device=x.device)


def prefill(params, tokens: torch.Tensor, cfg: ArchConfig,
            rt: RuntimeOptions, prefix_embeds: Optional[torch.Tensor] = None,
            max_len: Optional[int] = None):
    """Returns (last-token logits ``[B, V_padded]``, decode cache);
    ``max_len`` sizes the self-attention rings (defaults to S + 128)."""
    enc_out = encode(params, prefix_embeds, cfg, rt)
    x = embed(params["embed"], tokens.long()).to(rt.dtype)
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    x, kv = _decoder(params, x, enc_out, positions, cfg, rt, "prefill",
                     None, None, None)
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = unembed(params["embed"], x)[:, 0]
    kv, pos = fit_kv_cache(kv, S, cache_len(cfg, rt, max_len or S + 128))
    return logits, {"self": kv, "enc_out": enc_out, "pos": pos, "idx": S}


def init_cache(cfg: ArchConfig, rt: RuntimeOptions, batch: int,
               seq_len: int, device: DeviceLike = None,
               enc_len: Optional[int] = None):
    """Empty decode cache (``enc_len`` audio frames, by default the
    config's ``n_prefix_tokens``)."""
    device = resolve_device(device)
    M = cache_len(cfg, rt, seq_len)
    enc_len = enc_len or cfg.n_prefix_tokens
    shape = (cfg.dec_layers, batch, M, cfg.n_kv_heads * rt.kv_mult,
             cfg.head_dim)
    return {
        "self": {"k": torch.zeros(shape, dtype=rt.dtype, device=device),
                 "v": torch.zeros(shape, dtype=rt.dtype, device=device)},
        "enc_out": torch.zeros((batch, enc_len, cfg.d_model),
                               dtype=rt.dtype, device=device),
        "pos": torch.full((M,), -1, dtype=torch.int32, device=device),
        "idx": 0,
    }


def decode_step(params, cache, token: torch.Tensor, cfg: ArchConfig,
                rt: RuntimeOptions):
    """token: ``[B]`` int.  Returns (logits ``[B, V_padded]``, the cache
    advanced in place, with ``idx + 1``)."""
    x = embed(params["embed"], token.long()[:, None]).to(rt.dtype)
    idx = cache["idx"]
    positions = torch.full((1,), idx, dtype=torch.int32, device=x.device)
    x, _ = _decoder(params, x, cache["enc_out"], positions, cfg, rt,
                    "decode", cache, cache["pos"], idx)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(params["embed"], x)[:, 0]
    return logits, dict(cache, idx=idx + 1)
