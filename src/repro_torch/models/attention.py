"""Attention variants with ring-buffer decode caches: GQA/MQA, MLA
(DeepSeek-V2) and encoder/decoder cross-attention
(``repro/models/attention.py``).

Cache convention (per layer; the transformer stacks these over L):
  gqa:  {"k": [B, M, kvH, hd], "v": [B, M, kvH, hd]}
  mla:  {"ckv": [B, M, lora], "krope": [B, M, rope_dim]}
plus a model-level {"pos": [M] int32 (-1 = empty), "idx": int}.
M = min(seq_len, window or seq_len); decode writes slot idx % M.

Unlike the reference, decode writes the new key and value into the
cache tensors IN PLACE (and the position into ``cache_pos``): a cache is
consumed by the step that advances it.  An MLA cache's ``ckv`` and
``krope`` are the two column views of one ``[.., M, lora + rope_dim]``
buffer (``mla_cache``), so the absorbed decode reads a latent row whole
(``latent_rows``) with no copy.  The mask (the reference's
``_mask_bias``, a copy of its oracle's) has one home in the port,
``kernels/ref.py``.  Cross-attention keeps no cache: as in the
reference, its K and V are projected from the encoder output at every
call (every decode step), and it runs ``ops.attention`` non-causal with
all-zero positions (``flash_attention`` for S > 1, ``decode_attention``
for S = 1 on the card).
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops, ref
from repro_torch.models.layers import (apply_rope, init_linear,
                                       init_rmsnorm, linear, rms_norm,
                                       truncated_normal_init)


def init_gqa(gen: torch.Generator, cfg: ArchConfig, dtype, device,
             kv_mult: int = 1, lead=()):
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads * kv_mult
    b = cfg.attn_bias
    p = {
        "wq": init_linear(gen, d, nq * hd, dtype, device, b, lead),
        "wk": init_linear(gen, d, nkv * hd, dtype, device, b, lead),
        "wv": init_linear(gen, d, nkv * hd, dtype, device, b, lead),
        "wo": init_linear(gen, nq * hd, d, dtype, device, b, lead),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, dtype, device, lead)
        p["k_norm"] = init_rmsnorm(hd, dtype, device, lead)
    return p


def _project_qkv(p, x, cfg: ArchConfig, kv_mult: int):
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = linear(p["wq"], x).reshape(B, S, cfg.n_heads, hd)
    k = linear(p["wk"], x).reshape(B, S, cfg.n_kv_heads * kv_mult, hd)
    v = linear(p["wv"], x).reshape(B, S, cfg.n_kv_heads * kv_mult, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _ring_slot(cache_idx: Union[int, torch.Tensor], M: int,
              device: torch.device) -> torch.Tensor:
    """The ring slot ``cache_idx % M`` as a ``[1]`` int64 index on
    ``device``: from a host int, one fill (no copy from the host); from
    a ``[1]`` int tensor on the card, computed there."""
    if isinstance(cache_idx, torch.Tensor):
        return torch.remainder(cache_idx, M).long()
    return torch.full((1,), cache_idx % M, dtype=torch.long, device=device)


def gqa_apply(p, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig,
              *, cache: Optional[dict] = None,
              cache_pos: Optional[torch.Tensor] = None,
              cache_idx: Union[int, torch.Tensor, None] = None,
              window: int = 0, causal: bool = True, kv_mult: int = 1,
              impl: Optional[str] = None, chunk: int = 0,
              scale: Optional[float] = None) -> Tuple[torch.Tensor, dict]:
    """positions: ``[S]`` int32 absolute positions of the inputs.  The
    input width is the projections' (``concat(x, x0)`` in the published
    Zamba2), the output width ``wo``'s; ``scale`` None is
    ``head_dim ** -0.5``.

    * cache=None: full-sequence attention (prefill / teacher forcing);
      returns ``(out, {"k", "v"})`` with M=S so the caller may build a
      cache.
    * cache given: decode, S == 1; writes slot ``cache_idx % M`` of
      ``cache`` and ``cache_pos`` in place and attends to the whole ring
      (``cache_pos < 0`` = empty).  Returns ``(out, cache)``.
      ``cache_idx`` is the cache's own index (not ``positions``): a host
      int, or a ``[1]`` int tensor on the cache's device, which a CUDA
      graph can capture.  Either way the slot is written by a device
      index (``_ring_slot``), so the write is one path for both.
    """
    q, k, v = _project_qkv(p, x, cfg, kv_mult)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    kw = dict(causal=causal, window=window, impl=impl, chunk=chunk,
              scale=scale)

    if cache is None:
        out = ops.attention(q, k, v, positions, positions, **kw)
        new_kv = {"k": k, "v": v}
    else:
        M = cache["k"].shape[1]
        slot = _ring_slot(cache_idx, M, cache_pos.device)
        cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
        cache_pos.index_copy_(0, slot, positions.to(cache_pos.dtype))
        out = ops.attention(q, cache["k"], cache["v"], positions, cache_pos,
                            **kw)
        new_kv = cache
    B, S = x.shape[:2]
    out = linear(p["wo"], out.reshape(B, S, cfg.n_heads * cfg.head_dim))
    return out, new_kv



# ===================================================================== MLA
def init_mla(gen: torch.Generator, cfg: ArchConfig, dtype, device,
             lead=()):
    m = cfg.mla
    d, nq = cfg.d_model, cfg.n_heads
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq": init_linear(gen, d, nq * qk_dim, dtype, device, lead=lead),
        "w_dkv": init_linear(gen, d, m.kv_lora_rank + m.qk_rope_head_dim,
                             dtype, device, lead=lead),
        "ckv_norm": init_rmsnorm(m.kv_lora_rank, dtype, device, lead),
        "w_uk": truncated_normal_init(
            gen, (m.kv_lora_rank, nq, m.qk_nope_head_dim), 1.0, dtype,
            device, lead),
        "w_uv": truncated_normal_init(
            gen, (m.kv_lora_rank, nq, m.v_head_dim), 1.0, dtype, device,
            lead),
        "wo": init_linear(gen, nq * m.v_head_dim, d, dtype, device,
                          lead=lead),
    }


def mla_cache(buf: torch.Tensor, lora: int) -> dict:
    """An MLA cache over one ``[.., M, lora + rope_dim]`` buffer: its
    ``ckv`` and ``krope`` column views."""
    return {"ckv": buf[..., :lora], "krope": buf[..., lora:]}


def latent_rows(cache: dict) -> torch.Tensor:
    """The ``[.., M, lora + rope_dim]`` latent rows of an MLA cache: a
    view of the buffer when ``ckv`` and ``krope`` are its adjacent column
    views (``mla_cache``), else their concatenation."""
    ckv, kr = cache["ckv"], cache["krope"]
    lora = ckv.shape[-1]
    if (ckv.stride() == kr.stride() and ckv.stride(-1) == 1
            and ckv.shape[:-1] == kr.shape[:-1]
            and ckv.untyped_storage().data_ptr()
            == kr.untyped_storage().data_ptr()
            and kr.data_ptr() == ckv.data_ptr() + lora * ckv.element_size()):
        return ckv.as_strided(ckv.shape[:-1] + (lora + kr.shape[-1],),
                              ckv.stride())
    return torch.cat([ckv, kr], dim=-1)


def _mla_compress(p, x, cfg: ArchConfig, positions):
    """x -> (q_nope, q_rope, ckv, k_rope) for this segment."""
    m = cfg.mla
    B, S, _ = x.shape
    nope = m.qk_nope_head_dim
    q = linear(p["wq"], x).reshape(B, S, cfg.n_heads,
                                   nope + m.qk_rope_head_dim)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    dkv = linear(p["w_dkv"], x)
    ckv = rms_norm(dkv[..., :m.kv_lora_rank], p["ckv_norm"], cfg.norm_eps)
    k_rope = dkv[..., m.kv_lora_rank:][:, :, None, :]      # [B,S,1,rope]
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)[:, :, 0, :]
    return q_nope, q_rope, ckv, k_rope


def mla_apply(p, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig,
              *, cache: Optional[dict] = None,
              cache_pos: Optional[torch.Tensor] = None,
              cache_idx: Optional[int] = None,
              window: int = 0, causal: bool = True, absorbed: bool = False,
              impl: Optional[str] = None, chunk: int = 0
              ) -> Tuple[torch.Tensor, dict]:
    """Multi-head Latent Attention.  The cache holds the COMPRESSED kv
    (``kv_lora_rank + rope_dim`` per token, shared across heads); its
    modes are ``gqa_apply``'s.

    * ``absorbed=False`` (the default) materializes per-head K (nope |
      rope, width 192 in DeepSeek-V2-Lite) and V (width 128) from the
      latent with two plain matmuls, as the reference does outside any
      kernel, then ``ops.attention``: ``flash_attention`` in prefill,
      ``decode_attention`` (16 KV heads, g = 1) at a decode step.
    * ``absorbed=True`` runs attention in the latent space, the
      memory-optimal decode: ``q_nope`` is absorbed through ``w_uk``,
      and a causal decode step is ``ops.decode_attention`` of ``[q_lat |
      q_rope]`` (width lora + rope) against the cache's latent rows, one
      KV head for all query heads, with v their first ``lora`` columns
      (a view: the kernel reads each row once); ``w_uv`` then maps the
      result out.  A full sequence (or a non-causal step) is the
      reference's plain einsums: the JAX package has no kernel there
      either, so this is its own path, not a fallback.
    """
    m = cfg.mla
    B, S, _ = x.shape
    H, lora = cfg.n_heads, m.kv_lora_rank
    q_nope, q_rope, ckv, k_rope = _mla_compress(p, x, cfg, positions)

    if cache is None:
        ckv_all, krope_all, kpos = ckv, k_rope, positions
        new_cache = {"ckv": ckv, "krope": k_rope}
    else:
        M = cache["ckv"].shape[1]
        slot = cache_idx % M
        cache["ckv"][:, slot:slot + 1] = ckv
        cache["krope"][:, slot:slot + 1] = k_rope
        cache_pos[slot:slot + 1] = positions
        ckv_all, krope_all, kpos = cache["ckv"], cache["krope"], cache_pos
        new_cache = cache

    scale = 1.0 / (m.qk_nope_head_dim + m.qk_rope_head_dim) ** 0.5
    if absorbed:
        # q~ = q_nope absorbed through w_uk: [B, S, H, lora]
        q_lat = torch.einsum("bshn,lhn->bshl", q_nope, p["w_uk"])
        if cache is not None and causal:
            lat = latent_rows(cache)[:, :, None]       # [B, M, 1, lora+rope]
            qc = torch.cat([q_lat, q_rope], dim=-1)[:, 0]
            v_lat = ops.decode_attention(qc, lat, lat[..., :lora], kpos,
                                         positions, window=window,
                                         scale=scale, impl=impl)[:, None]
        else:
            logits = (torch.einsum("bshl,btl->bhst", q_lat, ckv_all)
                      + torch.einsum("bshr,btr->bhst", q_rope,
                                     krope_all)) * scale
            logits = logits + ref._mask_bias(positions, kpos, causal, window)
            probs = torch.softmax(logits.float(), dim=-1).to(ckv_all.dtype)
            v_lat = torch.einsum("bhst,btl->bshl", probs, ckv_all)
        out = torch.einsum("bshl,lhv->bshv", v_lat, p["w_uv"]).to(x.dtype)
    else:
        T = ckv_all.shape[1]
        k_nope = torch.einsum("btl,lhn->bthn", ckv_all, p["w_uk"])
        v = torch.einsum("btl,lhv->bthv", ckv_all, p["w_uv"]).contiguous()
        k_rope_b = krope_all[:, :, None, :].expand(B, T, H,
                                                   m.qk_rope_head_dim)
        k = torch.cat([k_nope, k_rope_b], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        out = ops.attention(q, k, v, positions, kpos, causal=causal,
                            window=window, impl=impl, chunk=chunk)
    out = linear(p["wo"], out.reshape(B, S, H * m.v_head_dim))
    return out, new_cache


# ============================================================ cross-attn
def init_cross(gen: torch.Generator, cfg: ArchConfig, dtype, device,
               kv_mult: int = 1, lead=()):
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads * kv_mult
    return {
        "wq": init_linear(gen, d, nq * hd, dtype, device, lead=lead),
        "wk": init_linear(gen, d, nkv * hd, dtype, device, lead=lead),
        "wv": init_linear(gen, d, nkv * hd, dtype, device, lead=lead),
        "wo": init_linear(gen, nq * hd, d, dtype, device, lead=lead),
    }


def cross_apply(p, x: torch.Tensor, enc: torch.Tensor, cfg: ArchConfig, *,
                kv_mult: int = 1, impl: Optional[str] = None
                ) -> torch.Tensor:
    """Decoder cross-attention over the encoder output ``enc`` ``[B, T,
    d]`` (no mask, no rope): x ``[B, S, d]`` -> ``[B, S, d]``."""
    B, S, _ = x.shape
    T = enc.shape[1]
    hd = cfg.head_dim
    q = linear(p["wq"], x).reshape(B, S, cfg.n_heads, hd)
    k = linear(p["wk"], enc).reshape(B, T, cfg.n_kv_heads * kv_mult, hd)
    v = linear(p["wv"], enc).reshape(B, T, cfg.n_kv_heads * kv_mult, hd)
    qpos = torch.zeros((S,), dtype=torch.int32, device=x.device)
    kpos = torch.zeros((T,), dtype=torch.int32, device=x.device)
    out = ops.attention(q, k, v, qpos, kpos, causal=False, window=0,
                        impl=impl)
    return linear(p["wo"], out.reshape(B, S, cfg.n_heads * hd))
