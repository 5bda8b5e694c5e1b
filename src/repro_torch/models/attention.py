"""Grouped-query attention with ring-buffer decode caches
(``repro/models/attention.py``, its GQA part).

Cache convention (per layer; the transformer stacks these over L):
  gqa:  {"k": [B, M, kvH, hd], "v": [B, M, kvH, hd]}
plus a model-level {"pos": [M] int32 (-1 = empty), "idx": int}.
M = min(seq_len, window or seq_len); decode writes slot idx % M.

Unlike the reference, decode writes the new key and value into the
cache tensors IN PLACE (and the position into ``cache_pos``): a cache is
consumed by the step that advances it.  The mask (the reference's
``_mask_bias`` here, a copy of its oracle's) has one home in the port,
``kernels/ref.py``.  MLA and cross-attention come with their own slices
(ROADMAP §1 item 13).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (apply_rope, init_linear,
                                       init_rmsnorm, linear, rms_norm)


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


def gqa_apply(p, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig,
              *, cache: Optional[dict] = None,
              cache_pos: Optional[torch.Tensor] = None,
              cache_idx: Optional[int] = None,
              window: int = 0, causal: bool = True, kv_mult: int = 1,
              impl: Optional[str] = None, chunk: int = 0
              ) -> Tuple[torch.Tensor, dict]:
    """positions: ``[S]`` int32 absolute positions of the inputs.

    * cache=None: full-sequence attention (prefill / teacher forcing);
      returns ``(out, {"k", "v"})`` with M=S so the caller may build a
      cache.
    * cache given: decode, S == 1; writes slot ``cache_idx % M`` of
      ``cache`` and ``cache_pos`` in place and attends to the whole ring
      (``cache_pos < 0`` = empty).  Returns ``(out, cache)``.
    """
    q, k, v = _project_qkv(p, x, cfg, kv_mult)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    kw = dict(causal=causal, window=window, impl=impl, chunk=chunk)

    if cache is None:
        out = ops.attention(q, k, v, positions, positions, **kw)
        new_kv = {"k": k, "v": v}
    else:
        M = cache["k"].shape[1]
        slot = cache_idx % M
        cache["k"][:, slot:slot + 1] = k
        cache["v"][:, slot:slot + 1] = v
        cache_pos[slot:slot + 1] = positions
        out = ops.attention(q, cache["k"], cache["v"], positions, cache_pos,
                            **kw)
        new_kv = cache
    B, S = x.shape[:2]
    out = linear(p["wo"], out.reshape(B, S, cfg.n_heads * cfg.head_dim))
    return out, new_kv

