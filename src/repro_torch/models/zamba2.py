"""The published Zamba2 (``Zamba2Config``, ``zamba2-7b-instruct``; HF
``Zamba2ForCausalLM``), beside the reference's simplified hybrid in
``hybrid.py`` (``zamba2-7b``), with which it shares no layer code.
With ``x0 = embed(tokens)`` and ``x = x0``, for layer l = 0 .. L-1:

* if l is the j-th entry of ``hybrid_layer_ids`` (block b = j mod
  ``num_mem_blocks``)::

      h = RMSNorm_b(concat(x, x0))                    # width 2 d
      q, k, v = h Wq_b, h Wk_b, h Wv_b                # heads of head_dim
      q, k = RoPE(q), RoPE(k)                         # all of head_dim
      a = softmax_causal(q k^T (head_dim / 2)^-1/2) v Wo_b   # -> d
      m = RMSNorm'_b(a)
      g, u = split(m Wgu_b + (m A_j) B_j)             # adapter j
      t = ((GELU(g) * u) Wdown_b) L_j                 # linear j
      x = x + Mamba_l(RMSNorm_l(x + t))

  (no residual inside the block: ``t`` reaches the residual stream only
  through the Mamba layer's input);
* otherwise ``x = x + Mamba_l(RMSNorm_l(x))``;

``Mamba_l`` as ``ssm.mamba2_apply`` with its gated norm over
``ssm.n_groups`` groups; logits ``RMSNorm(x) E^T`` (tied).  GELU is the
exact-erf one.  Params: ``{"embed", "final_norm", "mamba": {"ln",
"mixer"} stacked [L, ...], "shared": {"ln1", "attn", "ln2", "mlp":
{"gate_up", "down"}} stacked [num_mem_blocks, ...], "invocations":
{"adapter_a", "adapter_b", "linear"} stacked [J, ...]}`` (``layout``).
Cache: ``{"mamba": [L, ...], "attn": {"k", "v"} of [J, B, M, nkv,
head_dim], "pos": [M], "idx": int}``.  Every norm scale, conv bias,
``A_log``, ``D`` and ``dt_bias`` is drawn, so none sits at a constant
that would hide its absence.  ``prefill(..., cache=, rows=)`` writes a
group of sessions into batch rows of a cache that ``init_cache``
preallocated; a decode step and each part of it are spans
(``obs/spans.py``: ``lm.mamba``, ``lm.shared`` with ``.attn`` and
``.mlp``, ``lm.head``), and it counts ``kv_positions``.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import Zamba2Config
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (embed, rms_norm,
                                       truncated_normal_init, unembed)
from repro_torch.models.runtime import RuntimeOptions
from repro_torch.models.transformer import (_layer, _stack, cache_len,
                                            fit_kv_cache)
from repro_torch.obs.spans import count, span


def layout(cfg: Zamba2Config, kv_mult: int = 1
           ) -> List[Tuple[Tuple[str, ...], Tuple[int, ...], str]]:
    """``(path, shape, kind)`` of every leaf of the published params tree,
    stacked axes first (``L``, ``num_mem_blocks`` or ``J``, under
    ``mamba``, ``shared`` and ``invocations``).  ``kind``: ``"w"`` a
    weight and ``"conv"`` a conv's taps (fan-in: the first axis after
    the stacked one), ``"table"`` the tied embedding, ``"norm"`` a norm's
    scale, ``"bias"`` a conv bias, ``"A_log"``, ``"D"``,
    ``"dt_bias"``."""
    s, d = cfg.ssm, cfg.d_model
    di, H, gn, K = (s.d_inner(d), s.n_heads(d), s.n_groups * s.d_state,
                    s.conv_width)
    L, nb, J = cfg.num_layers, cfg.num_mem_blocks, len(cfg.hybrid_layer_ids)
    a, r, ff = cfg.attn_width, cfg.adapter_rank, cfg.d_ff
    kv = cfg.n_kv_heads * kv_mult * cfg.head_dim
    mx = ("mamba", "mixer")
    out = [(("embed", "table"), (cfg.padded_vocab, d), "table"),
           (("final_norm", "scale"), (d,), "norm"),
           (("mamba", "ln", "scale"), (L, d), "norm")]
    out += [(mx + (n,), (L,) + shape, kind) for n, shape, kind in (
        ("z_proj", (d, di), "w"), ("x_proj", (d, di), "w"),
        ("B_proj", (d, gn), "w"), ("C_proj", (d, gn), "w"),
        ("dt_proj", (d, H), "w"),
        ("conv_x", (K, 1, di), "conv"), ("conv_B", (K, 1, gn), "conv"),
        ("conv_C", (K, 1, gn), "conv"),
        ("conv_bx", (di,), "bias"), ("conv_bB", (gn,), "bias"),
        ("conv_bC", (gn,), "bias"),
        ("A_log", (H,), "A_log"), ("D", (H,), "D"),
        ("dt_bias", (H,), "dt_bias"),
        ("out_proj", (di, d), "w"))]
    out.append((mx + ("norm", "scale"), (L, di), "norm"))
    out += [(("shared",) + path, (nb,) + shape, kind) for path, shape, kind
            in ((("ln1", "scale"), (2 * d,), "norm"),
                (("attn", "wq", "w"), (2 * d, a), "w"),
                (("attn", "wk", "w"), (2 * d, kv), "w"),
                (("attn", "wv", "w"), (2 * d, kv), "w"),
                (("attn", "wo", "w"), (a, d), "w"),
                (("ln2", "scale"), (d,), "norm"),
                (("mlp", "gate_up", "w"), (d, 2 * ff), "w"),
                (("mlp", "down", "w"), (ff, d), "w"))]
    out += [(("invocations", n), (J,) + shape, "w") for n, shape in (
        ("adapter_a", (d, r)), ("adapter_b", (r, 2 * ff)),
        ("linear", (d, d)))]
    return out


def _draw(gen, shape, kind: str, lead: Sequence[int], dtype, device):
    """One leaf of ``kind`` (``layout``): weights truncated normal over
    the fan-in; norm scales ``1 + 0.1 n``; conv biases ``0.1 n``;
    ``A_log = log U(1, 16)``; ``D = 1 + 0.1 n``; ``dt_bias`` the inverse
    softplus of ``dt = exp U(log 1e-3, log 1e-1)`` (Mamba2's init)."""
    if kind in ("w", "table", "conv"):
        return truncated_normal_init(gen, shape, 1.0, dtype, device, lead)
    full = tuple(lead) + tuple(shape)
    f32 = torch.float32
    if kind in ("A_log", "dt_bias"):
        u = torch.rand(full, generator=gen, dtype=f32, device=device)
        if kind == "A_log":
            return torch.log(1.0 + 15.0 * u)
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                       + math.log(1e-3)).clamp_(min=1e-4)
        return dt + torch.log(-torch.expm1(-dt))
    n = torch.randn(full, generator=gen, dtype=f32, device=device)
    n.clamp_(-2.0, 2.0).mul_(0.1)
    if kind in ("norm", "D"):
        n.add_(1.0)
    return n if kind == "D" else n.to(dtype)


def _set(tree: dict, path: Sequence[str], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def init(gen: torch.Generator, cfg: Zamba2Config, rt: RuntimeOptions,
         device: DeviceLike = None):
    """Random params in the layout ``layout`` gives, drawn from ``gen``
    on ``device`` (``cuda:0`` unless the caller names another)."""
    device = resolve_device(device)
    params: dict = {}
    for path, shape, kind in layout(cfg, rt.kv_mult):
        lead = shape[:1] if path[0] in ("mamba", "shared",
                                        "invocations") else ()
        _set(params, path, _draw(gen, shape[len(lead):], kind, lead,
                                 rt.dtype, device))
    return params


def init_cache(cfg: Zamba2Config, rt: RuntimeOptions, batch: int,
               seq_len: int, device: DeviceLike = None):
    """Empty decode cache sized for ``seq_len`` total positions."""
    device = resolve_device(device)
    M = cache_len(cfg, rt, seq_len)
    shape = (len(cfg.hybrid_layer_ids), batch, M,
             cfg.n_kv_heads * rt.kv_mult, cfg.head_dim)
    return {"mamba": ssm_mod.ssm_cache_init(cfg, batch, rt.dtype, device,
                                            (cfg.num_layers,)),
            "attn": {"k": torch.zeros(shape, dtype=rt.dtype, device=device),
                     "v": torch.zeros(shape, dtype=rt.dtype, device=device)},
            "pos": torch.full((M,), -1, dtype=torch.int32, device=device),
            "idx": 0}


def _embed(params, tokens, rt):
    return embed(params["embed"], tokens.long()).to(rt.dtype)


def _invoke(cfg: Zamba2Config, rt, blk, inv, x, x0, positions, mode,
            ring, cache_pos, cache_idx):
    """One invocation of a shared block: its ``t`` (the next Mamba
    layer's extra input) and its K/V (prefill: the prompt's; decode:
    ``ring``, advanced in place)."""
    dec = mode == "decode"
    with span("lm.shared"):
        with span("lm.shared.attn"):
            h = rms_norm(torch.cat([x, x0], dim=-1), blk["ln1"],
                         cfg.norm_eps)
            a, kv = attn.gqa_apply(
                blk["attn"], h, positions, cfg, cache=ring if dec else None,
                cache_pos=cache_pos if dec else None,
                cache_idx=cache_idx if dec else None,
                window=rt.eff_window(cfg), causal=True, kv_mult=rt.kv_mult,
                impl=rt.impl, chunk=rt.attn_chunk, scale=cfg.attn_scale)
        with span("lm.shared.mlp"):
            m = rms_norm(a, blk["ln2"], cfg.norm_eps)
            gu = m @ blk["mlp"]["gate_up"]["w"] + \
                (m @ inv["adapter_a"]) @ inv["adapter_b"]
            g, u = gu.chunk(2, dim=-1)
            t = (F.gelu(g) * u) @ blk["mlp"]["down"]["w"] @ inv["linear"]
    return t, kv


def _backbone(params, x, cfg: Zamba2Config, rt, mode, cache=None,
              rows=None, positions=None):
    """The layers of the module's equations.  ``mode`` ``"train"``: the
    forward; ``"prefill"``: also the prompt's K/V and states, written
    into batch ``rows`` of ``cache`` when it is given, else returned as
    (K/V by invocation, Mamba states by layer); ``"decode"``: one step
    that advances ``cache`` in place.  Returns (x, kvs, states)."""
    if positions is None:
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
    dec, pre = mode == "decode", mode == "prefill"
    into = pre and cache is not None
    ids = list(cfg.hybrid_layer_ids)
    nb, L = cfg.num_mem_blocks, cfg.num_layers
    x0, kvs, states = x, [], []
    B, S = x.shape[:2]
    idx = cache["idx"] if dec else 0
    bounds = [0] + ids + [L]
    for seg in range(len(bounds) - 1):
        t = None
        if seg:
            j = seg - 1
            ring = _layer(cache["attn"], j) if dec else None
            t, kv = _invoke(cfg, rt, _layer(params["shared"], j % nb),
                            _layer(params["invocations"], j), x, x0,
                            positions, mode, ring,
                            cache["pos"] if dec else None, idx)
            if dec:
                count("kv_positions", B * min(idx + 1, ring["k"].shape[1]))
            elif into:
                for name in ("k", "v"):
                    cache["attn"][name][j, rows, :S].copy_(kv[name])
            elif pre:
                kvs.append(kv)
            del kv
        lo, hi = bounds[seg], bounds[seg + 1]
        if hi == lo:
            continue
        with span("lm.mamba"):
            for l in range(lo, hi):
                p = _layer(params["mamba"], l)
                h = x if t is None or l != lo else x + t
                h = rms_norm(h, p["ln"], cfg.norm_eps)
                c = _layer(cache["mamba"], l) if dec else None
                y, new_c = ssm_mod.mamba2_apply(
                    p["mixer"], h, cfg, cache=c, return_cache=pre,
                    impl=rt.impl, norm_groups=cfg.ssm.n_groups)
                x = x + y
                if into:
                    for name, v in new_c.items():
                        cache["mamba"][name][l, rows].copy_(v)
                elif pre:
                    states.append(new_c)
    return x, kvs, states


def forward(params, tokens: torch.Tensor, cfg: Zamba2Config,
            rt: RuntimeOptions, prefix_embeds: Optional[torch.Tensor] = None):
    """Teacher-forced logits ``[B, S, V_padded]`` and a zero aux term."""
    x = _backbone(params, _embed(params, tokens, rt), cfg, rt, "train")[0]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params["embed"], x), torch.zeros((), device=x.device)


def prefill(params, tokens: torch.Tensor, cfg: Zamba2Config,
            rt: RuntimeOptions, prefix_embeds: Optional[torch.Tensor] = None,
            max_len: Optional[int] = None, cache: Optional[dict] = None,
            rows: Optional[slice] = None):
    """Returns (last-token logits ``[B, V_padded]``, decode cache);
    ``max_len`` sizes the rings (defaults to S + 128).  Given ``cache``
    (``init_cache``'s, every session at the same position), the prompt's
    K/V and states go into its batch ``rows`` instead, in place, and
    that cache is returned."""
    B, S = tokens.shape
    if cache is not None:
        rows = slice(0, B) if rows is None else rows
        M = cache["attn"]["k"].shape[2]
        if S > M:
            raise ValueError(f"prefill of {S} positions into a ring of {M}")
    x, kvs, states = _backbone(params, _embed(params, tokens, rt), cfg, rt,
                               "prefill", cache, rows)
    with span("lm.head"):
        x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
        logits = unembed(params["embed"], x)[:, 0]
    if cache is not None:
        pos = torch.arange(cache["pos"].shape[0], dtype=torch.int32,
                           device=cache["pos"].device)
        cache["pos"].copy_(torch.where(pos < S, pos, -1))
        cache["idx"] = S
        return logits, cache
    M = cache_len(cfg, rt, max_len or S + 128)
    kv, pos = fit_kv_cache(_stack(kvs), S, M)
    return logits, {"mamba": _stack(states), "attn": kv, "pos": pos,
                    "idx": S}


def decode_step(params, cache, token: torch.Tensor, cfg: Zamba2Config,
                rt: RuntimeOptions):
    """token: ``[B]`` int.  Returns (logits ``[B, V_padded]``, the cache
    advanced in place, with ``idx + 1``)."""
    x = _embed(params, token[:, None], rt)
    idx = cache["idx"]
    positions = torch.full((1,), idx, dtype=torch.int32, device=x.device)
    x = _backbone(params, x, cfg, rt, "decode", cache,
                  positions=positions)[0]
    with span("lm.head"):
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = unembed(params["embed"], x)[:, 0]
    cache["idx"] = idx + 1
    return logits, cache
