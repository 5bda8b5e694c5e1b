"""Mixture-of-Experts layer: top-k router and capacity-based grouped
dispatch (``repro/models/moe.py``).

Tokens are scattered into a per-sequence capacity buffer ``[B, E, C, d]``
(the groups are the batch rows), laid out as ``[E, B·C, d]`` and sent
through ``ops.moe_gmm`` (the CUDA ``moe_gmm`` kernel on the card), then
gathered back and combined with the renormalised top-k weights.  Each
token is computed by exactly its top-k experts, except the choices past
an expert's capacity, which are dropped (GShard/Switch).

The routing is carried over exactly: ``torch.topk(sorted=True)`` for
``jax.lax.top_k``, a stable argsort for the position of each choice in
its expert, and a scatter-add (``index_put_(accumulate=True)``) in which
a dropped choice adds zeros into slot 0 of its expert, as
``.at[e, s].add`` does.  The reference's shard_map variant
(``moe_apply_sharded``, ``_moe_local``) is mesh code and comes with the
port's mesh slice.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (init_swiglu, swiglu,
                                       truncated_normal_init)


def init_moe(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype,
             device: torch.device, lead: Sequence[int] = ()):
    """One MoE MLP's params (``lead`` stacks them).  Expert leaves are
    ``[E, d, f]`` and, as in the reference, scaled by their first axis
    (E), not by d."""
    m = cfg.moe
    d = cfg.d_model
    E, f = m.n_routed_experts, m.expert_d_ff

    def ew(shape):
        return truncated_normal_init(gen, shape, 1.0, dtype, device, lead)

    p = {"router": ew((d, E)),
         "w_gate": ew((E, d, f)),
         "w_up": ew((E, d, f)),
         "w_down": ew((E, f, d))}
    if m.n_shared_experts:
        p["shared"] = init_swiglu(gen, d, m.shared_d_ff, dtype, device,
                                  lead=lead)
    return p


def _capacity(S: int, top_k: int, E: int, cf: float) -> int:
    c = int(S * top_k / E * cf) + 1
    return max(top_k, (c + 3) // 4 * 4)


class Routing(NamedTuple):
    """One MoE layer's routing of ``x [B, S, d]``."""
    probs: torch.Tensor       # [B, S, E] float32 router softmax
    top_p: torch.Tensor       # [B, S, K] renormalised weights
    top_e: torch.Tensor       # [B, S, K] chosen experts, best first
    pos_in_e: torch.Tensor    # [B, S*K] rank of each choice in its expert
    keep: torch.Tensor        # [B, S*K] bool: within capacity
    aux: torch.Tensor         # () Switch load-balance loss
    capacity: int


def route(p, x: torch.Tensor, cfg: ArchConfig,
          capacity_factor: float) -> Routing:
    """Top-k routing, the load-balance loss and each choice's slot
    (``moe.py:129-158``)."""
    m = cfg.moe
    B, S, _ = x.shape
    E, K = m.n_routed_experts, m.top_k
    C = _capacity(S, K, E, capacity_factor)

    logits = (x @ p["router"].float().to(x.dtype)).float()      # [B,S,E]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, K, dim=-1, sorted=True)     # [B,S,K]
    top_p = top_p / top_p.sum(-1, keepdim=True)

    # load-balance auxiliary loss (Switch-style)
    frac_tokens = F.one_hot(top_e, E).float().mean(dim=(1, 2))  # [B,E]
    mean_prob = probs.mean(dim=1)                               # [B,E]
    aux = E * (frac_tokens * mean_prob).sum(-1).mean()

    # position in expert via a stable sort over the choices
    flat_e = top_e.reshape(B, S * K)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    counts = F.one_hot(flat_e, E).sum(1)                        # [B,E]
    offsets = counts.cumsum(-1) - counts                        # exclusive
    rank_sorted = (torch.arange(S * K, device=x.device)[None, :]
                   - torch.gather(offsets, 1, sorted_e))
    inv = torch.argsort(order, dim=-1)
    pos_in_e = torch.gather(rank_sorted, 1, inv)                # [B,S*K]
    return Routing(probs, top_p, top_e, pos_in_e, pos_in_e < C,
                   aux.float(), C)


class Dispatch(NamedTuple):
    """Where each routed choice sits in the capacity buffer."""
    xe: torch.Tensor          # [E, B*C, d] the buffer ``moe_gmm`` takes
    bidx: torch.Tensor        # [B, S*K] each choice's sequence
    expert: torch.Tensor      # [B, S*K] its expert
    slot: torch.Tensor        # [B, S*K] its row in the expert (0 if dropped)


def dispatch(x: torch.Tensor, r: Routing, E: int) -> Dispatch:
    """Scatter the tokens of ``x [B, S, d]`` into the per-sequence
    capacity buffer ``[B, E, C, d]`` (a dropped choice adds zeros into
    slot 0 of its expert, as ``.at[e, s].add`` does) and lay it out as
    ``[E, B·C, d]``.  Rows no choice reached are zeros."""
    B, S, d = x.shape
    K = r.top_e.shape[-1]
    flat_e = r.top_e.reshape(B, S * K)
    slot = torch.where(r.keep, r.pos_in_e, torch.zeros_like(r.pos_in_e))
    tok = torch.arange(S, device=x.device).repeat_interleave(K)  # [S*K]
    bidx = torch.arange(B, device=x.device)[:, None].expand(B, S * K)
    vals = x[:, tok] * r.keep[..., None].to(x.dtype)            # [B,SK,d]
    xbuf = torch.zeros((B, E, r.capacity, d), dtype=x.dtype,
                       device=x.device)
    xbuf.index_put_((bidx, flat_e, slot), vals, accumulate=True)
    xe = xbuf.transpose(0, 1).reshape(E, B * r.capacity, d)
    return Dispatch(xe, bidx, flat_e, slot)


def _moe_dispatch_compute(p, x: torch.Tensor, cfg: ArchConfig,
                          capacity_factor: float, impl: Optional[str]
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routing, capacity dispatch and the grouped expert SwiGLU (no
    shared expert)."""
    B, S, d = x.shape
    E, K = cfg.moe.n_routed_experts, cfg.moe.top_k
    r = route(p, x, cfg, capacity_factor)
    dp = dispatch(x, r, E)

    # expert compute (grouped matmul kernel)
    ye = ops.moe_gmm(dp.xe, p["w_gate"], p["w_up"], p["w_down"], impl=impl)
    ybuf = ye.reshape(E, B, r.capacity, d).transpose(0, 1)      # [B,E,C,d]

    # gather back and combine
    y_choice = ybuf[dp.bidx, dp.expert, dp.slot] \
        * r.keep[..., None].to(ybuf.dtype)
    y_choice = y_choice.reshape(B, S, K, d)
    y = (y_choice * r.top_p[..., None].to(y_choice.dtype)).sum(dim=2)
    return y, r.aux


def moe_apply(p, x: torch.Tensor, cfg: ArchConfig, *,
              capacity_factor: float = 1.25, impl: Optional[str] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x ``[B, S, d]`` -> (y ``[B, S, d]``, aux loss scalar)."""
    y, aux = _moe_dispatch_compute(p, x, cfg, capacity_factor, impl)
    if cfg.moe.n_shared_experts:
        y = y + swiglu(p["shared"], x)
    return y, aux
