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
``.at[e, s].add`` does.

``moe_apply_sharded`` is the reference's shard_map variant, built on
``local_map`` over a ``DeviceMesh`` (``launch/mesh.py``): tokens stay on
their batch shard, expert weights are f-sharded over "model", and the
only collectives are one all-reduce of the token-space output over
"model" and a mean of the aux loss over the batch dims.  Inside, the
Megatron pair carries the gradients: what enters the f-sharded compute
from replicated values is the identity forward and an all-reduce
backward (``_ToModel``); the output's all-reduce is the identity
backward (``_FromModel``).  On a one-rank mesh both are copies, so the
result is bitwise ``moe_apply``'s.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
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
                       device=x.device).index_put_(
        (bidx, flat_e, slot), vals, accumulate=True)
    xe = xbuf.transpose(0, 1).reshape(E, B * r.capacity, d)
    return Dispatch(xe, bidx, flat_e, slot)


def _moe_dispatch_compute(p, x: torch.Tensor, cfg: ArchConfig,
                          capacity_factor: float, impl: Optional[str]
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routing, capacity dispatch and the grouped expert SwiGLU (no
    shared expert)."""
    r = route(p, x, cfg, capacity_factor)
    return _experts(p, x, r, dispatch(x, r, cfg.moe.n_routed_experts),
                    cfg, impl), r.aux


def _experts(p, x: torch.Tensor, r: Routing, dp: Dispatch,
             cfg: ArchConfig, impl: Optional[str]) -> torch.Tensor:
    """The grouped expert SwiGLU over the dispatched buffer, gathered
    back and combined with the top-k weights."""
    B, S, d = x.shape
    E, K = cfg.moe.n_routed_experts, cfg.moe.top_k
    # expert compute (grouped matmul kernel)
    ye = ops.moe_gmm(dp.xe, p["w_gate"], p["w_up"], p["w_down"], impl=impl)
    ybuf = ye.reshape(E, B, r.capacity, d).transpose(0, 1)      # [B,E,C,d]

    # gather back and combine
    y_choice = ybuf[dp.bidx, dp.expert, dp.slot] \
        * r.keep[..., None].to(ybuf.dtype)
    y_choice = y_choice.reshape(B, S, K, d)
    return (y_choice * r.top_p[..., None].to(y_choice.dtype)).sum(dim=2)


def moe_apply(p, x: torch.Tensor, cfg: ArchConfig, *,
              capacity_factor: float = 1.25, impl: Optional[str] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x ``[B, S, d]`` -> (y ``[B, S, d]``, aux loss scalar)."""
    y, aux = _moe_dispatch_compute(p, x, cfg, capacity_factor, impl)
    if cfg.moe.n_shared_experts:
        y = y + swiglu(p["shared"], x)
    return y, aux


# ------------------------------------------------------------ sharded
class _ToModel(torch.autograd.Function):
    """A value used whole on every rank of ``group`` (entering the
    f-sharded compute, or a plain input sliced over ``group``): identity
    forward, all-reduce of the gradient over ``group`` backward (JAX's
    implicit pbroadcast)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _FromModel(torch.autograd.Function):
    """Leaves it: all-reduce over ``group`` forward (the psum), identity
    backward."""

    @staticmethod
    def forward(ctx, t, group):
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherBatch(torch.autograd.Function):
    """This rank's rows of a batch sharded over ``group`` made whole:
    all-gather forward; backward, the gradient's own rows (every rank
    holds the same gradient of the whole batch)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.rank, ctx.n = dist.get_rank(group), dist.get_world_size(group)
        parts = [torch.empty_like(t) for _ in range(ctx.n)]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n)[ctx.rank], None


class _MeanOver(torch.autograd.Function):
    """The mean over ``group`` (the pmean): all-reduce / n forward,
    gradient / n backward."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.n = dist.get_world_size(group)
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def _moe_local(p, x: torch.Tensor, cfg: ArchConfig,
               capacity_factor: float, impl: Optional[str],
               group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routed-expert compute on local tokens with f-sharded weights.
    Output is the PARTIAL (pre-all-reduce) token-space result; the
    routing is computed whole on every rank of ``group`` (the model
    axis), and what it hands the f-sharded compute enters through
    ``_ToModel``."""
    r = route(p, x, cfg, capacity_factor)
    dp = dispatch(x, r, cfg.moe.n_routed_experts)
    if group is not None:
        dp = dp._replace(xe=_ToModel.apply(dp.xe, group))
        r = r._replace(top_p=_ToModel.apply(r.top_p, group))
    return _experts(p, x, r, dp, cfg, impl), r.aux


def _sharded_dims(cfg: ArchConfig):
    """(path, tensor dim sharded over "model" or None) of a MoE layer's
    params (``repro/models/moe.py:72-83``)."""
    out = [(("router",), None), (("w_gate",), 2), (("w_up",), 2),
           (("w_down",), 1)]
    if cfg.moe.n_shared_experts:
        out += [(("shared", "gate", "w"), 1), (("shared", "up", "w"), 1),
                (("shared", "down", "w"), 0)]
    return out


def moe_apply_sharded(p, x: torch.Tensor, cfg: ArchConfig, mesh, *,
                      capacity_factor: float = 1.25,
                      impl: Optional[str] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_apply`` with an explicit collective schedule over ``mesh``
    (a ``DeviceMesh`` with a "model" dim and batch dims "pod"/"data"):
    every step of routing, dispatch and expert compute is shard-local
    (batch on the batch dims, expert f on "model"), and the only
    collectives are one all-reduce of the combined output ``[B_loc, S,
    d]`` over "model" (the row-parallel down projection, merged with the
    shared expert's) and a mean of the aux loss over the batch dims.

    ``p`` and ``x`` are DTensors on ``mesh`` (the dry run), run through
    ``local_map``; each param's gradient is then a partial sum over the
    batch dims, as the transpose of its broadcast over the batch is
    (``local_map`` would take it as replicated).  Or they are plain
    tensors whole on every rank (the served path), sliced to this rank's
    shards, the output's batch gathered back whole; every gradient is
    whole on every rank (``_ToModel`` over each mesh dim a leaf is split
    over or broadcast across the batch of).  Plain tensors skip
    ``local_map``: taken as replicated DTensors they cost ~100 ms more a
    token in deepseek's 26-layer decode on a one-rank NCCL mesh of an
    H100 (PERF.md §6)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    names = mesh.mesh_dim_names
    model = mesh.get_group("model")
    batch = [mesh.get_group(a) for a in names if a in ("pod", "data")]
    specs = _sharded_dims(cfg)

    def node(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    def place(dim, over_batch=Replicate()):
        return tuple(Shard(dim) if a == "model" and dim is not None
                     else over_batch if a in ("pod", "data")
                     else Replicate() for a in names)

    x_place = tuple(Shard(0) if a in ("pod", "data") else Replicate()
                    for a in names)
    leaves = [node(p, path) for path, _ in specs] + [x]
    in_place = tuple(place(dim) for _, dim in specs) + (x_place,)
    grad_place = tuple(place(dim, Partial()) for _, dim in specs) \
        + (x_place,)

    def local(*args):
        *ls, x_l = args
        p_l = {}
        for (path, _), t in zip(specs, ls):
            d = p_l
            for k in path[:-1]:
                d = d.setdefault(k, {})
            d[path[-1]] = t
        y, aux = _moe_local(p_l, x_l, cfg, capacity_factor, impl, model)
        if cfg.moe.n_shared_experts:
            y = y + swiglu(p_l["shared"], _ToModel.apply(x_l, model))
        y = _FromModel.apply(y, model)
        for g in batch:
            aux = _MeanOver.apply(aux, g)
        return y, aux

    if isinstance(x, DTensor):
        return local_map(local, out_placements=(x_place, place(None)),
                         in_placements=in_place,
                         in_grad_placements=grad_place, device_mesh=mesh,
                         redistribute_inputs=True)(*leaves)
    from repro_torch.launch.sharding import local_shard

    def shard(t, pl):
        for i, (a, q) in enumerate(zip(names, pl)):
            if mesh.size(i) > 1 and (isinstance(q, Shard)
                                     or a in ("pod", "data")):
                t = _ToModel.apply(t, mesh.get_group(i))
        return local_shard(t, pl, mesh)

    y, aux = local(*map(shard, leaves, in_place))
    for i in reversed(range(len(names))):
        if names[i] in ("pod", "data") and mesh.size(i) > 1:
            y = _GatherBatch.apply(y, mesh.get_group(i))
    return y, aux
