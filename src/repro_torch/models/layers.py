"""Shared layer primitives: norms, linears, rotary embeddings, SwiGLU MLP
and the token loss (``repro/models/layers.py:15-114``).

Parameters are plain nested dicts of tensors in the reference's layout,
so a JAX params tree carries across as a change of array type
(``models/convert.py``).  Each ``init_*`` draws from a
``torch.Generator`` on the target device; ``lead`` is the shape of the
leading stacked-layer axes (``[L]`` for a segment), drawn independently
per layer as the reference's ``jax.vmap`` over layer keys does.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

_SQRT2 = math.sqrt(2.0)


def truncated_normal_init(gen: torch.Generator, shape: Sequence[int],
                          scale: float, dtype: torch.dtype,
                          device: torch.device,
                          lead: Sequence[int] = ()) -> torch.Tensor:
    """``lead + shape`` draws of a normal truncated to [-2, 2], times
    ``scale / sqrt(shape[0])``.  The fan-in is the PER-LAYER
    ``shape[0]``: under the reference's vmap a stacked ``[L, d_in,
    d_out]`` leaf is scaled by ``d_in``, not by ``L``.  Sampled as
    ``jax.random.truncated_normal`` does (inverse erf of a uniform
    between ``erf(-2/√2)`` and ``erf(2/√2)``), in place, so drawing a
    4-B-parameter model on the card needs no temporaries; the std of the
    result is ``0.8796 · scale / sqrt(shape[0])``."""
    stddev = scale / max(1.0, (shape[0] if len(shape) else 1)) ** 0.5
    lo, hi = math.erf(-2.0 / _SQRT2), math.erf(2.0 / _SQRT2)
    x = torch.rand(tuple(lead) + tuple(shape), generator=gen,
                   dtype=torch.float32, device=device)
    x.mul_(hi - lo).add_(lo).erfinv_().mul_(_SQRT2).clamp_(-2.0, 2.0)
    return x.mul_(stddev).to(dtype)


# ---------------------------------------------------------------- norms
def init_rmsnorm(d: int, dtype: torch.dtype, device: torch.device,
                 lead: Sequence[int] = ()):
    return {"scale": torch.ones(tuple(lead) + (d,), dtype=dtype,
                                device=device)}


def rms_norm(x: torch.Tensor, p, eps: float = 1e-5) -> torch.Tensor:
    """Computed in float32, as the reference (``layers.py:26``)."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    return (x * p["scale"].float()).to(dt)


# ---------------------------------------------------------------- linear
def init_linear(gen, d_in: int, d_out: int, dtype, device,
                bias: bool = False, lead: Sequence[int] = ()):
    p = {"w": truncated_normal_init(gen, (d_in, d_out), 1.0, dtype, device,
                                    lead)}
    if bias:
        p["b"] = torch.zeros(tuple(lead) + (d_out,), dtype=dtype,
                             device=device)
    return p


def linear(p, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


# ---------------------------------------------------------------- rope
@functools.lru_cache(maxsize=None)
def _rope_freqs(half: int, theta: float,
                device: torch.device) -> torch.Tensor:
    """``exp(-log(theta) * arange(half) / half)`` in float32, in the
    reference's order of operations (``layers.py:55``).  Made once per
    device on the CPU: a tensor built from host data on the card would
    stall the host until the card drains its queue, at every call."""
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32))
    freqs = torch.exp(-log_theta * torch.arange(half, dtype=torch.float32)
                      / half)
    return freqs.to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Half-rotation RoPE.  x: ``[..., seq, heads, head_dim]``;
    positions broadcastable to ``x.shape[:-2]``."""
    half = x.shape[-1] // 2
    freqs = _rope_freqs(half, float(theta), x.device)
    ang = positions.float()[..., None, None] * freqs          # [.., 1, half]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- mlp
def init_swiglu(gen, d_model: int, d_ff: int, dtype, device,
                bias: bool = False, lead: Sequence[int] = ()):
    return {
        "gate": init_linear(gen, d_model, d_ff, dtype, device, bias, lead),
        "up": init_linear(gen, d_model, d_ff, dtype, device, bias, lead),
        "down": init_linear(gen, d_ff, d_model, dtype, device, bias, lead),
    }


def swiglu(p, x: torch.Tensor) -> torch.Tensor:
    return linear(p["down"], F.silu(linear(p["gate"], x))
                  * linear(p["up"], x))


# ---------------------------------------------------------------- embed
def init_embedding(gen, vocab: int, d_model: int, dtype, device,
                   tied: bool = False):
    p = {"table": truncated_normal_init(gen, (vocab, d_model), 1.0, dtype,
                                        device)}
    if not tied:
        p["head"] = truncated_normal_init(gen, (d_model, vocab), 1.0, dtype,
                                          device)
    return p


def embed(p, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens]


def unembed(p, x: torch.Tensor) -> torch.Tensor:
    """Logits over the PADDED vocabulary (the padded rows of the head
    are random, as in the reference; greedy argmax runs over them)."""
    if "head" in p:
        return x @ p["head"]
    return x @ p["table"].T


# ---------------------------------------------------------------- loss
def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 vocab_size: Optional[int] = None) -> torch.Tensor:
    """Mean token cross-entropy over the tokens whose label is >= 0
    (``repro/models/layers.py:102``); the denominator is clamped to at
    least 1, so an all-masked batch gives 0.  ``vocab_size`` is unused,
    as in the reference."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels.clamp(min=0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    return ((logz - gold) * mask).sum() / mask.sum().clamp(min=1.0)
