"""1-D "stripe" ResNeXt ECG classifiers: the paper's model-zoo family
(the port of ``repro/models/ecg_resnext.py``).

Parameters are plain dicts of tensors in the JAX package's layout
(conv weights ``[K, Cin // groups, Cout]``, channels-last activations),
so converted JAX params and the committed zoo cache load unchanged
(``models.convert``).  Every conv goes through ``kernels.ops.conv1d``:
the CUDA kernel on the card, the plain version on the CPU.  GroupNorm,
ReLU, the mean pool, the head and the softmax stay plain PyTorch, as
the JAX package leaves them to XLA.

x: ``[B, L, 1]`` single-lead clip  ->  logits ``[B, 2]``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.ecg_zoo import EcgModelSpec
from repro_torch.kernels import ops


def inner_width(spec: EcgModelSpec) -> int:
    """Channels inside a block: half the width, a multiple of the
    cardinality."""
    inner = max(spec.cardinality, spec.width // 2)
    return inner - inner % spec.cardinality


def _trunc_normal(shape, gen: torch.Generator) -> torch.Tensor:
    """Truncated normal at +-2 sigma, sigma = 1 / sqrt(shape[0]) (the
    JAX package's ``truncated_normal_init`` at scale 1)."""
    t = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t / max(1.0, shape[0]) ** 0.5


def _init_conv(gen, k: int, cin: int, cout: int, groups: int = 1):
    return {"w": _trunc_normal((k, cin // groups, cout), gen),
            "b": torch.zeros(cout)}


def _init_gn(c: int):
    return {"scale": torch.ones(c), "bias": torch.zeros(c)}


def init_ecg(spec: EcgModelSpec, generator: torch.Generator,
             device: Optional[torch.device] = None) -> Dict:
    """Random member params, drawn on the CPU from ``generator`` (so the
    same seed gives the same weights on any device) and moved to
    ``device`` (``None`` keeps them on the CPU; ``EnsembleService``
    moves its members to its own device).  The draws differ from
    ``jax.random``'s: parity tests carry JAX params across with
    ``models.convert`` instead."""
    W, K = spec.width, spec.kernel_size
    inner = inner_width(spec)
    params = {
        "stem": _init_conv(generator, K, 1, W),
        "stem_gn": _init_gn(W),
        "blocks": [{
            "reduce": _init_conv(generator, 1, W, inner),
            "gn1": _init_gn(inner),
            "stripe": _init_conv(generator, K, inner, inner,
                                 groups=spec.cardinality),
            "gn2": _init_gn(inner),
            "expand": _init_conv(generator, 1, inner, W),
            "gn3": _init_gn(W),
        } for _ in range(spec.blocks)],
        "head": {"w": _trunc_normal((W, 2), generator),
                 "b": torch.zeros(2)},
    }
    if device is None:
        return params
    return map_params(params, lambda t: t.to(device))


def map_params(params, fn):
    """Apply ``fn`` to every tensor leaf of a params tree."""
    if isinstance(params, dict):
        return {k: map_params(v, fn) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [map_params(v, fn) for v in params]
    return fn(params)


def _group_norm(p, x: torch.Tensor, groups: int = 4,
                eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over ``[..., L, C]`` (leading member/batch axes kept),
    with the reference's group fallback: ``g = min(groups, C)``,
    decreased until it divides ``C``.  ``p``'s scale and bias are
    ``[C]``, or ``[M, C]`` for a stacked ``[M, B, L, C]`` input."""
    *lead, L, C = x.shape
    g = min(groups, C)
    while C % g:
        g -= 1
    xg = x.reshape(*lead, L, g, C // g)
    dims = (-3, -1)
    mu = xg.mean(dim=dims, keepdim=True)
    var = xg.var(dim=dims, correction=0, keepdim=True)
    xg = (xg - mu) * torch.rsqrt(var + eps)
    scale, bias = p["scale"], p["bias"]
    if scale.dim() == 2:                       # stacked: [M, C]
        scale, bias = scale[:, None, None, :], bias[:, None, None, :]
    return xg.reshape(x.shape) * scale + bias


def _trunk(params: Dict, x: torch.Tensor, spec: EcgModelSpec,
           impl: Optional[str]) -> torch.Tensor:
    """Stem and residual blocks on ``[..., B, L, 1]``; returns the
    pooled features ``[..., B, W]``."""
    card = spec.cardinality
    h = ops.conv1d(x, params["stem"]["w"], params["stem"]["b"], stride=2,
                   impl=impl)
    h = torch.relu(_group_norm(params["stem_gn"], h))
    for i, blk in enumerate(params["blocks"]):
        stride = 2 if i % 2 == 0 else 1
        r = ops.conv1d(h, blk["reduce"]["w"], blk["reduce"]["b"],
                       impl=impl)
        r = torch.relu(_group_norm(blk["gn1"], r))
        r = ops.conv1d(r, blk["stripe"]["w"], blk["stripe"]["b"],
                       stride=stride, groups=card, impl=impl)
        r = torch.relu(_group_norm(blk["gn2"], r))
        r = ops.conv1d(r, blk["expand"]["w"], blk["expand"]["b"],
                       impl=impl)
        r = _group_norm(blk["gn3"], r)
        shortcut = h[..., ::stride, :] if stride > 1 else h
        h = torch.relu(shortcut[..., :r.shape[-2], :] + r)
    return h.mean(dim=-2)


def ecg_apply(params: Dict, x: torch.Tensor, spec: EcgModelSpec,
              impl: Optional[str] = None) -> torch.Tensor:
    """x: ``[B, L, 1]`` -> logits ``[B, 2]``."""
    pooled = _trunk(params, x, spec, impl)                 # [B, W]
    return pooled @ params["head"]["w"] + params["head"]["b"]


def ecg_apply_stacked(params: Dict, x: torch.Tensor, spec: EcgModelSpec,
                      impl: Optional[str] = None) -> torch.Tensor:
    """Forward pass over a whole architecture bucket: ``params`` is the
    ``stack_members`` tree (leading member axis M), ``x`` is
    ``[M, B, L, 1]`` (each member's lead over a shared micro-batch).
    Returns logits ``[M, B, 2]``; every conv is one launch of the
    member-stacked kernel on the card."""
    pooled = _trunk(params, x, spec, impl)                 # [M, B, W]
    return (torch.bmm(pooled, params["head"]["w"])
            + params["head"]["b"][:, None, :])


def ecg_macs(spec: EcgModelSpec) -> float:
    """Analytic multiply-accumulate count (the MACS field of the paper's
    Table-3 model profile)."""
    L = spec.input_len / 2                              # after stem stride
    W, K, card = spec.width, spec.kernel_size, spec.cardinality
    macs = spec.input_len / 2 * K * W                   # stem
    inner = inner_width(spec)
    for i in range(spec.blocks):
        stride = 2 if i % 2 == 0 else 1
        macs += L * W * inner                           # reduce 1x1
        L = L / stride
        macs += L * K * inner * inner / card            # grouped stripe
        macs += L * inner * W                           # expand 1x1
    macs += W * 2
    return float(macs)


def leaves(params):
    """Every tensor of a params tree, dict keys in sorted order (the
    order of ``jax.tree.leaves`` on the reference's tree)."""
    if isinstance(params, dict):
        for k in sorted(params):
            yield from leaves(params[k])
    elif isinstance(params, (list, tuple)):
        for v in params:
            yield from leaves(v)
    else:
        yield params


def ecg_param_count(params: Dict) -> int:
    return sum(t.numel() for t in leaves(params))
