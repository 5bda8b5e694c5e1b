"""Runtime options, orthogonal to the architecture config
(``repro/models/runtime.py``).

The serving and training subset: ``remat`` and ``scan_unroll`` (the
reference's memory and compile levers of a jitted train step),
``moe_impl`` and ``mesh`` (the sharded MoE) belong to ROADMAP §1 item
14, which the port does not carry yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels.ops import IMPLS


@dataclasses.dataclass(frozen=True)
class RuntimeOptions:
    """kv_mult:         duplicate KV heads by this factor (numerics-
                        invariant; kept for parity with the reference).
    impl:               kernel dispatch, as ``kernels.ops``: ``None``
                        (by the tensor's device), ``"torch"`` (the plain
                        versions), ``"cuda"`` (the kernels).
    window:             attention-window override; 0 keeps
                        ``cfg.sliding_window``.
    absorbed_mla:       latent-space MLA attention (decode memory
                        optimization): a decode step attends over the
                        compressed cache itself (``models/attention.py``
                        ``mla_apply``).
    capacity_factor:    MoE dispatch capacity factor: an expert takes
                        ``_capacity(S, top_k, E, capacity_factor)``
                        tokens of each sequence (``models/moe.py``);
                        the choices past it are dropped.
    dtype:              parameter and activation type.
    attn_chunk:         online softmax over KV chunks in the plain
                        version; 0 materialises the [S, T] scores.  The
                        CUDA kernel ignores it, as the Pallas route does.
    """
    kv_mult: int = 1
    impl: Optional[str] = None
    window: int = 0
    absorbed_mla: bool = False
    capacity_factor: float = 1.25
    dtype: torch.dtype = torch.float32
    attn_chunk: int = 0

    def __post_init__(self):
        if self.impl not in IMPLS:
            raise ValueError(f"impl={self.impl!r} not in {IMPLS}")

    def eff_window(self, cfg) -> int:
        return self.window or cfg.sliding_window
