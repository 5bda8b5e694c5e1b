"""Runtime options, orthogonal to the architecture config
(``repro/models/runtime.py``), with the reference's fields and
defaults."""
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
    remat:              activation checkpointing: each layer (each
                        super-block of the hybrid, each encoder and
                        decoder layer) is recomputed in the backward
                        pass (``torch.utils.checkpoint``), as the
                        reference's ``jax.checkpoint`` of its scan body.
    scan_unroll:        the reference unrolls its layer scans so that
                        XLA's cost analysis counts every layer (its
                        roofline probes).  The port's layers are Python
                        loops, so every layer is already run and
                        counted: the field changes nothing.
    moe_impl:           ``"gspmd"`` (``moe.moe_apply``) or
                        ``"shard_map"`` (``moe.moe_apply_sharded``: an
                        explicit schedule, one all-reduce over the model
                        axis a MoE layer); needs ``mesh``.
    mesh:               the ``DeviceMesh`` the sharded MoE runs over
                        (``launch/mesh.py``); None otherwise.
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
    remat: bool = False
    scan_unroll: bool = False
    moe_impl: str = "gspmd"
    mesh: object = None
    attn_chunk: int = 0

    def __post_init__(self):
        if self.impl not in IMPLS:
            raise ValueError(f"impl={self.impl!r} not in {IMPLS}")
        if self.moe_impl not in ("gspmd", "shard_map"):
            raise ValueError(f"moe_impl={self.moe_impl!r} not in "
                             "('gspmd', 'shard_map')")

    def eff_window(self, cfg) -> int:
        return self.window or cfg.sliding_window
