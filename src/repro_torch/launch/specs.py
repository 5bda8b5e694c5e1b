"""Abstract inputs of the dry run (``repro/launch/specs.py``): fake
tensors in place of the reference's ``ShapeDtypeStruct``s for params,
optimizer state, batches and caches, built by the port's own init code
under a ``FakeTensorMode``: full shapes and dtypes, nothing allocated.

Every function here takes the ``FakeTensorMode`` to build under (a
fresh one when None); ``input_specs`` builds all of a step's inputs
under one, so they can meet in one step.  The params are drawn by
``init_lm`` (or the hybrid's, the enc-dec's) on the CPU from a CPU
generator: under the mode the draws are fake too.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.models.api import get_model
from repro_torch.models.runtime import RuntimeOptions
from repro_torch.training.optimizer import AdamW, constant_schedule


def runtime_for(cfg: ArchConfig, shape: InputShape, model_axis: int,
                dtype=torch.bfloat16, absorbed_mla: bool = False
                ) -> RuntimeOptions:
    """Pick the step's options for an (arch, shape, mesh) combo; the
    plain versions (``impl="torch"``), so no kernel runs in a dry run.
    The KV heads are duplicated up to the model axis as the reference
    does, and only where the model axis divides the query heads too:
    the reference gives a reduced arch (at most 4 query heads) 16 KV
    heads at model axis 16, which no attention can group
    (``Hq // Hkv = 0``).  For every full-size arch the two agree."""
    kv_mult = 1
    if cfg.n_kv_heads and cfg.n_kv_heads < model_axis \
            and model_axis % cfg.n_kv_heads == 0 \
            and cfg.n_heads % model_axis == 0:
        kv_mult = model_axis // cfg.n_kv_heads
    window = 0
    if shape.name == "long_500k" and cfg.n_heads:
        # attention archs need sub-quadratic handling at 524k: sliding
        # window (dense/moe/vlm/encdec and the hybrid's shared attention).
        window = cfg.long_context_window
    return RuntimeOptions(kv_mult=kv_mult, impl="torch",
                          remat=(shape.kind == "train"), window=window,
                          absorbed_mla=absorbed_mla, dtype=dtype)


def param_shapes(cfg: ArchConfig, rt: RuntimeOptions,
                 mode: Optional[FakeTensorMode] = None):
    with mode or FakeTensorMode():
        return get_model(cfg).init(torch.Generator(device="cpu"), cfg, rt,
                                   "cpu")


def opt_shapes(params, opt: AdamW, mode: Optional[FakeTensorMode] = None):
    with mode or FakeTensorMode():
        return opt.init(params)


def default_optimizer() -> AdamW:
    return AdamW(lr=constant_schedule(3e-4))


def _text_len(cfg: ArchConfig, seq_len: int) -> int:
    if cfg.family == "vlm":
        return max(1, seq_len - cfg.n_prefix_tokens)
    return seq_len


def batch_specs(cfg: ArchConfig, shape: InputShape,
                mode: Optional[FakeTensorMode] = None) -> Dict:
    """Abstract training/prefill batch for one global step."""
    B, S = shape.global_batch, shape.seq_len
    St = _text_len(cfg, S)
    with mode or FakeTensorMode():
        out = {"tokens": torch.empty((B, St), dtype=torch.int32)}
        if shape.kind == "train":
            out["labels"] = torch.empty((B, S), dtype=torch.int32)
        if cfg.n_prefix_tokens and cfg.frontend_dim:
            out["prefix_embeds"] = torch.empty(
                (B, cfg.n_prefix_tokens, cfg.frontend_dim),
                dtype=torch.bfloat16)
    return out


def cache_shapes(cfg: ArchConfig, rt: RuntimeOptions, shape: InputShape,
                 mode: Optional[FakeTensorMode] = None):
    with mode or FakeTensorMode():
        return get_model(cfg).init_cache(cfg, rt, shape.global_batch,
                                         shape.seq_len, "cpu")


def decode_token_spec(shape: InputShape,
                      mode: Optional[FakeTensorMode] = None):
    with mode or FakeTensorMode():
        return torch.empty((shape.global_batch,), dtype=torch.int32)


def input_specs(cfg: ArchConfig, shape: InputShape, rt: RuntimeOptions,
                opt: Optional[AdamW] = None,
                mode: Optional[FakeTensorMode] = None) -> Tuple:
    """All abstract step inputs for (arch x shape), built under one
    ``FakeTensorMode``: a tuple of trees matching the step's
    signature."""
    mode = mode or FakeTensorMode()
    params = param_shapes(cfg, rt, mode)
    if shape.kind == "train":
        opt = opt or default_optimizer()
        return (params, opt_shapes(params, opt, mode),
                batch_specs(cfg, shape, mode))
    if shape.kind == "prefill":
        return (params, batch_specs(cfg, shape, mode))
    return (params, cache_shapes(cfg, rt, shape, mode),
            decode_token_spec(shape, mode))
