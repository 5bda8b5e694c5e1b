"""Family-dispatching model API (``repro/models/api.py``).

    model = get_model(cfg)
    params = model.init(gen, cfg, rt, device)
    logits, aux = model.forward(params, tokens, cfg, rt, prefix_embeds=None)
    logits, cache = model.prefill(...)
    logits, cache = model.decode_step(params, cache, token, cfg, rt)
    cache = model.init_cache(cfg, rt, batch, seq_len, device)

Every family of the reference has its assembly: dense, VLM, MoE and
pure SSM in ``transformer.py`` (GQA or MLA attention; ``deepseek-v2-lite-16b``
is a MoE model with MLA), the Mamba2 backbone with a shared attention
block in ``hybrid.py`` (``zamba2-7b``), the published Zamba2's two
alternating shared blocks in ``zamba2.py`` (a ``Zamba2Config``:
``zamba2-7b-instruct``) and the audio encoder-decoder in ``encdec.py``
(``seamless-m4t-medium``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs.base import ArchConfig, Zamba2Config
from repro_torch.models import encdec, hybrid, transformer, zamba2


@dataclasses.dataclass(frozen=True)
class ModelApi:
    init: Callable
    forward: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable


_TRANSFORMER = ModelApi(
    init=transformer.init_lm,
    forward=transformer.forward,
    prefill=transformer.prefill,
    decode_step=transformer.decode_step,
    init_cache=transformer.init_cache,
)

_HYBRID = ModelApi(
    init=hybrid.init_hybrid,
    forward=hybrid.forward,
    prefill=hybrid.prefill,
    decode_step=hybrid.decode_step,
    init_cache=hybrid.init_cache,
)

_ZAMBA2 = ModelApi(
    init=zamba2.init,
    forward=zamba2.forward,
    prefill=zamba2.prefill,
    decode_step=zamba2.decode_step,
    init_cache=zamba2.init_cache,
)

_ENCDEC = ModelApi(
    init=encdec.init_encdec,
    forward=encdec.forward,
    prefill=encdec.prefill,
    decode_step=encdec.decode_step,
    init_cache=encdec.init_cache,
)


def get_model(cfg: ArchConfig) -> ModelApi:
    if isinstance(cfg, Zamba2Config):
        return _ZAMBA2
    if cfg.family in ("dense", "vlm", "moe", "ssm"):
        return _TRANSFORMER
    if cfg.family == "hybrid":
        return _HYBRID
    if cfg.family == "encdec":
        return _ENCDEC
    raise ValueError(f"unknown family {cfg.family!r}")
