"""Family-dispatching model API (``repro/models/api.py``).

    model = get_model(cfg)
    params = model.init(gen, cfg, rt, device)
    logits, aux = model.forward(params, tokens, cfg, rt, prefix_embeds=None)
    logits, cache = model.prefill(...)
    logits, cache = model.decode_step(params, cache, token, cfg, rt)
    cache = model.init_cache(cfg, rt, batch, seq_len, device)

The port assembles the dense, VLM, MoE and pure-SSM families, with GQA
or MLA attention (``deepseek-v2-lite-16b`` is a MoE model with MLA);
hybrid and enc-dec are a later slice (ROADMAP §1 item 13) and raise
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer


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

_LATER = {
    "hybrid": "13.5 (hybrid: models/hybrid.py)",
    "encdec": "13.5 (enc-dec: models/encdec.py)",
}


def get_model(cfg: ArchConfig) -> ModelApi:
    if cfg.family in ("dense", "vlm", "moe", "ssm"):
        return _TRANSFORMER
    if cfg.family in _LATER:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; it comes with "
            f"ROADMAP §1 item {_LATER[cfg.family]}")
    raise ValueError(f"unknown family {cfg.family!r}")
