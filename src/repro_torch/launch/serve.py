"""Serving launcher: batched prefill + greedy decode loop for any
``--arch`` of the registry (``repro/launch/serve.py:18``).

    python -m repro_torch.launch.serve --arch qwen3-4b        # on the card
    python -m repro_torch.launch.serve --arch mamba2-2.7b --prompt-len 2048
    python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b
    python -m repro_torch.launch.serve --arch zamba2-7b --prompt-len 2048
    python -m repro_torch.launch.serve --arch zamba2-7b-instruct \
        --batch 8 --prompt-len 3584                        # published
    python -m repro_torch.launch.serve --arch seamless-m4t-medium
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch deepseek-v2-lite-16b-reduced --device cpu      # plain, CPU

Random weights and prompt come from a seeded ``torch.Generator`` drawn on
the target device.  Every kernel call goes through ``kernels.ops``: the
CUDA kernels on the card (``flash_attention`` in prefill,
``decode_attention`` at every decode step, ``moe_gmm``, ``ssd``,
``conv1d_stripe``), the plain versions on the CPU.  MLA models are
served in their materialized form, the reference launcher's default.
An enc-dec model gets ``[B, n_prefix_tokens, frontend_dim]`` random
audio frame embeddings for its encoder; the prompt is its decoder's.
Prints the first generated tokens and one JSON line with the
reference's keys (``prefill_s``, ``decode_tok_per_s``,
``decode_ms_per_token``); the card is synchronised before every clock
read.  The kernels are built before the clock starts; ``prefill_s`` is
the first prefill of the process, as in the reference (whose clock
includes the jit compile).  ``greedy_step`` is one step of the decode
loop, the body the benchmark's LM runner drives step by step.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import get_config
from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.models.api import ModelApi, get_model
from repro_torch.models.runtime import RuntimeOptions
from repro_torch.obs.spans import SpanTree, collect, count


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b-reduced")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default cuda:0; 'cpu' runs the plain versions")
    return ap.parse_args(argv)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def greedy_step(model: ModelApi, params, cache, tok: torch.Tensor,
                cfg: ArchConfig, rt: RuntimeOptions,
                trees: Optional[List[SpanTree]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """One step of the served batch: ``decode_step`` of ``tok`` ``[B]``,
    then the greedy next tokens on the device.  Returns (logits ``[B,
    V_padded]``, next tokens ``[B]`` int32, the advanced cache).  With
    ``trees`` the step runs inside a span sink ``lm.step`` (ident: its
    position) whose tree, with its ``launches`` and ``graph_replays``
    counters (and the model's ``kv_positions``), is appended to
    ``trees``: ``graph_replays`` is the CUDA graphs the step replayed
    (the published Zamba2's step on the card), 0 where it issued every
    op from Python.  That span ends when the card has done the step's
    work: a replayed step's issue takes a few milliseconds, and the
    span's wall is the step's, not its issue's."""
    if trees is None:
        logits, cache = model.decode_step(params, cache, tok, cfg, rt)
        return logits, torch.argmax(logits, -1).to(torch.int32), cache
    n0 = _build.total_launches()
    with collect("lm.step", cache["idx"]) as tree:
        logits, cache = model.decode_step(params, cache, tok, cfg, rt)
        nxt = torch.argmax(logits, -1).to(torch.int32)
        count("launches", _build.total_launches() - n0)
        count("graph_replays", 0)
        _sync(nxt.device)
    trees.append(tree)
    return logits, nxt, cache


def run(args: argparse.Namespace,
        cfg: Optional[ArchConfig] = None) -> dict:
    """Build the model and serve one batch: prefill, then
    ``args.new_tokens`` greedy decode steps.  ``cfg`` replaces
    ``get_config(args.arch)`` (a caller serving a depth-cut config).
    Returns the timings, the generated tokens ``[B, new_tokens + 1]``,
    the prefill logits and the first two decode steps' logits, the peak
    device memory of serving (weights included), and what was served
    (config, params, prompt) so a caller can check it."""
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False   # fp32 means fp32
        _build.LIBRARY.get()        # build the kernels before any clock
    cfg = cfg or get_config(args.arch)
    rt = RuntimeOptions()
    model = get_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.perf_counter()
    params = model.init(gen, cfg, rt, dev)
    toks = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                         generator=gen, device=dev, dtype=torch.int32)
    pe = None
    if cfg.n_prefix_tokens and cfg.frontend_dim:
        pe = torch.randn((args.batch, cfg.n_prefix_tokens, cfg.frontend_dim),
                         generator=gen, device=dev)
    _sync(dev)
    t_init = time.perf_counter() - t0
    if dev.type == "cuda":          # the peak from here counts the weights
        torch.cuda.reset_peak_memory_stats(dev)
    max_len = (args.prompt_len + args.new_tokens + 1
               + (cfg.n_prefix_tokens if cfg.family == "vlm" else 0))

    t0 = time.perf_counter()
    logits, cache = model.prefill(params, toks, cfg, rt, prefix_embeds=pe,
                                  max_len=max_len)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    prefill_logits = logits

    tok = torch.argmax(logits, -1).to(torch.int32)
    out, step_logits = [tok], []
    t0 = time.perf_counter()
    for _ in range(args.new_tokens):
        logits, tok, cache = greedy_step(model, params, cache, tok, cfg, rt)
        if len(step_logits) < 2:
            step_logits.append(logits)
        out.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return {
        "device": dev, "cfg": cfg, "rt": rt, "params": params,
        "tokens": toks, "prefix_embeds": pe,
        "generated": torch.stack(out, dim=1), "cache": cache,
        "prefill_logits": prefill_logits, "step_logits": step_logits,
        "init_s": t_init, "prefill_s": t_prefill,
        "decode_tok_per_s": args.batch * args.new_tokens / t_decode
        if args.new_tokens else float("nan"),
        "decode_ms_per_token": 1000 * t_decode / args.new_tokens
        if args.new_tokens else float("nan"),
        "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30
        if dev.type == "cuda" else None,
    }


def main(argv=None) -> int:
    args = parse_args(argv)
    r = run(args)
    print(f"generated tokens[0,:16]: {r['generated'][0, :16].tolist()}")
    print(json.dumps({
        "arch": args.arch, "batch": args.batch, "device": str(r["device"]),
        "prefill_s": round(r["prefill_s"], 3),
        "decode_tok_per_s": round(r["decode_tok_per_s"], 1),
        "decode_ms_per_token": round(r["decode_ms_per_token"], 2)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
