"""Training launcher (``repro/launch/train.py:19``) for any ``--arch`` of
the registry.

    python -m repro_torch.launch.train --arch smollm-360m --steps 25 \\
        --batch 8 --seq 128                                   # on the card
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch smollm-360m-reduced --steps 50 --device cpu    # plain, CPU

The reference's flags, plus ``--device`` (default ``cuda:0``; ``cpu``
runs on the CPU).  Every train step runs the plain versions under
autograd with TF32 off (``training.train_loop``).  Prints a loss line
every 10 steps and one JSON line with the reference's keys
(``first_loss``, ``last_loss``, ``wall_s``, ``steps_per_s``); the card
is synchronised by each step's loss read.  ``--dry-run`` runs the
production-mesh dry run of the full-size architecture instead
(``python -m repro_torch.launch.dryrun --arch <arch> --shape train_4k
--both-meshes``, in a process of its own, as the reference does): no
card is needed.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.device import resolve_device
from repro_torch.models.runtime import RuntimeOptions
from repro_torch.training import checkpoint
from repro_torch.training.data import audio_frames, lm_batches
from repro_torch.training.train_loop import train_lm


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m-reduced")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--dry-run", action="store_true",
                    help="run the production-mesh dry run instead")
    ap.add_argument("--device", default=None,
                    help="default cuda:0; 'cpu' trains on the CPU")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """Train ``args.steps`` steps from a seeded init.  Returns the
    per-step losses, the wall time, the trained params and, on the card,
    the peak device memory of training (weights, moments and
    activations)."""
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    cfg = get_config(args.arch)
    rt = RuntimeOptions()
    base = lm_batches(cfg.vocab_size, args.batch, args.seq,
                      seed=args.seed)

    def batches():
        for b in base:
            if cfg.n_prefix_tokens and cfg.frontend_dim:
                b = dict(b)
                b["prefix_embeds"] = audio_frames(
                    args.batch, cfg.n_prefix_tokens, cfg.frontend_dim,
                    seed=args.seed)
                if cfg.family == "vlm":
                    b["labels"] = np.concatenate(
                        [np.full((args.batch, cfg.n_prefix_tokens), -1,
                                 np.int32), b["labels"]], axis=1)
            yield b

    t0 = time.time()
    params, losses = train_lm(
        cfg, rt, batches(), steps=args.steps, lr=args.lr, seed=args.seed,
        callback=lambda i, l: print(f"step {i:5d} loss {l:.4f}",
                                    flush=True), device=dev)
    dt = time.time() - t0
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    return {"losses": losses, "wall_s": dt, "params": params,
            "peak_bytes": peak}


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.dry_run:
        return subprocess.call(
            [sys.executable, "-m", "repro_torch.launch.dryrun",
             "--arch", args.arch.replace("-reduced", ""),
             "--shape", "train_4k", "--both-meshes"])
    r = run(args)
    losses, dt, params = r["losses"], r["wall_s"], r["params"]
    print(json.dumps({"arch": args.arch, "steps": args.steps,
                      "first_loss": losses[0], "last_loss": losses[-1],
                      "wall_s": round(dt, 1),
                      "steps_per_s": round(args.steps / dt, 3)}))
    if args.checkpoint:
        checkpoint.save(args.checkpoint, params,
                        {"arch": args.arch, "steps": args.steps})
        print(f"checkpoint -> {args.checkpoint}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
