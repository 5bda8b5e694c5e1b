"""AdamW and learning-rate schedules (the port of
``repro/training/optimizer.py``).

Params, grads and moments are the port's nested-dict trees (dicts and
lists of tensors, the layout ``models/convert.py::params_from_numpy``
gives).  ``update`` is functional, as the reference's: it returns new
params and a new state and leaves its arguments as they were.  It runs
under ``torch.no_grad()``, in the reference's order: clip by the global
norm, then the moments, then the bias correction at the new step, then
the decoupled weight decay.  ``step`` is an int32 tensor on the params'
device, so a schedule reads it without a host sync.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from repro_torch.models.ecg_resnext import leaves, map_params


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: object
    nu: object


def _zip_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure (the reference's
    multi-tree ``jax.tree.map``)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _zip_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return [_zip_map(fn, *parts) for parts in zip(*trees)]
    return fn(*trees)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor]    # schedule: step -> lr
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params) -> AdamWState:
        first = next(leaves(params))
        zeros = lambda p: map_params(p, lambda a: torch.zeros(
            a.shape, dtype=torch.float32, device=a.device))
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=first.device),
            mu=zeros(params), nu=zeros(params))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        step = state.step + 1
        if self.grad_clip:
            gnorm = global_norm(grads)
            scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
            grads = map_params(grads, lambda g: g * scale)

        b1, b2 = self.b1, self.b2
        mu = _zip_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                      state.mu, grads)
        nu = _zip_map(lambda n, g: b2 * n + (1 - b2) * g.float().square(),
                      state.nu, grads)
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()
        lr = self.lr(step)

        def upd(p, m, n):
            u = (m / bc1) / (torch.sqrt(n / bc2) + self.eps)
            u = u + self.weight_decay * p.float()
            return (p.float() - lr * u).to(p.dtype)

        new_params = _zip_map(upd, params, mu, nu)
        return new_params, AdamWState(step=step, mu=mu, nu=nu)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, summed leaf by leaf in
    the reference's leaf order (dict keys sorted)."""
    return torch.sqrt(sum(torch.sum(torch.square(a.float()))
                          for a in leaves(tree)))


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> Callable:
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return lr


def constant_schedule(lr_value: float) -> Callable:
    return lambda step: torch.full((), lr_value, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)
