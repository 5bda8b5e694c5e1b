"""Training loops: the LM train step (dense, VLM, MoE with GQA or MLA,
pure SSM) and the ECG-zoo trainer that populates the paper's model zoo
(the port of ``repro/training/train_loop.py``).

Gradients come from autograd through the plain versions of
``kernels/ref.py`` (``impl="torch"``): the reference trains through
``impl="xla"``, never through Pallas, and no kernel of either package
has a backward.  A CUDA kernel wrapper handed an input that requires
grad raises (``kernels._build.no_backward``), so a caller who forces
``impl="cuda"`` into a train step gets that error, not weights without
gradients.  Prediction and the serve makers keep the caller's ``impl``
and run under ``torch.no_grad()``: on the card they launch the kernels.

Each train step and each prediction pass on the card runs with cuDNN's
and cuBLAS's TF32 off, scoped to it (``Fp32Step``): the plain conv and
the matmuls (the ECG head among them) are fp32 whatever the process
has set, as the reference's are.  Entry points train on ``cuda:0`` unless
the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.ecg_zoo import EcgModelSpec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.api import get_model
from repro_torch.models.ecg_resnext import ecg_apply, init_ecg, map_params
from repro_torch.models.layers import softmax_xent
from repro_torch.models.runtime import RuntimeOptions
from repro_torch.training.optimizer import AdamW, constant_schedule


class Fp32Step:
    """Context of one train step or prediction pass on ``device``: on a
    CUDA device, cuDNN enabled with TF32 off and cuBLAS matmul TF32 off,
    both restored on exit; on the CPU, nothing."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def __enter__(self):
        if self.cuda:
            cudnn = torch.backends.cudnn
            self._cudnn = cudnn.flags(
                enabled=True, benchmark=cudnn.benchmark,
                deterministic=cudnn.deterministic, allow_tf32=False)
            self._cudnn.__enter__()
            self._matmul = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        if self.cuda:
            torch.backends.cuda.matmul.allow_tf32 = self._matmul
            self._cudnn.__exit__(*exc)
        return False


def value_and_grad(loss_fn, params):
    """``jax.value_and_grad`` for a params tree: the loss and a tree of
    grads of the structure of ``params`` (zeros for a leaf the loss does
    not reach, as JAX gives)."""
    params = map_params(params, lambda t: t.detach().requires_grad_())
    loss = loss_fn(params)
    loss.backward()
    return loss.detach(), map_params(
        params, lambda t: torch.zeros_like(t) if t.grad is None else t.grad)


# ------------------------------------------------------------- LM steps
def lm_loss(params, batch: Dict, cfg: ArchConfig, rt: RuntimeOptions,
            model=None):
    model = model or get_model(cfg)
    logits, aux = model.forward(params, batch["tokens"], cfg, rt,
                                prefix_embeds=batch.get("prefix_embeds"))
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:      # VLM/audio prefix positions
        logits = logits[:, logits.shape[1] - labels.shape[1]:]
    loss = softmax_xent(logits, labels)
    if cfg.moe:
        loss = loss + cfg.moe.router_aux_coef * aux
    return loss


def make_train_step(cfg: ArchConfig, rt: RuntimeOptions, opt: AdamW
                    ) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    loss)`` on the params' device.  It runs the plain versions
    (``impl="torch"``) unless the caller forced ``impl="cuda"``, which
    the kernel guard refuses."""
    model = get_model(cfg)
    rt = dataclasses.replace(rt, impl=rt.impl or "torch")

    def train_step(params, opt_state, batch):
        with Fp32Step(opt_state.step.device):
            loss, grads = value_and_grad(
                lambda p: lm_loss(p, batch, cfg, rt, model), params)
            params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss

    return train_step


def make_serve_prefill(cfg: ArchConfig, rt: RuntimeOptions) -> Callable:
    model = get_model(cfg)

    @torch.no_grad()
    def serve_prefill(params, batch):
        logits, cache = model.prefill(
            params, batch["tokens"], cfg, rt,
            prefix_embeds=batch.get("prefix_embeds"),
            max_len=batch["tokens"].shape[1] + 1
            + (cfg.n_prefix_tokens if cfg.family == "vlm" else 0))
        return logits

    return serve_prefill


def make_serve_step(cfg: ArchConfig, rt: RuntimeOptions) -> Callable:
    """ONE new token against an existing KV cache (decode shapes)."""
    model = get_model(cfg)

    @torch.no_grad()
    def serve_step(params, cache, token):
        return model.decode_step(params, cache, token, cfg, rt)

    return serve_step


def train_lm(cfg: ArchConfig, rt: RuntimeOptions, batches: Iterator,
             steps: int, lr: float = 3e-4, seed: int = 0,
             log_every: int = 10, callback: Optional[Callable] = None,
             device: DeviceLike = None):
    """Init from ``seed`` on ``device`` (default ``cuda:0``) and take
    ``steps`` AdamW steps over ``batches`` (dicts of numpy arrays).
    Returns (params, detached, and the per-step losses)."""
    dev = resolve_device(device)
    opt = AdamW(lr=constant_schedule(lr))
    model = get_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed), cfg,
                        rt, dev)
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, rt, opt)
    losses = []
    for i in range(steps):
        batch = {k: torch.as_tensor(v).to(dev)
                 for k, v in next(batches).items()}
        params, opt_state, loss = step_fn(params, opt_state, batch)
        losses.append(float(loss))
        if callback and (i % log_every == 0 or i == steps - 1):
            callback(i, losses[-1])
    return params, losses


# ------------------------------------------------------------- ECG zoo
def ecg_loss(params, x, y, spec: EcgModelSpec):
    """x: ``[B, L, 1]``, y: ``[B]`` -> the mean cross-entropy, through
    the plain versions (the training loss)."""
    logits = ecg_apply(params, x, spec, impl="torch")
    return softmax_xent(logits, y)


def train_ecg_model(spec: EcgModelSpec, x: np.ndarray, y: np.ndarray,
                    steps: int = 150, batch: int = 32, lr: float = 1e-3,
                    seed: int = 0, device: DeviceLike = None
                    ) -> Tuple[Dict, list]:
    """x: ``[n, L]`` single-lead clips; y: ``[n]`` binary labels.
    Minibatches are the reference's draws (``default_rng(seed)``, then
    ``integers(0, n, min(batch, n))`` a step).  Returns (params on
    ``device``, detached, and the per-step losses)."""
    dev = resolve_device(device)
    params = init_ecg(spec, torch.Generator().manual_seed(seed), dev)
    opt = AdamW(lr=constant_schedule(lr), weight_decay=1e-4)
    opt_state = opt.init(params)

    rng = np.random.default_rng(seed)
    losses = []
    n = len(x)
    for i in range(steps):
        idx = rng.integers(0, n, size=min(batch, n))
        xb = torch.from_numpy(np.ascontiguousarray(x[idx])).to(dev)
        yb = torch.from_numpy(np.asarray(y[idx])).to(dev)
        with Fp32Step(dev):
            loss, grads = value_and_grad(
                lambda p: ecg_loss(p, xb[..., None], yb, spec), params)
            params, opt_state = opt.update(grads, opt_state, params)
        losses.append(float(loss))
    return params, losses


@torch.no_grad()
def ecg_predict_proba(params, x: np.ndarray, spec: EcgModelSpec,
                      batch: int = 256) -> np.ndarray:
    """P(stable) for single-lead clips x: ``[n, L]``, on the params'
    device (the CUDA ``conv1d_stripe`` on the card, the head's matmul in
    fp32), ``batch`` clips a pass."""
    dev = params["head"]["w"].device
    out = []
    for i in range(0, len(x), batch):
        xb = torch.from_numpy(np.ascontiguousarray(x[i:i + batch])).to(dev)
        with Fp32Step(dev):
            logits = ecg_apply(params, xb[..., None], spec)
        out.append(torch.softmax(logits, dim=-1)[:, 1].cpu().numpy())
    return np.concatenate(out) if out else np.zeros((0,))
