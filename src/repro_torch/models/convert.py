"""Weights carried across from the JAX package.

The port keeps the reference's params layout, so conversion is a change
of array type.  ``params_from_numpy`` serves every tree the port has:
the ECG ResNeXt's (dicts and lists, conv weights ``[K, Cin // groups,
Cout]``), the LM's (nested dicts with a list of segments whose leaves
are stacked ``[L, ...]`` over the segment's layers: attention, SwiGLU,
MoE ``[L, E, d, f]`` experts and router, and the mamba mixer, whose
``A_log``, ``D`` and ``dt_bias`` are float32 in every dtype), the
hybrid's (``init_hybrid``: mamba blocks stacked ``[ns, k, ...]`` and
``[tail, ...]``, one unstacked shared block) and the enc-dec's
(``init_encdec``: ``enc`` and ``dec`` stacked over their layers, the
decoder's cross-attention weights among them).  Its input is a
JAX params tree turned to numpy (``jax.tree.map(np.asarray, params)``),
or, for the ECG zoo, a committed ``results/zoo_cache/*.npz`` whose flat
keys look like ``blocks/0/expand/w``.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.models.ecg_resnext import map_params


def params_from_numpy(tree, device: Optional[torch.device] = None):
    """A params tree of numpy arrays (the layout of the JAX package's
    ``init_ecg`` or ``init_lm``) -> the same tree of float32 tensors on
    ``device``."""
    return map_params(tree, lambda a: torch.from_numpy(
        np.array(a, np.float32)).to(device))


def unflatten(flat: Dict[str, np.ndarray]):
    """Path-keyed arrays -> nested tree; all-digit path components
    index lists (``blocks/0/expand/w``)."""
    root: Dict = {}
    for key, arr in flat.items():
        node = root
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = arr

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            return [out[str(i)] for i in range(len(out))]
        return out
    return listify(root)


def load_zoo_npz(path: str, device: Optional[torch.device] = None):
    """A committed zoo-cache member (``results/zoo_cache/*.npz``) ->
    the port's params on ``device``."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return params_from_numpy(unflatten(flat), device)
