"""Checkpointing: a params tree <-> npz with path-keyed arrays + JSON
metadata (the port of ``repro/training/checkpoint.py``).

The keys are the reference's: dict keys and list indices joined with
``/`` (``blocks/0/expand/w``), so a file either package saves restores
in the other, and the committed ``results/zoo_cache/*.npz`` members load
here unchanged.  The save is atomic (tmp file + rename): a killed run
never leaves a corrupt checkpoint behind.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch


def _paths(tree, prefix: Tuple[str, ...] = ()
           ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(flat key, leaf) in the reference's order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _rebuild(tree, leaf_of, prefix: Tuple[str, ...] = ()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaf_of, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, leaf_of, prefix + (str(i),))
                for i, v in enumerate(tree)]
    return leaf_of("/".join(prefix), tree)


def _unlink_if_there(path: str) -> None:
    if os.path.exists(path):
        os.unlink(path)


def save(path: str, tree, metadata: Optional[Dict[str, Any]] = None
         ) -> None:
    """Write ``tree``'s leaves (tensors on any device) to ``path`` and
    ``metadata`` plus ``n_arrays`` to ``path + ".json"``."""
    folder = os.path.dirname(os.path.abspath(path))
    os.makedirs(folder, exist_ok=True)
    flat = {k: torch.as_tensor(v).detach().cpu().numpy()
            for k, v in _paths(tree)}
    fd, tmp = tempfile.mkstemp(dir=folder, suffix=".tmp")
    with contextlib.ExitStack() as cleanup:
        # runs on the way out: a no-op once the rename has happened,
        # removes the partial file if anything below raised
        cleanup.callback(_unlink_if_there, tmp)
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    meta = dict(metadata or {})
    meta["n_arrays"] = len(flat)
    with open(path + ".json", "w") as f:
        json.dump(meta, f, indent=2, default=str)


def restore(path: str, like) -> Any:
    """Restore into the structure of ``like`` (a template tree): each
    leaf takes its template's dtype and device.  A key the file lacks
    raises ``KeyError``; a shape that differs raises ``ValueError``."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}

    def leaf_of(key: str, leaf: torch.Tensor) -> torch.Tensor:
        if key not in flat:
            raise KeyError(f"checkpoint missing {key!r}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                             f"template {tuple(leaf.shape)}")
        return torch.from_numpy(arr).to(device=leaf.device,
                                         dtype=leaf.dtype)
    return _rebuild(like, leaf_of)


def load_metadata(path: str) -> Dict[str, Any]:
    with open(path + ".json") as f:
        return json.load(f)
