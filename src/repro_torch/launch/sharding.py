"""The partition rules (``repro/launch/sharding.py``): param, cache and
input specs for the production mesh, and their DTensor placements.

Megatron-style tensor parallelism on the "model" axis (column-sharded
QKV/up/gate, row-sharded O/down), vocab-sharded embeddings, expert
f-sharding for MoE, head-sharded SSD; batch shards over ("pod","data").

``param_spec`` and ``cache_spec`` return, leaf by leaf, the tuple the
reference's ``PartitionSpec`` holds: one entry a tensor dim, a mesh
axis name, a tuple of them, or None.  Every rule is divisibility-guarded
on the dim it shards, as the reference's, so a dim the model axis does
not divide is replicated; the guard looks at the flat dim, so
smollm-360m's 960-wide ``wq`` (15 heads of 64) IS sharded 16 ways, and
the head split that follows is uneven (the dry run reshards it,
``launch/dryrun.py``).

A spec becomes DTensor placements one mesh dim at a time
(``placements``): a mesh axis named in a tensor dim's entry shards that
dim; a dim named with ("pod", "data") is ``Shard(d)`` on both mesh
dims, in mesh order, which splits it major to minor as JAX does.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ArchConfig

# leaf-w parents whose LAST dim is column-sharded over "model"
_COL = {"wq", "wk", "wv", "gate", "up"}
# leaf-w parents whose -2 dim is row-sharded over "model"
_ROW = {"wo", "down"}
# replicated small params
_REPL = {"router", "w_dkv", "ckv_norm", "B_proj", "C_proj", "conv_B",
         "conv_C", "conv_bB", "conv_bC", "frontend_proj"}

Spec = Tuple


def _sizes(mesh: DeviceMesh) -> Dict[str, int]:
    return {a: mesh.size(i) for i, a in enumerate(mesh.mesh_dim_names)}


def _mk(ndim: int, assignments) -> Spec:
    """assignments: {dim_index (may be negative): axis-or-tuple}"""
    spec = [None] * ndim
    for d, ax in assignments.items():
        spec[d % ndim] = ax
    return tuple(spec)


def _div(shape, dim: int, size: int) -> bool:
    return size > 0 and shape[dim % len(shape)] % size == 0


def param_spec(path_keys: Tuple[str, ...], shape: Tuple[int, ...],
               cfg: ArchConfig, model_size: int) -> Spec:
    if not shape:
        return ()
    keys = path_keys
    leaf = keys[-1]
    parent = keys[-2] if len(keys) >= 2 else ""
    nd = len(shape)

    def col(dim=-1):
        return _mk(nd, {dim: "model"}) if _div(shape, dim, model_size) \
            else ()

    if leaf in _REPL or parent in _REPL:
        return ()
    if leaf == "table":                       # [V, d] (possibly stacked)
        return col(-2)
    if leaf == "head":                        # [d, V]
        return col(-1)
    if leaf in ("w", "b") and parent in _COL:
        return col(-1)
    if leaf == "w" and parent in _ROW:
        return col(-2)
    if leaf == "b" and parent in _ROW:
        return ()
    if leaf == "wq":                          # MLA direct q [d, H*qk]
        return col(-1)
    if leaf == "wo":                          # MLA o proj [H*v, d]
        return col(-2)
    if leaf in ("w_uk", "w_uv"):              # [lora, H, dim]
        return _mk(nd, {-2: "model"}) if _div(shape, -2, model_size) \
            else ()
    if leaf in ("w_gate", "w_up"):            # [E, d, f]
        return col(-1)
    if leaf == "w_down":                      # [E, f, d]
        return col(-2)
    if leaf in ("z_proj", "x_proj", "dt_proj", "conv_x", "conv_bx",
                "A_log", "D", "dt_bias"):
        return col(-1)
    if leaf == "out_proj":                    # [di, d]
        return col(-2)
    if leaf == "scale" and parent == "norm" and "mixer" in keys:
        return col(-1)                        # mamba gated-norm over di
    return ()


def _batch_axes_spec(mesh: DeviceMesh, batch: int, dp_only: bool = False):
    names = (("pod", "data", "model") if dp_only else ("pod", "data"))
    sizes = _sizes(mesh)
    axes = tuple(a for a in mesh.mesh_dim_names if a in names)
    total = 1
    for a in axes:
        total *= sizes[a]
    if batch % total == 0:
        return axes if len(axes) > 1 else axes[0]
    return None                               # e.g. long_500k batch=1


def cache_spec(path_keys: Tuple[str, ...], shape: Tuple[int, ...],
               mesh: DeviceMesh, batch: int, dp_only: bool = False) -> Spec:
    leaf = path_keys[-1]
    nd = len(shape)
    b_ax = _batch_axes_spec(mesh, batch, dp_only)
    model = _sizes(mesh)["model"]

    def mk(assign):
        ok = {}
        for d, ax in assign.items():
            if ax is None:
                continue
            if ax == "model" and (dp_only or not _div(shape, d, model)):
                continue           # dp_only: model axis carries batch
            ok[d] = ax
        return _mk(nd, ok)

    if leaf in ("k", "v"):                    # [.., B, M, kvH, hd]
        return mk({-4: b_ax, -2: "model"})
    if leaf in ("ckv", "krope"):              # [.., B, M, r]
        return mk({-3: b_ax})
    if leaf == "conv_x":                      # [.., B, K-1, di]
        return mk({-3: b_ax, -1: "model"})
    if leaf in ("conv_B", "conv_C"):
        return mk({-3: b_ax})
    if leaf == "ssm":                         # [.., B, H, P, N]
        return mk({-4: b_ax, -3: "model"})
    if leaf == "enc_out":                     # [B, T, d]
        return mk({-3: b_ax})
    return ()                                 # pos, idx


# ------------------------------------------------------------- placements
def placements(spec: Spec, mesh: DeviceMesh) -> Tuple:
    """A spec -> one placement a mesh dim: ``Shard(d)`` where the
    tensor dim ``d`` names that mesh axis, else ``Replicate()``."""
    out = []
    for axis in mesh.mesh_dim_names:
        dims = [d for d, ax in enumerate(spec)
                if ax == axis or (isinstance(ax, tuple) and axis in ax)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def replicated(mesh: DeviceMesh) -> Tuple:
    return (Replicate(),) * mesh.ndim


def _map_with_path(fn, tree, path=()):
    """``fn(path_keys, leaf)`` over the tensor leaves of a tree of dicts
    and lists (list indices as strings, as the reference's path keys);
    other leaves (a cache's ``idx``) are kept as they are."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    if isinstance(tree, torch.Tensor):
        return fn(path, tree)
    return tree


def partition_params(params, cfg: ArchConfig, mesh: DeviceMesh,
                     model_size: Optional[int] = None):
    """A params tree -> the same tree of placements.  model_size=1 =>
    pure data parallelism (params fully replicated)."""
    model_size = model_size if model_size is not None \
        else _sizes(mesh)["model"]
    return _map_with_path(lambda path, t: placements(
        param_spec(path, tuple(t.shape), cfg, model_size), mesh), params)


def partition_cache(cache, mesh: DeviceMesh, batch: int,
                    dp_only: bool = False):
    return _map_with_path(lambda path, t: placements(
        cache_spec(path, tuple(t.shape), mesh, batch, dp_only), mesh),
        cache)


def batch_input_sharding(mesh: DeviceMesh, batch: int, ndim: int,
                         dp_only: bool = False) -> Tuple:
    b_ax = _batch_axes_spec(mesh, batch, dp_only)
    spec = [None] * ndim
    if b_ax is not None and ndim:
        spec[0] = b_ax
    return placements(tuple(spec), mesh)


def partition_batch(batch, mesh: DeviceMesh, dp_only: bool = False):
    return _map_with_path(lambda path, t: batch_input_sharding(
        mesh, t.shape[0] if t.ndim else 1, t.ndim, dp_only), batch)


# ------------------------------------------------------------- DTensors
def local_shard(t: torch.Tensor, place: Tuple,
                mesh: DeviceMesh) -> torch.Tensor:
    """This rank's chunk of ``t`` under ``place`` (a view; no
    communication: every rank holds ``t`` whole)."""
    coord = mesh.get_coordinate()
    for i, p in enumerate(place):
        if isinstance(p, Shard):
            t = t.chunk(mesh.size(i), p.dim)[coord[i]]
    return t


def shard(t: torch.Tensor, place: Tuple, mesh: DeviceMesh) -> DTensor:
    """``t`` (whole on every rank) as a DTensor laid out by ``place``."""
    return DTensor.from_local(local_shard(t, place, mesh), mesh, place,
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def shard_tree(tree, place_tree, mesh: DeviceMesh):
    """``shard`` leaf by leaf over a tree and its tree of placements."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, place_tree[k], mesh)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_tree(v, p, mesh)
                          for v, p in zip(tree, place_tree))
    if isinstance(tree, torch.Tensor):
        return shard(tree, place_tree, mesh)
    return tree
