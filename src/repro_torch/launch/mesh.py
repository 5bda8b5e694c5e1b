"""Meshes (``repro/launch/mesh.py``): the production meshes over a fake
process group, and a real one-rank host mesh.

Torch has no forced host devices, so the production mesh is a
``DeviceMesh`` over the ``fake`` backend: one process plays rank 0 of
256 (or 512), every collective returns at once, and the dry run
(``launch/dryrun.py``) runs the rank's share of a step on fake tensors.
The host mesh is a real ``(1, 1)`` group in this process (NCCL on the
card, gloo on the CPU) over an in-process ``HashStore``: no network.

A process holds one default group.  Each mesh function makes it when none
exists and refuses one of another size; ``teardown`` destroys the
group and every subgroup the mesh made, so the next one can start
again.  Nothing here runs at import.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import DeviceLike, resolve_device


def _default_group(backend: str, world_size: int, store) -> None:
    """Make the default group, or check the one that exists."""
    if dist.is_initialized():
        have = (dist.get_backend(), dist.get_world_size())
        if have != (backend, world_size):
            raise RuntimeError(
                f"a default process group ({have[0]}, {have[1]} ranks) "
                f"exists; this mesh needs ({backend}, {world_size}): call "
                "launch.mesh.teardown() first")
        return
    dist.init_process_group(backend, store=store, rank=0,
                            world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """Single pod: (16, 16) ("data", "model") = 256 ranks.
    Multi-pod:   (2, 16, 16) ("pod", "data", "model") = 512 ranks.
    Over the fake backend, this process as rank 0."""
    # registers the "fake" backend and its store
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    _default_group("fake", math.prod(shape), FakeStore())
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def make_host_mesh(device: DeviceLike = None) -> DeviceMesh:
    """A real one-rank ``(1, 1)`` ("data", "model") mesh: NCCL on
    ``cuda:0`` unless the caller names another device, gloo on
    ``"cpu"``.  Raises without CUDA unless asked for the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    _default_group("nccl" if dev.type == "cuda" else "gloo", 1,
                   dist.HashStore())
    return init_device_mesh(dev.type, (1, 1),
                            mesh_dim_names=("data", "model"))


def teardown() -> None:
    """Destroy the default group and every subgroup (a no-op without
    one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def batch_axes(mesh: DeviceMesh) -> tuple:
    """Axes that shard the global batch."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def model_axis_size(mesh: DeviceMesh) -> int:
    return mesh.size(mesh.mesh_dim_names.index("model"))


def data_axis_size(mesh: DeviceMesh) -> int:
    out = 1
    for a in batch_axes(mesh):
        out *= mesh.size(mesh.mesh_dim_names.index(a))
    return out
