"""Ensemble parallelism: HOLMES' bagging ensemble (Eq. 5) as a
distributed feature (``repro/launch/ensemble_parallel.py``).

Structurally identical members (one architecture bucket) are stacked
along a leading member axis, so a bucket runs as one member-stacked
forward pass.  ``ensemble_serve`` spreads the stacked members over a
list of lanes (``repro_torch.device.Lane``, the reference's "pod" mesh
axis on one card): each lane scores its members locally and the
per-lane totals are summed in lane order on the first lane's device —
the reference's cross-pod psum — then divided by the member count
(Eq. 5).  Given a ``DeviceMesh`` instead (the reference's argument), it
shards the members over "pod" through ``local_map`` and completes Eq. 5
with one all-reduce of the ``[B, C]`` scores over "pod";
``dryrun_ensemble`` runs that step on the production mesh with fake
members (``launch/dryrun.py``)."""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.utils import _pytree as pytree

from repro_torch.device import Lane
from repro_torch.models.ecg_resnext import map_params


def stack_members(member_params: List[Dict]):
    """``[params_0, params_1, ...]`` -> one tree whose leaves gain a
    leading member axis (members must be structurally identical)."""
    first = member_params[0]
    if isinstance(first, dict):
        return {k: stack_members([p[k] for p in member_params])
                for k in first}
    if isinstance(first, (list, tuple)):
        return [stack_members([p[i] for p in member_params])
                for i in range(len(first))]
    return torch.stack(member_params)


def ensemble_serve(member_apply: Callable,
                   lanes: Union[Sequence[Lane], DeviceMesh],
                   n_members: int) -> Callable:
    """Build the ensemble-parallel serving step.

    ``member_apply(params_one_member, batch) -> scores [B, C]``.
    Returns ``step(stacked_params, batch) -> bagged scores [B, C]``
    with the members split evenly over ``lanes`` in order: each lane
    scores its members on its own device, then one sum over the lanes
    (in lane order, on the first lane's device) completes Eq. 5.  With
    a ``DeviceMesh``, over its "pod" dim (``_mesh_serve``)."""
    if isinstance(lanes, DeviceMesh):
        return _mesh_serve(member_apply, lanes, n_members)
    lanes = list(lanes)
    n_lanes = max(len(lanes), 1)
    assert n_members % n_lanes == 0, (n_members, n_lanes)
    per = n_members // n_lanes

    def step(stacked_params, batch):
        total = None
        for j, lane in enumerate(lanes):
            local = map_params(stacked_params, lambda t: t[
                j * per:(j + 1) * per].to(lane.device))
            x = map_params(batch, lambda t: t.to(lane.device))
            scores = torch.stack([member_apply(
                map_params(local, lambda t: t[i]), x) for i in range(per)])
            part = scores.sum(dim=0).to(lanes[0].device)
            total = part if total is None else total + part
        return total / n_members                        # Eq. 5 mean

    return step


def _mesh_serve(member_apply: Callable, mesh: DeviceMesh,
                n_members: int) -> Callable:
    """The step over a mesh: the stacked members sharded over "pod" (and
    replicated over the other dims), the batch replicated; each pod
    scores its members, and one all-reduce over "pod" of the ``[B, C]``
    totals completes Eq. 5.  DTensors give a replicated DTensor; plain
    tensors, whole on every rank, are taken as replicated DTensors and
    give a plain result."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    names = mesh.mesh_dim_names
    n_pods = mesh.size(names.index("pod")) if "pod" in names else 1
    assert n_members % max(n_pods, 1) == 0, (n_members, n_pods)
    rep = (Replicate(),) * mesh.ndim
    member_place = tuple(Shard(0) if a == "pod" else Replicate()
                         for a in names)

    def step(stacked_params, batch):
        p_leaves, p_spec = pytree.tree_flatten(stacked_params)
        b_leaves, b_spec = pytree.tree_flatten(batch)
        n_p = len(p_leaves)

        def local(*args):
            params_local = pytree.tree_unflatten(list(args[:n_p]), p_spec)
            x = pytree.tree_unflatten(list(args[n_p:]), b_spec)
            per = args[0].shape[0]
            scores = torch.stack([member_apply(
                map_params(params_local, lambda t: t[i]), x)
                for i in range(per)])
            total = scores.sum(dim=0)                    # [B, C]
            if n_pods > 1:
                dist.all_reduce(total, group=mesh.get_group("pod"))
            return total / n_members                     # Eq. 5 mean

        plain = not isinstance(p_leaves[0], DTensor)
        leaves = p_leaves + b_leaves
        if plain:
            leaves = [DTensor.from_local(t, mesh, rep, run_check=False)
                      for t in leaves]
        out = local_map(local, out_placements=list(rep),
                        in_placements=(member_place,) * n_p
                        + (rep,) * len(b_leaves), device_mesh=mesh,
                        redistribute_inputs=True)(*leaves)
        return out.to_local() if plain else out

    return step


def dryrun_ensemble(n_members: int = 4, multi_pod: bool = True,
                    d: int = 512, verbose: bool = True) -> dict:
    """Run the ensemble-parallel step on the production mesh with fake
    bf16 member weights (a small MLP member as the stand-in), counted as
    ``launch/dryrun.py`` counts a step: the reference's record."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.dryrun import StepCounter
    from repro_torch.launch.mesh import make_production_mesh, teardown

    owns_group = not dist.is_initialized()
    mesh = make_production_mesh(multi_pod=multi_pod)

    def member_apply(p, batch):
        h = torch.tanh(batch["x"] @ p["w1"])
        return torch.softmax(h @ p["w2"], dim=-1)

    mode = FakeTensorMode()
    with mode:
        stacked = {"w1": torch.empty((n_members, d, d),
                                     dtype=torch.bfloat16),
                   "w2": torch.empty((n_members, d, 2),
                                     dtype=torch.bfloat16)}
        batch = {"x": torch.empty((64, d), dtype=torch.bfloat16)}
    step = ensemble_serve(member_apply, mesh, n_members)
    counter = StepCounter()
    try:
        with mode, implicit_replication(), counter:
            step(stacked, batch)
    finally:
        if owns_group:
            teardown()
    rec = {"mesh": "2x16x16" if multi_pod else "16x16",
           "n_members": n_members,
           "collective_bytes": counter.collective_bytes,
           "flops": float(counter.flops)}
    if verbose:
        print(f"[ensemble-parallel] {rec['mesh']} x {n_members} members: "
              f"OK, collectives {rec['collective_bytes']}")
    return rec


if __name__ == "__main__":
    dryrun_ensemble(multi_pod=True)
