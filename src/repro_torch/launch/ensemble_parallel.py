"""Ensemble parallelism: HOLMES' bagging ensemble (Eq. 5) over lanes.
The port of ``repro/launch/ensemble_parallel.py``'s ``stack_members``
and ``ensemble_serve``; ``dryrun_ensemble`` waits for the mesh tools.

Structurally identical members (one architecture bucket) are stacked
along a leading member axis, so a bucket runs as one member-stacked
forward pass.  ``ensemble_serve`` spreads the stacked members over a
list of lanes (``repro_torch.device.Lane``, the reference's "pod" mesh
axis): each lane scores its members locally and the per-lane totals
are summed in lane order on the first lane's device — the reference's
cross-pod psum — then divided by the member count (Eq. 5)."""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

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


def ensemble_serve(member_apply: Callable, lanes: Sequence[Lane],
                   n_members: int) -> Callable:
    """Build the ensemble-parallel serving step.

    ``member_apply(params_one_member, batch) -> scores [B, C]``.
    Returns ``step(stacked_params, batch) -> bagged scores [B, C]``
    with the members split evenly over ``lanes`` in order: each lane
    scores its members on its own device, then one sum over the lanes
    (in lane order, on the first lane's device) completes Eq. 5."""
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
