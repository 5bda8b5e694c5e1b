"""Ensemble stacking: structurally identical members (one architecture
bucket) stacked along a leading member axis, so a bucket runs as one
member-stacked forward pass (the port of
``repro/launch/ensemble_parallel.py::stack_members``; the sharded
``ensemble_serve`` comes with the placement slice)."""
from __future__ import annotations

from typing import Dict, List

import torch


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
