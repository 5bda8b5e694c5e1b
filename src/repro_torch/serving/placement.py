"""Ensemble placement: the port of ``repro/serving/placement.py``
(numpy only; the same plans, loads, signatures and tie-breaks for the
same inputs).

LPT (longest-processing-time-first) greedy placement of ensemble members
onto devices — used by the pipeline's device assignment.  For a
datacenter-scale zoo, the same logic plans which pod hosts which
ensemble member (``plan_pod_ensemble``).

A ``Placement`` is controller-actuated serving state (alongside the
selector): ``serving.pipeline.EnsembleService`` shards its stacked
bucket params across a list of lanes (``repro_torch.device.Lane``: one
a card, or several on one card) per the assignment, and
``control.swap.HotSwapper`` pre-stages ``(selector, placement)`` pairs
and re-derives the plan from measured costs (``re_place``).

Heterogeneous pools: the planner takes a per-device ``speeds`` vector
(work units per second relative to the reference device the costs were
measured on).  LPT then greedily minimizes NORMALIZED FINISH TIMES —
item ``c`` goes to the slot minimizing ``(load_j + c) / speed_j`` — and
``makespan`` / ``imbalance`` are finish-time quantities.  ``speeds``
move work onto fast devices; they never change the math a member
computes, so sharded scores stay bitwise-equal to the unsharded oracle
for every speed vector.  ``signature()`` deliberately hashes the
assignment only: a re-speeded but identically-assigned plan is the
same actuated state, so staging-cache keys don't churn.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np


def finish_imbalance(finish_times: Sequence[float]) -> float:
    """max finish / mean finish over ALL slots (1.0 == perfectly
    balanced, 0.0 == no work anywhere).  Averaging over every slot —
    idle ones included — is deliberate: a plan that strands a device
    (``finish=[x, 0]``) reports 2.0, not 1.0, so the controller's
    ``imbalance > imbalance_high`` RE-PLACE trigger can fire on it."""
    ft = [max(0.0, float(f)) for f in finish_times]
    if not ft or max(ft) <= 0.0:
        return 0.0
    return max(ft) / (sum(ft) / len(ft))


@dataclasses.dataclass
class Placement:
    assignment: List[List[int]]       # device/pod -> member indices
    loads: List[float]                # per device/pod total cost (work)
    # per-slot relative speed (None == homogeneous pool, unit speeds).
    # loads stay in device-independent work units; wall-clock per slot
    # is loads[j] / speeds[j].
    speeds: Optional[List[float]] = None

    def __post_init__(self) -> None:
        if self.speeds is not None:
            if len(self.speeds) != len(self.assignment):
                raise ValueError(
                    f"{len(self.speeds)} speeds != "
                    f"{len(self.assignment)} slots")
            if any(s <= 0 for s in self.speeds):
                raise ValueError(f"speeds must be > 0: {self.speeds}")

    @property
    def n_slots(self) -> int:
        return len(self.assignment)

    @property
    def finish_times(self) -> List[float]:
        """Per-slot normalized finish time (seconds on that device)."""
        if self.speeds is None:
            return [float(l) for l in self.loads]
        return [float(l) / s for l, s in zip(self.loads, self.speeds)]

    @property
    def makespan(self) -> float:
        ft = self.finish_times
        return max(ft) if ft else 0.0

    @property
    def imbalance(self) -> float:
        """max finish time / mean finish time over ALL slots (idle
        slots count: stranding a device is imbalance, not balance)."""
        return finish_imbalance(self.finish_times)

    @property
    def n_members(self) -> int:
        return sum(len(a) for a in self.assignment)

    def signature(self) -> bytes:
        """Stable identity for staging caches: two placements with the
        same device->members map are the same actuated state (speeds
        are advisory planner input, not actuated state)."""
        return repr([sorted(a) for a in self.assignment]).encode()


def placement_signature(placement: Optional[Placement]) -> bytes:
    """Cache-key fragment; None (unsharded single-device service) gets a
    distinct tag so it never collides with a real plan."""
    return b"<single>" if placement is None else placement.signature()


def _checked_speeds(speeds: Optional[Sequence[float]],
                    n_slots: int) -> Optional[List[float]]:
    if speeds is None:
        return None
    sp = [float(s) for s in speeds]
    if len(sp) != n_slots:
        raise ValueError(f"{len(sp)} speeds != {n_slots} slots")
    if any(s <= 0 for s in sp):
        raise ValueError(f"speeds must be > 0: {sp}")
    return sp


def lpt_placement(costs: Sequence[float], n_slots: int,
                  speeds: Optional[Sequence[float]] = None) -> Placement:
    """Greedy LPT on uniform ("related") machines: items in decreasing
    cost order, each to the slot minimizing its completion time
    ``(load_j + c) / speed_j`` (first minimum wins).  When all speeds
    are equal the criterion reduces — bitwise, tie-breaks included —
    to today's homogeneous ``argmin(loads)``, so unit-speed plans are
    identical to the speed-blind planner's."""
    k = max(1, n_slots)
    sp = _checked_speeds(speeds, k)
    order = np.argsort(-np.asarray(costs, np.float64), kind="stable")
    assignment: List[List[int]] = [[] for _ in range(k)]
    loads = [0.0] * k
    uniform = sp is None or len(set(sp)) == 1
    sp_arr = None if uniform else np.asarray(sp, np.float64)
    for i in order:
        c = float(costs[i])
        if uniform:
            j = int(np.argmin(loads))
        else:
            j = int(np.argmin((np.asarray(loads) + c) / sp_arr))
        assignment[j].append(int(i))
        loads[j] += c
    return Placement(assignment=assignment, loads=loads, speeds=sp)


def grouped_lpt_placement(groups: Sequence[Sequence[int]],
                          group_costs: Sequence[float],
                          n_slots: int,
                          speeds: Optional[Sequence[float]] = None
                          ) -> Placement:
    """LPT over atomic GROUPS of members (architecture buckets): each
    group lands on one slot whole, so a stacked bucket dispatch is never
    split across devices.  ``assignment`` is expanded back to member
    indices; ``loads`` carry the group costs."""
    if len(groups) != len(group_costs):
        raise ValueError(f"{len(groups)} groups != "
                         f"{len(group_costs)} costs")
    pl = lpt_placement(group_costs, n_slots, speeds=speeds)
    assignment = [[m for g in slot for m in groups[g]]
                  for slot in pl.assignment]
    return Placement(assignment=assignment, loads=pl.loads,
                     speeds=pl.speeds)


def plan_pod_ensemble(member_costs: Dict[str, float], n_pods: int
                      ) -> Dict[str, int]:
    """Map ensemble member names -> pod index (bagging combine then needs
    one cross-pod all-reduce of the [batch, n_classes] score — Eq. 5 as a
    collective)."""
    names = list(member_costs)
    pl = lpt_placement([member_costs[n] for n in names], n_pods)
    out = {}
    for pod, idxs in enumerate(pl.assignment):
        for i in idxs:
            out[names[i]] = pod
    return out
