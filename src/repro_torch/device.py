"""Where the port runs: the card unless the caller asks for the CPU.

A placement (``serving.placement``) spreads the zoo over LANES: a
``Lane`` is the port's counterpart of one ``jax.Device`` in a
placement, a value with identity (its index in the lane list) bound to
the ``torch.device`` its tensors live on.  The reference tells devices
apart by identity (bucket shards, slot-engine groups, the fault guard,
quarantine); a list of repeated ``torch.device("cuda:0")`` would
collapse all four, so N lanes on one card behave as N distinct devices
there while sharing the card (and its default stream).  On a machine
with several cards ``device_lanes()`` gives one lane a card, and the
same code spreads the zoo over them.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda:0``.  A CUDA device without CUDA raises:
    the port never carries on quietly on the CPU.  The CPU is used
    only when the caller names it (``device="cpu"``, as the tests do)."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested (the default) but CUDA is not "
            "available; pass device='cpu' to run the plain versions")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class Lane:
    """One placement slot's device: equal only to a lane with the same
    index and the same ``torch.device`` (never to a bare
    ``torch.device``).  Tensors of the lane go to ``lane.device``."""
    index: int
    device: torch.device

    def __str__(self) -> str:
        return f"lane {self.index} ({self.device})"


def lanes(n: int, device: DeviceLike = None) -> List[Lane]:
    """``n`` lanes on one device (default ``cuda:0``, resolved as
    ``resolve_device`` resolves it: no CUDA, no CUDA lane)."""
    if n < 1:
        raise ValueError(f"need at least one lane, got {n}")
    dev = resolve_device(device)
    return [Lane(i, dev) for i in range(n)]


def device_lanes() -> List[Lane]:
    """One lane per CUDA card of the process (the counterpart of
    ``jax.devices()``): the default lane list of ``EnsembleService``,
    ``HotSwapper`` and ``FaultPlane.arm``.  Raises without a card."""
    n = torch.cuda.device_count()
    if not n:
        raise RuntimeError(
            "no CUDA device to place lanes on; pass lanes(n, 'cpu') "
            "for a CPU placement or drill")
    return [Lane(i, torch.device("cuda", i)) for i in range(n)]


def as_lanes(devices: Optional[Sequence]) -> List[Lane]:
    """A placement's lane list: ``None`` is ``device_lanes()``; every
    entry must be a distinct ``Lane`` (bare ``torch.device`` values do
    not tell two slots on one card apart, so they are refused)."""
    if devices is None:
        return device_lanes()
    out = list(devices)
    bad = [d for d in out if not isinstance(d, Lane)]
    if bad:
        raise TypeError(f"placement devices must be Lanes (see "
                        f"repro_torch.device.lanes), got {bad[:3]}")
    if len(set(out)) != len(out):
        raise ValueError(f"lanes must be distinct: {out}")
    return out
