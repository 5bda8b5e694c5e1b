"""Where the port runs: the card unless the caller asks for the CPU."""
from __future__ import annotations

from typing import Union

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

