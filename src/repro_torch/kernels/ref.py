"""Plain PyTorch versions of the ported kernels.

They are the port's own reference, playing the part ``repro.kernels.ref``
plays in the JAX package: the CPU path runs them, the tests hold them
against the JAX oracles, and ``chip_smoke.py`` holds each CUDA kernel
against them on the card.  Nothing on the serving path calls them for a
CUDA tensor unless the caller forces ``impl="torch"``.

On the card, a float32 ``F.conv1d`` goes through cuDNN in TF32 unless
``torch.backends.cudnn.allow_tf32`` is False; whoever compares against
this conv on a GPU must turn TF32 off first (``chip_smoke.py`` does).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def conv_padding(L: int, K: int, stride: int,
                 padding: str) -> Tuple[int, int, int]:
    """``(lo, hi, L_out)`` of a 1-D conv.  SAME follows the lax
    convention (``L_out = ceil(L / stride)``, ``lo = pad_total // 2``),
    which is asymmetric for every stride-2 K=7 conv on an even length;
    CAUSAL pads ``K - 1`` on the left."""
    L_out = -(-L // stride)
    if padding == "CAUSAL":
        return K - 1, 0, L_out
    if padding != "SAME":
        raise ValueError(f"padding must be 'SAME' or 'CAUSAL', got "
                         f"{padding!r}")
    pad_total = max((L_out - 1) * stride + K - L, 0)
    lo = pad_total // 2
    return lo, pad_total - lo, L_out


def window_gather(buf: torch.Tensor, patients: torch.Tensor,
                  ends: torch.Tensor, valid: torch.Tensor,
                  L: int) -> torch.Tensor:
    """Ring-buffer window gather (``repro.kernels.ref.window_gather``).

    ``buf`` is ``[N, C, cap]``; row ``i`` of the result holds the last
    ``L`` samples ending (exclusive) at ring position ``ends[i]`` of
    patient ``patients[i]``, oldest first, zeroed where
    ``j < L - valid[i]``.  Returns ``[P, C, L]``."""
    cap = buf.shape[-1]
    j = torch.arange(L, device=buf.device)
    pos = torch.remainder(ends.long()[:, None] - L + j[None, :], cap)
    win = buf[patients.long()[:, None, None],
              torch.arange(buf.shape[1], device=buf.device)[None, :, None],
              pos[:, None, :]]                                # [P, C, L]
    keep = j[None, None, :] >= (L - valid.long())[:, None, None]
    return torch.where(keep, win, torch.zeros((), dtype=buf.dtype,
                                              device=buf.device))


def conv1d_stripe(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor] = None, stride: int = 1,
                  groups: int = 1, padding: str = "SAME") -> torch.Tensor:
    """Grouped 1-D conv, channels last (``repro.kernels.ref
    .conv1d_stripe``).  x: ``[B, L, Cin]``; w: ``[K, Cin // groups,
    Cout]``; b: ``[Cout]``.  Returns ``[B, L_out, Cout]``."""
    K = w.shape[0]
    lo, hi, _ = conv_padding(x.shape[1], K, stride, padding)
    xc = F.pad(x.transpose(1, 2), (lo, hi))                   # [B, Cin, Lp]
    y = F.conv1d(xc, w.permute(2, 1, 0), stride=stride, groups=groups)
    y = y.transpose(1, 2)
    return y if b is None else y + b


def conv1d_stripe_stacked(x: torch.Tensor, w: torch.Tensor,
                          b: Optional[torch.Tensor] = None,
                          stride: int = 1, groups: int = 1,
                          padding: str = "SAME") -> torch.Tensor:
    """Member-stacked conv: the vmapped oracle of ``repro.kernels.ops``
    (``ops.py:84-87``) written as a loop over the member axis.
    x: ``[M, B, L, Cin]``; w: ``[M, K, Cin // groups, Cout]``;
    b: ``[M, Cout]``.  Returns ``[M, B, L_out, Cout]``."""
    y = torch.stack([conv1d_stripe(x[m], w[m], None, stride, groups,
                                   padding) for m in range(x.shape[0])])
    return y if b is None else y + b[:, None, None, :]
