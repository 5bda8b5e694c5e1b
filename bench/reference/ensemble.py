"""Eq. 5 of HOLMES for a batch of windows: every zoo member's P(stable)
on its lead, the vitals forest and the labs regression, averaged in
float64 in that order (the members first, in zoo order)."""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from bench.reference.resnext import forward

BLOCK = 256     # windows the reference takes at once: bounds its memory


def member_probs(members: Sequence[Dict], params: Sequence[Dict],
                 ecg: torch.Tensor, tf32: bool = False) -> np.ndarray:
    """``[N, 3, L]`` windows -> ``[N, M]`` float32 member probabilities,
    each member over its lead's last ``input_len`` samples, in blocks of
    ``BLOCK`` windows.  TF32 off in cuDNN and cuBLAS throughout."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = np.zeros((ecg.shape[0], len(members)), np.float32)
        with torch.no_grad():
            for j, (m, p) in enumerate(zip(members, params)):
                L = m["input_len"]
                for s in range(0, ecg.shape[0], BLOCK):
                    x = ecg[s:s + BLOCK, m["lead"], -L:]
                    out[s:s + BLOCK, j] = forward(
                        p, x.contiguous(), m["cardinality"],
                        tf32=tf32).cpu().numpy()
        return out
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def eq5(probs: np.ndarray, vitals: np.ndarray, labs: np.ndarray,
        forest, logreg) -> np.ndarray:
    """``[N, M]`` member probabilities, ``[N, C, W]`` vitals windows and
    ``[N, F]`` labs -> ``[N]`` float64 scores, one query at a time."""
    out = np.zeros(len(probs))
    for i in range(len(probs)):
        scores = [float(v) for v in probs[i]]
        scores.append(float(forest.predict_proba(vitals[i][None])[0]))
        scores.append(float(logreg.predict_proba(labs[i][None])[0]))
        out[i] = np.mean(scores)
    return out
