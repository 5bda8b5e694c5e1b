"""Genetic exploration of the binary ensemble space (Algorithm 2; the
port of ``repro/core/genetic.py``, drawing from the same
``numpy.random.Generator`` in the same order).

Operators (Eq. 4):
  Recombination(b1, b2) = concat(b1[:i], b2[i+1:])  (single crossover point)
  Mutation(b3, S)       = flip S randomly chosen coordinates
plus uniform random exploration with probability (1 - p).
Duplicates (against both the profiled set B and the candidate set B')
are rejected, exactly as in the paper's pseudo-code.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Set

import numpy as np


def recombination(b1: np.ndarray, b2: np.ndarray,
                  rng: np.random.Generator) -> np.ndarray:
    i = int(rng.integers(0, len(b1)))
    out = b1.copy()
    out[i + 1:] = b2[i + 1:]
    return out


def mutation(b3: np.ndarray, S: int, rng: np.random.Generator) -> np.ndarray:
    """S flips == uniform sample from the Manhattan-S neighborhood."""
    out = b3.copy()
    idx = rng.choice(len(b3), size=min(S, len(b3)), replace=False)
    out[idx] = 1 - out[idx]
    return out


def explore(B: np.ndarray, n_samples: int, S: int, p: float, q: float,
            rng: Optional[np.random.Generator] = None,
            max_tries: Optional[int] = None) -> np.ndarray:
    """Algorithm 2.  B: [n_profiled, n] profiled selectors.  Returns B'
    with up to n_samples NEW selectors (never duplicating B or B').

    p: probability of genetic (vs uniform-random) exploration;
    q: probability of mutation (vs recombination) within genetic moves.
    """
    rng = rng or np.random.default_rng(0)
    B = np.asarray(B, np.int8)
    n = B.shape[1]
    seen: Set[bytes] = {row.tobytes() for row in B}
    out: List[np.ndarray] = []
    tries = 0
    max_tries = max_tries or 50 * n_samples
    while len(out) < n_samples and tries < max_tries:
        tries += 1
        rnd, rnd1 = rng.random(), rng.random()
        picks = rng.integers(0, len(B), size=3)
        b1, b2, b3 = B[picks[0]], B[picks[1]], B[picks[2]]
        if rnd > p:
            b = rng.integers(0, 2, size=n).astype(np.int8)
        elif rnd1 > q:
            b = recombination(b1, b2, rng)
        else:
            b = mutation(b3, S, rng)
        key = b.tobytes()
        if key in seen:
            continue
        seen.add(key)
        out.append(b)
    if not out:
        return np.zeros((0, n), np.int8)
    return np.stack(out)
