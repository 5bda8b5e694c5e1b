"""Surrogate probability models for the accuracy and latency profilers
(§3.3.2b; the port of ``repro/core/surrogate.py``).  "we build two
random forest as the surrogate models for accuracy and latency" (§4.2)
— fit on the binary selectors b profiled so far, predicting f_a(V,b)
and f_l(V,c,b) cheaply for candidate screening.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.core.forest import RandomForest


class SurrogatePair:
    def __init__(self, n_trees: int = 40, max_depth: int = 10,
                 seed: int = 0):
        self.acc = RandomForest(n_trees=n_trees, max_depth=max_depth,
                                max_features=None, seed=seed)
        self.lat = RandomForest(n_trees=n_trees, max_depth=max_depth,
                                max_features=None, seed=seed + 1)
        self._fitted = False

    @property
    def is_fitted(self) -> bool:
        return self._fitted

    @classmethod
    def from_observations(cls, B: np.ndarray, y_acc: np.ndarray,
                          y_lat: np.ndarray, **kwargs) -> "SurrogatePair":
        """A pair pre-fitted on a previous run's profiled set — the
        warm-start surrogate the online ``recompose`` screens candidate
        seeds with before any fresh profiling."""
        return cls(**kwargs).fit(B, y_acc, y_lat)

    def fit(self, B: np.ndarray, y_acc: np.ndarray, y_lat: np.ndarray
            ) -> "SurrogatePair":
        B = np.asarray(B, np.float64)
        # feature augmentation: |b| (ensemble size) is highly informative
        # for latency and helps shallow trees generalize.
        X = self._features(B)
        self.acc.fit(X, y_acc)
        self.lat.fit(X, y_lat)
        self._fitted = True
        return self

    @staticmethod
    def _features(B: np.ndarray) -> np.ndarray:
        B = np.atleast_2d(np.asarray(B, np.float64))
        size = B.sum(axis=1, keepdims=True)
        return np.concatenate([B, size], axis=1)

    def predict(self, B: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        if not self._fitted:
            raise RuntimeError("surrogates not fitted")
        X = self._features(B)
        return self.acc.predict(X), self.lat.predict(X)

    def r2(self, B: np.ndarray, y_acc: np.ndarray, y_lat: np.ndarray
           ) -> Tuple[float, float]:
        """Fig. 8's metric on held-out (unexplored) selectors."""
        X = self._features(B)
        return self.acc.score_r2(X, y_acc), self.lat.score_r2(X, y_lat)
