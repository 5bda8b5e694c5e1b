"""Low-frequency-modality models (§4.1.1): a random forest per vital sign
and a logistic regression for labs.

Per the paper these run on CPU with negligible latency, so they are NOT
model-zoo members for the latency profiler — but their scores join the
final accuracy ensemble (Eq. 5).
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.core.forest import RandomForest


class VitalsForest:
    """One RF per vital-sign channel; predictions averaged."""

    def __init__(self, n_channels: int, n_trees: int = 25, seed: int = 0):
        self.models: List[RandomForest] = [
            RandomForest(n_trees=n_trees, max_depth=6, seed=seed + i)
            for i in range(n_channels)]

    def fit(self, X: np.ndarray, y: np.ndarray) -> "VitalsForest":
        """X: [n, n_channels, window] per-channel vitals clips."""
        for c, m in enumerate(self.models):
            m.fit(X[:, c, :], y)
        return self

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        return np.clip(np.mean(
            [m.predict(X[:, c, :]) for c, m in enumerate(self.models)],
            axis=0), 0.0, 1.0)


class LogisticRegression:
    """Plain numpy logistic regression (labs model)."""

    def __init__(self, lr: float = 0.1, steps: int = 500, l2: float = 1e-3,
                 seed: int = 0):
        self.lr, self.steps, self.l2 = lr, steps, l2
        self.seed = seed
        self.w = None
        self.b = 0.0

    def fit(self, X: np.ndarray, y: np.ndarray) -> "LogisticRegression":
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        mu, sd = X.mean(0), X.std(0) + 1e-8
        self._norm = (mu, sd)
        Xn = (X - mu) / sd
        rng = np.random.default_rng(self.seed)
        self.w = rng.normal(0, 0.01, X.shape[1])
        self.b = 0.0
        for _ in range(self.steps):
            p = self._sigmoid(Xn @ self.w + self.b)
            g = Xn.T @ (p - y) / len(y) + self.l2 * self.w
            self.w -= self.lr * g
            self.b -= self.lr * float(np.mean(p - y))
        return self

    @staticmethod
    def _sigmoid(z):
        return 1.0 / (1.0 + np.exp(-np.clip(z, -30, 30)))

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        mu, sd = self._norm
        return self._sigmoid(((np.asarray(X, np.float64) - mu) / sd)
                             @ self.w + self.b)
