"""Random forest (numpy CART ensemble).

Used in two places, exactly as in the paper:
  * §4.2: "we build two random forest as the surrogate models for accuracy
    and latency" (fit on binary selector vectors b),
  * §4.1.1: "we simply train a random forest for each vital sign".

Regression trees; classification is regression on {0,1} targets whose
prediction is the positive-class probability (Breiman 2001 bagging).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class _Node:
    feature: int = -1
    threshold: float = 0.0
    left: int = -1
    right: int = -1
    value: float = 0.0


class DecisionTree:
    def __init__(self, max_depth: int = 8, min_samples_leaf: int = 2,
                 max_features: Optional[int] = None, rng=None):
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.max_features = max_features
        self.rng = rng or np.random.default_rng(0)
        self.nodes: List[_Node] = []

    def fit(self, X: np.ndarray, y: np.ndarray) -> "DecisionTree":
        self.nodes = []
        self._grow(np.asarray(X, np.float64), np.asarray(y, np.float64), 0)
        return self

    def _grow(self, X, y, depth) -> int:
        idx = len(self.nodes)
        self.nodes.append(_Node(value=float(np.mean(y))))
        n, d = X.shape
        if depth >= self.max_depth or n < 2 * self.min_samples_leaf \
                or np.all(y == y[0]):
            return idx
        k = self.max_features or max(1, int(np.sqrt(d)))
        feats = self.rng.choice(d, size=min(k, d), replace=False)
        best = (0.0, -1, 0.0)                   # (gain, feature, threshold)
        total_sum, total_sq = y.sum(), (y ** 2).sum()
        base = total_sq - total_sum ** 2 / n
        for f in feats:
            order = np.argsort(X[:, f], kind="stable")
            xs, ys = X[order, f], y[order]
            csum = np.cumsum(ys)[:-1]
            csq = np.cumsum(ys ** 2)[:-1]
            nl = np.arange(1, n)
            valid = xs[1:] != xs[:-1]
            nl_f = nl.astype(np.float64)
            sse = ((csq - csum ** 2 / nl_f)
                   + (total_sq - csq) - (total_sum - csum) ** 2 / (n - nl_f))
            sse = np.where(valid & (nl >= self.min_samples_leaf)
                           & (n - nl >= self.min_samples_leaf), sse, np.inf)
            j = int(np.argmin(sse))
            gain = base - sse[j]
            if np.isfinite(sse[j]) and gain > best[0] + 1e-12:
                best = (gain, f, (xs[j] + xs[j + 1]) / 2.0)
        if best[1] < 0:
            return idx
        _, f, thr = best
        mask = X[:, f] <= thr
        self.nodes[idx].feature = f
        self.nodes[idx].threshold = thr
        self.nodes[idx].left = self._grow(X[mask], y[mask], depth + 1)
        self.nodes[idx].right = self._grow(X[~mask], y[~mask], depth + 1)
        return idx

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, np.float64)
        out = np.empty(len(X))
        for i, row in enumerate(X):
            node = self.nodes[0]
            while node.feature >= 0:
                node = self.nodes[node.left if row[node.feature]
                                  <= node.threshold else node.right]
            out[i] = node.value
        return out


class RandomForest:
    """Bootstrap-aggregated regression trees (Eq. 5 bagging on trees)."""

    def __init__(self, n_trees: int = 50, max_depth: int = 8,
                 min_samples_leaf: int = 2,
                 max_features: Optional[int] = None, seed: int = 0):
        self.n_trees = n_trees
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.max_features = max_features
        self.seed = seed
        self.trees: List[DecisionTree] = []

    def fit(self, X: np.ndarray, y: np.ndarray) -> "RandomForest":
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        rng = np.random.default_rng(self.seed)
        self.trees = []
        n = len(X)
        for _ in range(self.n_trees):
            boot = rng.integers(0, n, size=n)
            t = DecisionTree(self.max_depth, self.min_samples_leaf,
                             self.max_features, rng)
            t.fit(X[boot], y[boot])
            self.trees.append(t)
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        if not self.trees:
            raise RuntimeError("RandomForest.predict before fit")
        return np.mean([t.predict(X) for t in self.trees], axis=0)

    def score_r2(self, X: np.ndarray, y: np.ndarray) -> float:
        """R² — the metric Fig. 8 tracks for the surrogates."""
        y = np.asarray(y, np.float64)
        pred = self.predict(X)
        ss_res = float(np.sum((y - pred) ** 2))
        ss_tot = float(np.sum((y - np.mean(y)) ** 2))
        return 1.0 - ss_res / max(ss_tot, 1e-12)
