"""The CPU-side members of Eq. 5: a random forest per vital sign and a
logistic regression on the labs (HOLMES §4.1.1), in plain NumPy.

A frozen copy of the maths the port serves (numpy CART regression trees
bagged on bootstrap samples; full-batch gradient descent on the
standardised labs), so that refitting from the same seeded data gives
the same models as the program's fit."""
from __future__ import annotations

from typing import List, Optional

import numpy as np


class DecisionTree:
    def __init__(self, max_depth: int = 8, min_samples_leaf: int = 2,
                 max_features: Optional[int] = None, rng=None):
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.max_features = max_features
        self.rng = rng or np.random.default_rng(0)
        self.nodes: List[list] = []      # [feature, threshold, left, right, value]

    def fit(self, X: np.ndarray, y: np.ndarray) -> "DecisionTree":
        self.nodes = []
        self._grow(np.asarray(X, np.float64), np.asarray(y, np.float64), 0)
        return self

    def _grow(self, X, y, depth) -> int:
        idx = len(self.nodes)
        self.nodes.append([-1, 0.0, -1, -1, float(np.mean(y))])
        n, d = X.shape
        if depth >= self.max_depth or n < 2 * self.min_samples_leaf \
                or np.all(y == y[0]):
            return idx
        k = self.max_features or max(1, int(np.sqrt(d)))
        feats = self.rng.choice(d, size=min(k, d), replace=False)
        best = (0.0, -1, 0.0)
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
        self.nodes[idx][0] = f
        self.nodes[idx][1] = thr
        self.nodes[idx][2] = self._grow(X[mask], y[mask], depth + 1)
        self.nodes[idx][3] = self._grow(X[~mask], y[~mask], depth + 1)
        return idx

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, np.float64)
        out = np.empty(len(X))
        for i, row in enumerate(X):
            node = self.nodes[0]
            while node[0] >= 0:
                node = self.nodes[node[2] if row[node[0]] <= node[1]
                                  else node[3]]
            out[i] = node[4]
        return out


class RandomForest:
    def __init__(self, n_trees: int, max_depth: int, seed: int,
                 min_samples_leaf: int = 2):
        self.n_trees = n_trees
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
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
            t = DecisionTree(self.max_depth, self.min_samples_leaf, None, rng)
            t.fit(X[boot], y[boot])
            self.trees.append(t)
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        return np.mean([t.predict(X) for t in self.trees], axis=0)


class VitalsForest:
    """One forest a vital-sign channel (depth 6, seeds ``seed + c``);
    the channels' predictions averaged and clipped to [0, 1]."""

    def __init__(self, n_channels: int, n_trees: int, seed: int):
        self.models = [RandomForest(n_trees, 6, seed + c)
                       for c in range(n_channels)]

    def fit(self, X: np.ndarray, y: np.ndarray) -> "VitalsForest":
        for c, m in enumerate(self.models):
            m.fit(X[:, c, :], y)
        return self

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        return np.clip(np.mean(
            [m.predict(X[:, c, :]) for c, m in enumerate(self.models)],
            axis=0), 0.0, 1.0)


class LogisticRegression:
    def __init__(self, steps: int, seed: int, lr: float = 0.1,
                 l2: float = 1e-3):
        self.lr, self.steps, self.l2, self.seed = lr, steps, l2, seed

    def fit(self, X: np.ndarray, y: np.ndarray) -> "LogisticRegression":
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        mu, sd = X.mean(0), X.std(0) + 1e-8
        self.mu, self.sd = mu, sd
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
        return self._sigmoid(((np.asarray(X, np.float64) - self.mu)
                              / self.sd) @ self.w + self.b)
