"""Bagging ensemble prediction (Eq. 5) and the paper's accuracy metrics
(ROC-AUC, PR-AUC, F1, accuracy) in plain numpy: the port of
``repro/core/bagging.py``.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def bagging_predict(scores: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Eq. 5: E[Y|x] = (1/n_sel) sum_i b_i E_{m_i}[Y|x].

    scores: [n_models, n_samples] per-model P(Y=1); b: [n_models] in {0,1}.
    """
    b = np.asarray(b, bool)
    if not b.any():
        return np.full(scores.shape[1], 0.5)
    return scores[b].mean(axis=0)


def roc_auc(y: np.ndarray, score: np.ndarray) -> float:
    y = np.asarray(y, bool)
    pos, neg = score[y], score[~y]
    if len(pos) == 0 or len(neg) == 0:
        return 0.5
    # Mann-Whitney U via ranks (ties averaged)
    order = np.argsort(np.concatenate([pos, neg]), kind="stable")
    ranks = np.empty(len(order))
    ranks[order] = np.arange(1, len(order) + 1)
    s = np.concatenate([pos, neg])
    # average ranks over ties
    sorted_s = s[order]
    i = 0
    while i < len(sorted_s):
        j = i
        while j + 1 < len(sorted_s) and sorted_s[j + 1] == sorted_s[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = (i + j) / 2.0 + 1.0
        i = j + 1
    r_pos = ranks[:len(pos)].sum()
    u = r_pos - len(pos) * (len(pos) + 1) / 2.0
    return float(u / (len(pos) * len(neg)))


def pr_auc(y: np.ndarray, score: np.ndarray) -> float:
    """Average precision."""
    y = np.asarray(y, bool)
    order = np.argsort(-score, kind="stable")
    ys = y[order]
    tp = np.cumsum(ys)
    precision = tp / np.arange(1, len(ys) + 1)
    n_pos = ys.sum()
    if n_pos == 0:
        return 0.0
    return float(np.sum(precision * ys) / n_pos)


def f1_score(y: np.ndarray, score: np.ndarray, thr: float = 0.5) -> float:
    y = np.asarray(y, bool)
    pred = score >= thr
    tp = float(np.sum(pred & y))
    fp = float(np.sum(pred & ~y))
    fn = float(np.sum(~pred & y))
    denom = 2 * tp + fp + fn
    return 2 * tp / denom if denom else 0.0


def accuracy(y: np.ndarray, score: np.ndarray, thr: float = 0.5) -> float:
    return float(np.mean((score >= thr) == np.asarray(y, bool)))


def all_metrics(y: np.ndarray, score: np.ndarray) -> Dict[str, float]:
    return {"roc_auc": roc_auc(y, score), "pr_auc": pr_auc(y, score),
            "f1": f1_score(y, score), "accuracy": accuracy(y, score)}
