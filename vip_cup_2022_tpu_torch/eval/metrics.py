"""Evaluation metrics on numpy arrays (the port's own copy of
``vip_cup_2022_tpu/eval/metrics.py``): the competition's balanced accuracy
and final score, and top-k accuracy."""
from __future__ import annotations

import numpy as np


def balanced_accuracy_score(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """The mean of the per-class recalls over the classes present in
    ``y_true``."""
    y_true = np.asarray(y_true).astype(np.int64)
    y_pred = np.asarray(y_pred).astype(np.int64)
    recalls = [np.mean(y_pred[y_true == c] == c) for c in np.unique(y_true)]
    return float(np.mean(recalls))


def top_k_accuracy(y_true: np.ndarray, probs: np.ndarray, k: int = 5) -> float:
    """The share of rows whose true class is among the ``k`` largest
    probabilities."""
    y_true = np.asarray(y_true).reshape(-1, 1)
    topk = np.argsort(-np.asarray(probs), axis=-1)[:, :k]
    return float(np.mean(np.any(topk == y_true, axis=-1)))


def competition_score(acc_test1: float, acc_test2: float) -> float:
    """The competition's final score: 0.7 of the first test set's balanced
    accuracy plus 0.3 of the second's."""
    return 0.7 * acc_test1 + 0.3 * acc_test2
