"""Closed-form GLM (linear model + logistic link at predict time).

Mirrors matrix::GLM (GLM.cpp:20-69): weights = pinv(X^T X) X^T y solved by
Gauss-Jordan inversion in the reference; here via numpy float64 solve with a
pseudo-inverse fallback for singular systems.  Predictions round the logistic
of the linear response; accuracy/sensitivity/specificity are computed on
+/-1 labels.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def logistic(x):
    return 1.0 / (1.0 + np.exp(-x))


def train_glm(X: np.ndarray, y: np.ndarray) -> np.ndarray:
    """w = pinv(X^T X) X^T y (GLM.cpp:20-23). Returns [n_features] float64.

    The reference's Gauss-Jordan inverse silently returns the *original*
    matrix when singular (Matrix.cpp:150-154,188-201); numpy's lstsq is the
    well-behaved equivalent and differs only on degenerate inputs.
    """
    X = np.asarray(X, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64).reshape(-1)
    xtx = X.T @ X
    xty = X.T @ y
    try:
        w = np.linalg.solve(xtx, xty)
    except np.linalg.LinAlgError:
        w = np.linalg.pinv(xtx) @ xty
    return w


def predict_labels(X: np.ndarray, w: np.ndarray) -> np.ndarray:
    """round(logistic(Xw)) (GLM.cpp:30-39), in {0, 1}; callers map 0 -> -1
    (FeatureSelector.cpp:63-68).  floor(x+0.5) = C round() on [0, 1];
    numpy's banker's rounding would flip the label at exactly 0.5
    (reachable when Xw == 0, e.g. degenerate all-zero features)."""
    z = X @ w
    return np.floor(logistic(z) + 0.5)


def accuracy(o_labels: np.ndarray, p_labels: np.ndarray) -> Tuple[float, float, float]:
    """(acc%, sensitivity%, specificity%) on +/-1 labels (GLM.cpp:41-69)."""
    o = np.asarray(o_labels).reshape(-1)
    p = np.asarray(p_labels).reshape(-1)
    neg = o == -1
    pos = ~neg
    neg_same = int(((o == p) & neg).sum())
    pos_same = int(((o == p) & pos).sum())
    n = len(o)
    acc = 100.0 * (neg_same + pos_same) / n
    sens = 100.0 * pos_same / max(1, int(pos.sum())) if pos.any() else np.nan
    spec = 100.0 * neg_same / max(1, int(neg.sum())) if neg.any() else np.nan
    return acc, sens, spec
