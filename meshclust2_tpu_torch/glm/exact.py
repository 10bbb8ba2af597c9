"""Bitwise-faithful replication of the reference GLM solve.

The reference computes w = pinv(X^T X) X^T y (GLM.cpp:20-23) where pinv(A)
for the square normal matrix is gaussJordanInverse(A^T A) * A^T
(Matrix.cpp:209-221) and every product runs Matrix::operator*'s sequential
`curSum = curSum + a[i][k] * b[k][j]` accumulation (Matrix.cpp:76-96).
Replicating the operation order reproduces the reference's weights to the
last bit, which the byte-exact weights.txt seam requires.

Matrices here are small (n_features <= 6 columns), so plain Python loops
over the tiny dimensions with numpy rows for the long one are fast enough.
"""
from __future__ import annotations

from typing import List

import numpy as np


def matmul_ref(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Matrix::operator* accumulation order: for each (i, j), sum over k in
    ascending order.  Vectorizing over j keeps per-(i,k) operations fused
    exactly like the scalar loop (each k adds a[i,k]*b[k,j] to the running
    sum; element-wise numpy add performs the same single rounding)."""
    n, m = a.shape
    m2, p = b.shape
    assert m == m2
    out = np.zeros((n, p), dtype=np.float64)
    for i in range(n):
        acc = np.zeros(p, dtype=np.float64)
        ai = a[i]
        for k in range(m):
            acc = acc + ai[k] * b[k]
        out[i] = acc
    return out


def gauss_jordan_inverse(m_in: np.ndarray) -> np.ndarray:
    """Matrix::gaussJordanInverse (Matrix.cpp:109-207), including its exact
    pivot handling (divide-first when pivot != 1, type-1 row swaps when a
    pivot is zero, and returning the ORIGINAL matrix when singular)."""
    m = m_in.astype(np.float64).copy()
    n = m.shape[0]
    inv = np.zeros((n, n), dtype=np.float64)
    for i in range(n):
        inv[i, i] = 1.0
    orig = m_in.astype(np.float64).copy()

    for i in range(n):
        if m[i, i] != 1.0:
            if m[i, i] != 0.0:
                pivot = m[i, i]
                for j in range(n):
                    m[i, j] = m[i, j] / pivot
                    inv[i, j] = inv[i, j] / pivot
            else:
                row = i + 1
                proper = False
                while not proper and row < n:
                    if m[row, i] != 0.0:
                        proper = True
                    else:
                        row += 1
                if proper:
                    for j in range(n):
                        m[i, j], m[row, j] = m[row, j], m[i, j]
                        inv[i, j], inv[row, j] = inv[row, j], inv[i, j]
                else:
                    return orig  # "Inverse does not exist"
                pivot = m[i, i]
                for j in range(n):
                    m[i, j] = m[i, j] / pivot
                    inv[i, j] = inv[i, j] / pivot
        for below in range(i + 1, n):
            if m[below, i] != 0.0:
                pivot = m[below, i]
                for j in range(n):
                    m[below, j] = m[below, j] - pivot * m[i, j]
                    inv[below, j] = inv[below, j] - pivot * inv[i, j]
    for i in range(n - 1, -1, -1):
        for above in range(i):
            if m[above, i] != 0.0:
                pivot = m[above, i]
                for j in range(n):
                    m[above, j] = m[above, j] - pivot * m[i, j]
                    inv[above, j] = inv[above, j] - pivot * inv[i, j]
    # singularity re-check (Matrix.cpp:188-201)
    for i in range(n):
        for j in range(n):
            if i == j and m[i, j] != 1.0:
                return orig
            if i != j and m[i, j] != 0.0:
                return orig
    return inv


def pseudo_inverse(a: np.ndarray) -> np.ndarray:
    """Matrix::pseudoInverse (Matrix.cpp:209-221)."""
    n, m = a.shape
    at = a.T.copy()
    if n >= m:
        trans_by_orig = matmul_ref(at, a)
        return matmul_ref(gauss_jordan_inverse(trans_by_orig), at)
    orig_by_trans = matmul_ref(a, at)
    return matmul_ref(at, gauss_jordan_inverse(orig_by_trans))


def train_glm_ref(X: np.ndarray, y: np.ndarray) -> np.ndarray:
    """GLM::train (GLM.cpp:20-23): w = pinv(X^T X) * X^T * y, left
    associative."""
    X = np.asarray(X, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64).reshape(-1, 1)
    xt = X.T.copy()
    xtx = matmul_ref(xt, X)
    p = pseudo_inverse(xtx)
    w = matmul_ref(matmul_ref(p, xt), y)
    return w.reshape(-1)


def train_glm_exact(X: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Native reference-bitwise solve when available (matches the reference
    binary's FMA contraction), else the Python replication above."""
    from ..native import glm_train_native

    w = glm_train_native(X, y)
    if w is not None:
        return w
    return train_glm_ref(X, y)
