"""Exact decision thresholds in GLM-sum space.

The reference's classifier decisions are rounded logistic outputs
(Predictor.cpp:315-333, Trainer.cpp:52,101):

    prob      = 1/(1 + exp(-s)) + bias          (all float64)
    positive  = floor(prob + 0.5) > 0           (get_close / filter)
    merge_pos = floor(prob + 0.5) == 1          (merge)

Every step of that chain is a monotone-nondecreasing function of the float64
sum s, so each decision is equivalent to comparing s against fixed float64
edges.  This module finds those edges exactly by bisection over the float64
bit lattice, evaluating the reference chain itself (numpy float64) — the
device programs then never need exp/logistic at all, only a dd-f32 compare
of s against the edge with a margin (cluster/device_loop.py).

Edge convention: `edge_ge(n)` is the smallest float64 s whose rounded
probability is >= n, so `rounded(s) >= n  <=>  s >= edge_ge(n)`.
"""
from __future__ import annotations

import math

import numpy as np

_NEG_INF = float("-inf")
_POS_INF = float("inf")


def _rounded_prob(s: float, bias: float) -> float:
    s = np.float64(s)
    with np.errstate(over="ignore"):
        prob = np.float64(1.0) / (np.float64(1.0) + np.exp(-s)) + np.float64(bias)
    return float(np.floor(prob + np.float64(0.5)))


def _f2key(x: float) -> int:
    """Monotone map of float64 (incl. infinities) to an ordered integer."""
    u = int(np.float64(x).view(np.uint64))
    if u & (1 << 63):
        return (~u) & ((1 << 64) - 1)
    return u | (1 << 63)


def _key2f(k: int) -> float:
    if k & (1 << 63):
        u = k & ~(1 << 63)
    else:
        u = (~k) & ((1 << 64) - 1)
    return float(np.uint64(u).view(np.float64))


def edge_ge(n: int, bias: float = 0.0) -> float:
    """Smallest float64 s with rounded probability >= n; +-inf if the
    predicate is never/always true over finite s."""
    lo_s, hi_s = -750.0, 750.0  # exp saturates well inside this range
    if _rounded_prob(lo_s, bias) >= n:
        return _NEG_INF
    if _rounded_prob(hi_s, bias) < n:
        return _POS_INF
    lo, hi = _f2key(lo_s), _f2key(hi_s)  # pred(lo)=False, pred(hi)=True
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if _rounded_prob(_key2f(mid), bias) >= n:
            hi = mid
        else:
            lo = mid
    return _key2f(hi)


def positive_edge(bias: float = 0.0) -> float:
    """positive (round(prob) > 0)  <=>  s >= positive_edge(bias)."""
    return edge_ge(1, bias)


def merge_band(bias: float = 0.0):
    """merge_pos (round(prob) == 1)  <=>  lo <= s < hi."""
    return edge_ge(1, bias), edge_ge(2, bias)


def nonzero_bands(bias: float = 0.0):
    """c_round(prob) != 0 (the update-phase filter, engine.py c_round)
    <=>  s < lo  OR  s >= hi, where [lo, hi) is the round-to-zero band."""
    return edge_ge(0, bias), edge_ge(1, bias)


def self_check(bias: float = 0.0, n: int = 200000, seed: int = 0) -> bool:
    """Fuzz the edge equivalence against the direct chain."""
    rng = np.random.default_rng(seed)
    s = np.concatenate([
        rng.standard_normal(n) * 20.0,
        rng.standard_normal(n) * 1e-6,
    ])
    edge = positive_edge(bias)
    prob = 1.0 / (1.0 + np.exp(-s)) + np.float64(bias)
    want = np.floor(prob + 0.5) > 0
    got = s >= edge
    return bool(np.array_equal(want, got))
