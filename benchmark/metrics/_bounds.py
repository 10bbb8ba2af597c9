"""The least time the card could take for a kernel launch, from its
arguments: the larger of its bytes at the HBM rate and its operations at
the peak rate (a frozen copy of the port's smoke script's `bound_ms`,
`decision_bound` and `step_bound_terms` arithmetic).  Each input byte is
counted once, each output byte once.
"""
from __future__ import annotations

# NVIDIA's H100 SXM data sheet at 700 W: HBM bytes a second, and the float32
# rate outside the tensor cores, the one non-tensor rate it gives, taken for
# the kernels' integer and float64 operations too (no lower than their own
# rates, so the bound stays a lower bound on the time)
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
# pair statistics, per pair and element: min, add, multiply, add, subtract,
# prefix add, abs, add
PAIR_OPS = 8
# closest-to-mean, per member and element: min against the rounded mean,
# add, the truncated sum with the mean, add
CLOSEST_OPS = 4
# the fused epilogue's float64 operations: per pair 12 (three conversions,
# ap, aq and the norm, the clamp, exp, the logistic, the bias), per single
# up to 8 for its formula and 3 to normalize it, per combo up to 3 products
# and 2 for the GLM sum
EPI_OPS_PAIR = 12
EPI_OPS_SINGLE = 11
EPI_OPS_COMBO = 5
# the singles that take the fused kernel's FULL instantiation (float64
# work per element, another bound) and the plane singles (another kernel):
# a launch of a model with one of them is not bounded here
VECTOR_OR_PLANE = {1 << b for b in (1, 4, 6, 7, 8, 10, 11, 12, 14, 16, 19,
                                    20, 22, 23, 24, 25, 26, 29, 30, 31, 32, 33)}


def seconds(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S)


def decision_bound(rows: int, d: int, elem: int, p: int, nb: int,
                   n_singles: int, n_combos: int) -> float:
    """pair_stats_decision over p pairs (nb second indices: 1 in the center
    form), `rows` distinct rows referenced: each row's histogram and four
    float64 moments read once, the indices read, the int64 statistics and
    float64 decisions written, the parameters read; the statistics' and the
    epilogue's operations."""
    nbytes = (rows * (d * elem + 32) + 8 * (p + nb) + 48 * p
              + 8 * (4 + 4 * (n_singles + n_combos)))
    ops = (PAIR_OPS * p * d + p * (EPI_OPS_PAIR + EPI_OPS_SINGLE * n_singles
                                  + EPI_OPS_COMBO * n_combos))
    return seconds(nbytes, ops)


def step_bound(w: int, npos: int, count: int, d: int, elem: int) -> float:
    """window_step at w candidates, npos positives and count members after
    the absorb: per candidate its index, store row, s, dist, their bounds and
    statistics read and its state written; the positives' member slots
    written; per member its index, row, histogram and magnitude read; the
    running sum read and written, the trip written.  Operations: ~20 a
    candidate, an add per positive element, the mean per element,
    CLOSEST_OPS per member element."""
    nbytes = (w * (8 + 8 + 8 + 8 + 16 + 24 + 1 + 8 + 8) + npos * 8
              + count * (8 + 8 + d * elem + 8) + 2 * 8 * d + 32)
    ops = 20 * w + npos * d + 10 * d + CLOSEST_OPS * count * d
    return seconds(nbytes, ops)
