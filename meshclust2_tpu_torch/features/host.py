"""Host float64 oracle for all 33 alignment-free feature formulas.

This is the precision-reference implementation (numpy, float64), used for:
  - training-time feature tables (a few thousand pairs),
  - the exact recheck of borderline classifier decisions from the fast
    device path,
  - unit tests of the device kernels.

Each formula mirrors the corresponding routine in the reference's
Feature.cpp (file:line cited per function).  All functions are vectorized
over a batch of pairs: side arrays have a leading pair axis.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Optional

import numpy as np

from . import flags as F


@dataclass
class PairSide:
    """One side of a batch of pairs (P pairs)."""

    counts: np.ndarray        # [P, D] float64 pseudocounted
    mags: np.ndarray          # [P] float64 pseudo-magnitudes
    one_mers: np.ndarray      # [P, 4] float64 pseudocounted
    stddevs: np.ndarray       # [P]
    lengths: np.ndarray       # [P]
    k: int

    @property
    def dim(self) -> int:
        return self.counts.shape[1]

    def real_mags(self) -> np.ndarray:
        return self.mags - self.dim


def side_from_pointset(ps, idx: np.ndarray) -> PairSide:
    idx = np.asarray(idx)
    return PairSide(
        counts=ps.counts[idx].astype(np.float64),
        mags=ps.mags[idx].astype(np.float64),
        one_mers=ps.one_mers[idx].astype(np.float64),
        stddevs=ps.stddevs[idx],
        lengths=ps.lengths[idx].astype(np.float64),
        k=ps.k,
    )


@lru_cache(maxsize=8)
def reverse_index(k: int, alphabet: int = 4) -> np.ndarray:
    """Digit-reversal permutation (Feature.h:115-124)."""
    d = alphabet**k
    idx = np.arange(d)
    out = np.zeros(d, dtype=np.int64)
    for _ in range(k):
        out = out * alphabet + idx % alphabet
        idx //= alphabet
    return out


@lru_cache(maxsize=8)
def reverse_complement_index(k: int) -> np.ndarray:
    """Digit-complement + reversal permutation (Feature.h:126-137)."""
    d = 4**k
    idx = np.arange(d)
    out = np.zeros(d, dtype=np.int64)
    for _ in range(k):
        out = out * 4 + (3 - idx % 4)
        idx //= 4
    return out


@lru_cache(maxsize=8)
def digit_matrix(k: int, alphabet: int = 4) -> np.ndarray:
    """[D, k] matrix of base-`alphabet` digits (LSB first, the order d2s
    unpacks them, Feature.cpp:1737-1743)."""
    d = alphabet**k
    idx = np.arange(d)
    digs = np.zeros((d, k), dtype=np.int64)
    for j in range(k):
        digs[:, j] = idx % alphabet
        idx //= alphabet
    return digs


def tiedrank(counts: np.ndarray) -> np.ndarray:
    """Average tied ranks, 1-based, rowwise (Feature.cpp:1540-1588).

    Fully vectorized: within each sorted row, every tie group's rank is the
    mean of its 1-based positions = (first + last) / 2, computed with
    boundary masks + cummax/reversed-cummin instead of per-group Python
    loops (the loop version is O(rows * 4^k) interpreted iterations —
    minutes at 100k x 4^6)."""
    order = np.argsort(counts, axis=-1, kind="stable")
    p, d = counts.shape
    srt = np.take_along_axis(counts, order, axis=-1)
    pos = np.arange(1, d + 1, dtype=np.float64)
    # group starts: position where the value differs from its predecessor
    new_grp = np.empty((p, d), dtype=bool)
    new_grp[:, 0] = True
    new_grp[:, 1:] = srt[:, 1:] != srt[:, :-1]
    # first position of each group, broadcast over the group (cumulative max
    # of start positions); last position via the reversed trick
    first = np.maximum.accumulate(np.where(new_grp, pos, 0.0), axis=-1)
    grp_end = np.empty((p, d), dtype=bool)
    grp_end[:, -1] = True
    grp_end[:, :-1] = new_grp[:, 1:]
    # last position of each group: nearest end position at-or-after i
    # (cumulative min from the right over end positions, inf elsewhere)
    last = np.minimum.accumulate(
        np.where(grp_end, pos, np.inf)[:, ::-1], axis=-1
    )[:, ::-1]
    r = (first + last) / 2.0
    ranks = np.empty((p, d), dtype=np.float64)
    np.put_along_axis(ranks, order, r, axis=-1)
    return ranks


# ---------------------------------------------------------------------------
# individual feature formulas (batched); a = first argument, b = second.
# ---------------------------------------------------------------------------

def _grouped(x: np.ndarray, a: int = 4) -> np.ndarray:
    p, d = x.shape
    return x.reshape(p, d // a, a)


def hellinger(a: PairSide, b: PairSide) -> np.ndarray:  # Feature.cpp:1082-1095
    d = a.dim
    ap = a.mags / d
    aq = b.mags / d
    diff = np.sqrt(a.counts / ap[:, None]) - np.sqrt(b.counts / aq[:, None])
    return np.sqrt(2 * (diff * diff).sum(axis=1))


def manhattan(a, b):  # Feature.cpp:859-871 (int accumulator)
    return np.abs(a.counts - b.counts).sum(axis=1)


def euclidean(a, b):  # Feature.cpp:1113-1124
    diff = a.counts - b.counts
    return np.sqrt((diff * diff).sum(axis=1))


def chi_squared(a, b):  # Feature.cpp:1142-1153
    diff = a.counts - b.counts
    return (diff * diff / (a.counts + b.counts)).sum(axis=1)


def normalized_vectors(a, b):  # Feature.cpp:1171-1184
    s = (a.counts * b.counts).sum(axis=1)
    d1 = (a.counts * a.counts).sum(axis=1)
    d2 = (b.counts * b.counts).sum(axis=1)
    return s / np.sqrt(d1 * d2)


def harmonic_mean(a, b):  # Feature.cpp:1202-1213
    return 2 * (a.counts * b.counts / (a.counts + b.counts)).sum(axis=1)


def jefferey_divergence(a, b):  # Feature.cpp:1231-1263
    pp = a.counts / a.mags[:, None]
    pq = b.counts / b.mags[:, None]
    return ((pp - pq) * np.log(pp / pq)).sum(axis=1)


def k_divergence(a, b):  # Feature.cpp:1281-1296 (asymmetric)
    pp = a.counts / a.mags[:, None]
    pq = b.counts / b.mags[:, None]
    avg = 0.5 * (pp + pq)
    return (pp * np.log(pp / avg)).sum(axis=1)


def pearson(a, b):  # Feature.cpp:795-811
    d = a.dim
    dap = a.mags / d
    daq = b.mags / d
    dp = a.counts - dap[:, None]
    dq = b.counts - daq[:, None]
    return (dp * dq).sum(axis=1) / np.sqrt((dp * dp).sum(axis=1) * (dq * dq).sum(axis=1))


def squaredchord(a, b):  # Feature.cpp:736-746
    return (a.counts + b.counts - 2 * np.sqrt(a.counts * b.counts)).sum(axis=1)


def kl_conditional(a, b):  # Feature.cpp:1315-1349
    gp = _grouped(a.counts)
    gq = _grouped(b.counts)
    sp = gp.sum(axis=2, keepdims=True)
    sq = gq.sum(axis=2, keepdims=True)
    cp = gp / sp
    cq = gq / sq
    lg = np.log(cp / cq)
    inner_p = (cp * lg).sum(axis=2)
    inner_q = (-cq * lg).sum(axis=2)
    outer_p = (sp[:, :, 0] * inner_p).sum(axis=1)
    outer_q = (sq[:, :, 0] * inner_q).sum(axis=1)
    return (outer_p / a.mags + outer_q / b.mags) / 2.0


def markov(a, b):  # Feature.cpp:1367-1393 (q = a, p = b; symmetric total)
    gq = _grouped(a.counts)
    gp = _grouped(b.counts)
    psum = gp.sum(axis=2, keepdims=True)
    qsum = gq.sum(axis=2, keepdims=True)
    total = ((gq - 1) * (np.log(gp) - np.log(psum))).sum(axis=(1, 2))
    total += ((gp - 1) * (np.log(gq) - np.log(qsum))).sum(axis=(1, 2))
    return total / 2


def intersection(a, b):  # Feature.cpp:764-777
    dist = 2 * np.minimum(a.counts, b.counts).sum(axis=1)
    return dist / (a.mags + b.mags)


def rre_k_r(a, b):  # Feature.cpp:1029-1064
    gp = _grouped(a.counts)
    gq = _grouped(b.counts)
    sp = gp.sum(axis=2, keepdims=True)
    sq = gq.sum(axis=2, keepdims=True)
    cp = gp / sp
    cq = gq / sq
    avg = 0.5 * (cp + cq)
    op = (gp * np.log(cp / avg) / sp).sum(axis=(1, 2))
    oq = (gq * np.log(cq / avg) / sq).sum(axis=(1, 2))
    return 0.5 * (op + oq)


def d2z(a, b):  # Feature.cpp:1411-1426
    d = a.dim
    pz = (a.counts - (a.mags / d)[:, None]) / a.stddevs[:, None]
    qz = (b.counts - (b.mags / d)[:, None]) / b.stddevs[:, None]
    return (pz * qz).sum(axis=1)


def _d_markov(a, b):  # Feature.cpp:1429-1433: log(markov(b,a)/markov(b,b))/realmag(b)
    return np.log(markov(b, a) / markov(b, b)) / b.real_mags()


def sim_mm(a, b):  # Feature.cpp:1451-1454
    return 1 - np.exp(0.5 * (_d_markov(a, b) + _d_markov(b, a)))


def euclidean_z(a, b):  # Feature.cpp:1472-1487
    d = a.dim
    pz = (a.counts - (a.mags / d)[:, None]) / a.stddevs[:, None]
    qz = (b.counts - (b.mags / d)[:, None]) / b.stddevs[:, None]
    diff = pz - qz
    return np.sqrt((diff * diff).sum(axis=1))


def emd(a, b):  # Feature.cpp:1505-1518 (cumulative histogram distance)
    cp = np.cumsum(a.counts, axis=1)
    cq = np.cumsum(b.counts, axis=1)
    return np.abs(cp - cq).sum(axis=1)


def spearman(a, b, ranks_a=None, ranks_b=None):  # Feature.cpp:1644-1663
    ip = tiedrank(a.counts) if ranks_a is None else ranks_a
    iq = tiedrank(b.counts) if ranks_b is None else ranks_b
    d = a.dim
    expected = (d + 1) / 2.0
    dp = ip - expected
    dq = iq - expected
    cov = (dp * dq).sum(axis=1)
    sp = (dp * dp).sum(axis=1)
    sq = (dq * dq).sum(axis=1)
    return 1 - cov / (np.sqrt(sp) * np.sqrt(sq))


def jaccard(a, b):  # Feature.cpp:1681-1693
    hit = (a.counts == b.counts) & (a.counts > 1)
    return hit.sum(axis=1) / a.dim


def length_difference(a, b):  # Feature.cpp:874-887
    return np.abs(a.lengths - b.lengths)


def _expected_counts(side: PairSide) -> np.ndarray:
    """E[i] = realmag * prod_j p1[digit_j]/pmag + 1 (Feature.cpp:1734-1758)."""
    digs = digit_matrix(side.k)
    probs = side.one_mers / side.mags[:, None]          # [P, 4]
    per_digit = probs[:, digs]                          # [P, D, k]
    prod = per_digit.prod(axis=2)                       # [P, D]
    return side.real_mags()[:, None] * prod + 1, prod


def d2s(a, b):  # Feature.cpp:1713-1765
    ea, _ = _expected_counts(a)
    eb, _ = _expected_counts(b)
    hp = a.counts - ea
    hq = b.counts - eb
    denom = np.hypot(hp, hq)
    terms = np.where(denom != 0, hp * hq / np.where(denom == 0, 1.0, denom), 0.0)
    return terms.sum(axis=1)


def d2_star(a, b):  # Feature.cpp:1786-1857
    ea, _ = _expected_counts(a)
    eb, _ = _expected_counts(b)
    hp = a.counts - ea
    hq = b.counts - eb
    digs = digit_matrix(a.k)
    pq_probs = (a.one_mers + b.one_mers) / (a.mags + b.mags)[:, None]
    pq1 = pq_probs[:, digs].prod(axis=2)
    rm_sum = a.real_mags() + b.real_mags()
    e = rm_sum[:, None] * pq1 + 1
    pq_len = np.sqrt(a.real_mags() * b.real_mags())
    denom = e * pq_len[:, None]
    terms = np.where(denom > 0, hp * hq / np.where(denom <= 0, 1.0, denom), 0.0)
    return terms.sum(axis=1)


def afd(a, b):  # Feature.cpp:1877-1923 (k must be 2)
    if a.k != 2:
        raise ValueError("AFD requires k == 2")
    d = a.dim
    alpha = 4
    n_minus_two = (d // alpha) // alpha  # = 1 for k=2
    gp = a.counts.reshape(a.counts.shape[0], d // n_minus_two, n_minus_two).sum(axis=2)
    gq = b.counts.reshape(b.counts.shape[0], d // n_minus_two, n_minus_two).sum(axis=2)
    first_i = np.arange(d // n_minus_two)
    x = gp / a.one_mers[:, first_i // alpha]
    y = gq / b.one_mers[:, first_i // alpha]
    diff = np.abs(x - y)
    unsq = diff * (1 + diff) ** -14.0
    return (unsq * unsq).sum(axis=1)


def mismatch(a, b):  # Feature.cpp:1941-1952
    return (a.counts != b.counts).sum(axis=1).astype(np.float64)


def canberra(a, b):  # Feature.cpp:1970-1983
    num = np.abs(a.counts - b.counts)
    return (num / (a.counts + b.counts)).sum(axis=1)


def kulczynski1(a, b):  # Feature.cpp:2001-2013
    num = np.abs(a.counts - b.counts)
    den = np.minimum(a.counts, b.counts)
    return (num / den).sum(axis=1)


def kulczynski2(a, b):  # Feature.cpp:682-695
    d = a.dim
    min_sum = np.minimum(a.counts, b.counts).sum(axis=1)
    ap = a.mags / d
    aq = b.mags / d
    coeff = d * (ap + aq) / (2 * ap * aq)
    return coeff * min_sum


def simratio(a, b):  # Feature.cpp:829-841
    diff = a.counts - b.counts
    dot = (a.counts * b.counts).sum(axis=1)
    norm2 = (diff * diff).sum(axis=1)
    return dot / (dot + np.sqrt(norm2))


def jensen_shannon(a, b):  # Feature.cpp:984-1009
    pp = a.counts / a.mags[:, None]
    pq = b.counts / b.mags[:, None]
    avg = 0.5 * (pp + pq)
    s = pp * np.log(pp / avg) + pq * np.log(pq / avg)
    return s.sum(axis=1) / 2


def n2_z(v: np.ndarray) -> np.ndarray:
    """The rows of v standardized, then normalized: one side of the shared
    neighbor() standardize-normalize-dot (Feature.cpp:890-920)."""
    m = v.mean(axis=1, keepdims=True)
    s = np.sqrt(((v - m) ** 2).mean(axis=1, keepdims=True))
    z = (v - m) / s
    return z / np.linalg.norm(z, axis=1, keepdims=True)


def n2_vector(flag: int, counts: np.ndarray, k: int) -> np.ndarray:
    """The summed histogram of n2r (counts + reversed), n2rc (counts +
    reverse complement) or n2rrc (all three), in the reference's order."""
    if flag == F.FEAT_N2R:
        return counts + counts[:, reverse_index(k)]
    if flag == F.FEAT_N2RC:
        return counts + counts[:, reverse_complement_index(k)]
    return (counts[:, reverse_complement_index(k)] + counts
            + counts[:, reverse_index(k)])


def _n2(a, b, flag):
    return (n2_z(n2_vector(flag, a.counts, a.k))
            * n2_z(n2_vector(flag, b.counts, b.k))).sum(axis=1)


def n2r(a, b):  # Feature.cpp:2088-2109
    return _n2(a, b, F.FEAT_N2R)


def n2rc(a, b):  # Feature.cpp:2127-2153
    return _n2(a, b, F.FEAT_N2RC)


def n2rrc(a, b):  # Feature.cpp:938-966
    return _n2(a, b, F.FEAT_N2RRC)


_DISPATCH = {
    F.FEAT_HELLINGER: hellinger,
    F.FEAT_MANHATTAN: manhattan,
    F.FEAT_EUCLIDEAN: euclidean,
    F.FEAT_CHI_SQUARED: chi_squared,
    F.FEAT_NORMALIZED_VECTORS: normalized_vectors,
    F.FEAT_HARMONIC_MEAN: harmonic_mean,
    F.FEAT_JEFFEREY_DIV: jefferey_divergence,
    F.FEAT_K_DIV: k_divergence,
    F.FEAT_PEARSON_COEFF: pearson,
    F.FEAT_SQCHORD: squaredchord,
    F.FEAT_KL_COND: kl_conditional,
    F.FEAT_MARKOV: markov,
    F.FEAT_INTERSECTION: intersection,
    F.FEAT_RRE_K_R: rre_k_r,
    F.FEAT_D2z: d2z,
    F.FEAT_SIM_MM: sim_mm,
    F.FEAT_EUCLIDEAN_Z: euclidean_z,
    F.FEAT_EMD: emd,
    F.FEAT_SPEARMAN: spearman,
    F.FEAT_JACCARD: jaccard,
    F.FEAT_LENGTHD: length_difference,
    F.FEAT_D2s: d2s,
    F.FEAT_AFD: afd,
    F.FEAT_MISMATCH: mismatch,
    F.FEAT_CANBERRA: canberra,
    F.FEAT_KULCZYNSKI1: kulczynski1,
    F.FEAT_KULCZYNSKI2: kulczynski2,
    F.FEAT_SIMRATIO: simratio,
    F.FEAT_JENSEN_SHANNON: jensen_shannon,
    F.FEAT_D2_star: d2_star,
    F.FEAT_N2R: n2r,
    F.FEAT_N2RC: n2rc,
    F.FEAT_N2RRC: n2rrc,
}


def compute_singles(single_flags: List[int], a: PairSide, b: PairSide) -> np.ndarray:
    """Raw (unnormalized) values of the given single features for all pairs.

    Returns [P, len(single_flags)] float64.  FEAT_ALIGN is not supported here
    (it needs raw sequences; see utils/align.py).
    """
    cols = []
    for flag in single_flags:
        fn = _DISPATCH.get(flag)
        if fn is None:
            raise ValueError(f"unsupported feature flag {flag}")
        cols.append(np.asarray(fn(a, b), dtype=np.float64))
    return np.stack(cols, axis=1) if cols else np.zeros((len(a.mags), 0))
