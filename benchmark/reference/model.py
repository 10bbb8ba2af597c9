"""The classifier of a weights file, scored in plain PyTorch and NumPy.

A weights file (MeShClust2's Predictor.cpp format) holds one GLM a head:
combos of single features, each single min/max-normalized and flipped
when it measures a distance, the sum w0 + sum_j w_j combo_j, the logistic
prob = 1 / (1 + exp(-sum)).  A pair is positive when floor(prob + 0.5) > 0,
and its dist is its first combo's value.  The regression head gives
clip(sum, 0, 1).

The singles come from per-pair integer sums over the two k-mer histograms
(min, product, the cumulative histograms' absolute difference) and the
per-row magnitudes and lengths, taken on the card in int64, so they are
exact; the formulas then run in NumPy in the order of the reference's
Feature.cpp.  Pearson's centred sums are taken in float64 on the card.
`dtype` is the precision of the formulas and of the GLM: float64 as the
configuration states, float32 for the lower-precision control.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

# single feature flags (Feature.h) this reference computes, with whether a
# larger raw value means more similar (Feature.cpp:548-663)
MANHATTAN = 1 << 2
EUCLIDEAN = 1 << 3
NORMALIZED_VECTORS = 1 << 5
PEARSON = 1 << 9
INTERSECTION = 1 << 13
EMD = 1 << 18
LENGTHD = 1 << 21
KULCZYNSKI2 = 1 << 27
SIMRATIO = 1 << 28
IS_SIM = {MANHATTAN: False, EUCLIDEAN: False, NORMALIZED_VECTORS: True,
          PEARSON: True, INTERSECTION: True, EMD: False, LENGTHD: False,
          KULCZYNSKI2: True, SIMRATIO: True}
# combo codes of the weights file (Predictor.cpp:96-110)
XY, XY2, X2Y, X2Y2 = 0, 1, 2, 3


def split_flags(flags: int) -> List[int]:
    """The single bits of an or'd flag word, lowest first."""
    return [1 << b for b in range(flags.bit_length()) if flags >> b & 1]


@dataclass
class Head:
    singles: List[int]
    mins: np.ndarray
    maxs: np.ndarray
    combos: List[Tuple[int, List[int]]]   # (combo code, indices into singles)
    weights: np.ndarray                   # [1 + C], weights[0] the intercept

    def check(self) -> None:
        missing = [s for s in self.singles if s not in IS_SIM]
        if missing:
            raise NotImplementedError(f"single features {missing} are not in "
                                      f"the reference")


@dataclass
class Weights:
    k: int
    mode: int
    id_cutoff: float
    datatype: str
    classifier: Optional[Head]
    regressor: Optional[Head]


def _read_head(tok: List[str], pos: int) -> Tuple[Head, int]:
    if tok[pos] != "n_combos:":
        raise ValueError(f"weights: expected n_combos:, got {tok[pos]!r}")
    n = int(tok[pos + 1])
    pos += 2
    weights = [float(tok[pos])]
    pos += 1
    raw, singles = [], []
    for _ in range(n):
        code, flags, w = int(tok[pos]), int(tok[pos + 1]), float(tok[pos + 2])
        pos += 3
        raw.append((code, flags))
        weights.append(w)
        for s in split_flags(flags):
            if s not in singles:
                singles.append(s)
    if tok[pos] != "n_singles:":
        raise ValueError(f"weights: expected n_singles:, got {tok[pos]!r}")
    m = int(tok[pos + 1])
    pos += 2
    bounds: Dict[int, Tuple[float, float]] = {}
    for _ in range(m):
        bounds[int(tok[pos])] = (float(tok[pos + 1]), float(tok[pos + 2]))
        pos += 3
    head = Head(
        singles=singles,
        mins=np.array([bounds[s][0] for s in singles]),
        maxs=np.array([bounds[s][1] for s in singles]),
        combos=[(code, [singles.index(s) for s in split_flags(fl)])
                for code, fl in raw],
        weights=np.asarray(weights))
    head.check()
    return head, pos


def read_weights(path: str) -> Weights:
    with open(path) as f:
        tok = f.read().split()
    head = {}
    pos = 0
    for key in ("k:", "mode:", "max_features:", "ID:", "Datatype:",
                "feature_set:"):
        if tok[pos] != key:
            raise ValueError(f"weights: expected {key}, got {tok[pos]!r}")
        head[key] = tok[pos + 1]
        pos += 2
    mode = int(head["mode:"])
    cls = reg = None
    if mode & 1:
        cls, pos = _read_head(tok, pos)
    if mode & 2:
        reg, pos = _read_head(tok, pos)
    return Weights(k=int(head["k:"]), mode=mode, id_cutoff=float(head["ID:"]),
                   datatype=head["Datatype:"], classifier=cls, regressor=reg)


class Pool:
    """A pool's histograms on the card with the per-row sums the singles
    read: magnitudes, self products, lengths, cumulative histograms."""

    def __init__(self, counts: torch.Tensor, lengths: np.ndarray):
        self.counts = counts                         # uint8/int [N, D] on card
        self.n, self.d = counts.shape
        self.lengths = np.asarray(lengths, dtype=np.int64)
        self.device = counts.device
        c = counts.to(torch.int64)
        self.mags = c.sum(1).cpu().numpy()
        self.selfdot = (c * c).sum(1).cpu().numpy()
        self.cum = torch.cumsum(counts.to(torch.int32), 1, dtype=torch.int32)
        self.means = c.sum(1).to(torch.float64) / self.d
        del c


_CHUNK = 1 << 15


def pair_sums(pool: Pool, a: np.ndarray, b: np.ndarray, want_pearson: bool
              ) -> Dict[str, np.ndarray]:
    """Per pair (a[i], b[i]) (b of length 1: one row against every a): the
    sums of min, product and |cumulative difference| as int64 and, when
    asked, pearson's centred product sum and squares in float64."""
    p = len(a)
    center = len(b) == 1 and p != 1
    out = {key: np.empty(p, dtype=np.int64) for key in ("min", "dot", "emd")}
    if want_pearson:
        for key in ("cov", "va", "vb"):
            out[key] = np.empty(p, dtype=np.float64)
    at = torch.as_tensor(np.asarray(a, dtype=np.int64), device=pool.device)
    bt = torch.as_tensor(np.asarray(b, dtype=np.int64), device=pool.device)
    means = pool.means
    for s in range(0, p, _CHUNK):
        e = min(p, s + _CHUNK)
        ai = at[s:e]
        bi = bt if center else bt[s:e]
        A = pool.counts[ai].to(torch.int32)
        B = pool.counts[bi].to(torch.int32)
        res = [torch.minimum(A, B).sum(1), (A * B).sum(1),
               (pool.cum[ai] - pool.cum[bi]).abs().sum(1)]
        if want_pearson:
            dp = A.to(torch.float64) - means[ai][:, None]
            dq = B.to(torch.float64) - means[bi][:, None]
            res += [(dp * dq).sum(1), (dp * dp).sum(1), (dq * dq).sum(1)]
        for key, val in zip(("min", "dot", "emd", "cov", "va", "vb"), res):
            out[key][s:e] = val.cpu().numpy()
    return out


def raw_singles(head: Head, pool: Pool, a: np.ndarray, b: np.ndarray,
                dtype=np.float64) -> np.ndarray:
    """[P, S] raw single values of the pairs (a[i], b[i])."""
    sums = pair_sums(pool, a, b, PEARSON in head.singles)
    b = np.broadcast_to(np.asarray(b), np.shape(a)) if len(b) == 1 else np.asarray(b)
    f = lambda x: np.asarray(x, dtype=dtype)  # noqa: E731
    d = f(pool.d)
    mag_a, mag_b = f(pool.mags[a]), f(pool.mags[b])
    sa, sb = f(pool.selfdot[a]), f(pool.selfdot[b])
    mins, dot = f(sums["min"]), f(sums["dot"])
    # the squared difference's sum, exact in int64
    norm2 = f(pool.selfdot[a] + pool.selfdot[b] - 2 * sums["dot"])
    cols = []
    for flag in head.singles:
        if flag == MANHATTAN:      # Feature.cpp:859-871
            v = f(pool.mags[a] + pool.mags[b] - 2 * sums["min"])
        elif flag == EUCLIDEAN:    # Feature.cpp:1113-1124
            v = np.sqrt(norm2)
        elif flag == NORMALIZED_VECTORS:   # Feature.cpp:1171-1184
            v = dot / np.sqrt(sa * sb)
        elif flag == PEARSON:      # Feature.cpp:795-811
            v = f(sums["cov"]) / np.sqrt(f(sums["va"]) * f(sums["vb"]))
        elif flag == INTERSECTION:  # Feature.cpp:764-777
            v = (2 * mins) / (mag_a + mag_b)
        elif flag == EMD:          # Feature.cpp:1505-1518
            v = f(sums["emd"])
        elif flag == LENGTHD:      # Feature.cpp:874-887
            v = f(np.abs(pool.lengths[a] - pool.lengths[b]))
        elif flag == KULCZYNSKI2:  # Feature.cpp:682-695
            ap, aq = mag_a / d, mag_b / d
            v = d * (ap + aq) / (2 * ap * aq) * mins
        elif flag == SIMRATIO:     # Feature.cpp:829-841
            v = dot / (dot + np.sqrt(norm2))
        else:
            raise NotImplementedError(flag)
        cols.append(np.asarray(v, dtype=dtype))
    return np.stack(cols, axis=1)


def glm(head: Head, raw: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(sum, dist) of the pairs' raw singles, in raw's precision."""
    dt = raw.dtype
    mins, maxs = head.mins.astype(dt), head.maxs.astype(dt)
    v = (raw - mins[None, :]) / (maxs - mins)[None, :]
    is_sim = np.array([IS_SIM[s] for s in head.singles])
    z = np.where(is_sim[None, :], v, dt.type(1) - v)
    cols = []
    for code, idx in head.combos:
        if code == XY:
            c = np.prod(z[:, idx], axis=1)
        elif code == X2Y2:
            c = np.prod(z[:, idx] ** 2, axis=1)
        elif code == XY2:
            c = z[:, idx[0]] * z[:, idx[1]] * z[:, idx[1]]
        elif code == X2Y:
            c = z[:, idx[0]] * z[:, idx[0]] * z[:, idx[1]]
        else:
            raise ValueError(f"combo code {code}")
        cols.append(c.astype(dt))
    combo = np.stack(cols, axis=1)
    w = head.weights.astype(dt)
    s = w[0] + combo @ w[1:]
    return s.astype(dt), combo[:, 0]


def prob(s: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        one = s.dtype.type(1)
        return one / (one + np.exp(-np.clip(s, -709.0, 709.0).astype(s.dtype)))


def positive(p: np.ndarray) -> np.ndarray:
    """round(prob) > 0, with C's round of a non-negative value."""
    return np.floor(p + p.dtype.type(0.5)) > 0
