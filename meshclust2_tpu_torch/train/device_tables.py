"""Training pair tables on the card.

The port of meshclust2_tpu/train/device_tables.py (DeviceTableBuilder._impl,
raw_with_err and device_raw_singles, lines 53-180).  The reference builds
its [pairs x singles] feature matrix with an OpenMP loop over pairs
(Predictor.cpp:344); here one DeviceStore of the pair population (templates
plus mutants) is uploaded, and each chunk of pairs runs the pair-statistics
kernel in pair form, then the float64 `derive_singles` the scorer uses.

Exactness contract, as in the JAX package.  The min/max normalization
bounds are serialized into weights.txt and must be bit-exact float64, so
every pair whose interval [raw - slack, raw + slack] can reach a single's
minimum or maximum is re-computed by the host oracle and its row replaced;
the true extreme pair is provably inside that candidate set.  The rest of
the table feeds the selection's GLM solves, and the shipped weights are
re-solved on the host's exact columns (train/predictor.py:make_exact).

The error bound.  The card computes in native float64, so the JAX
version's double-float error terms do not apply.  What the bound covers is
the gap between the identity-form formulas (cov = dot - d*ap*aq from exact
integer statistics) and the host's direct sums over the rows (sum of
(p_i - ap)(q_i - aq)), which only matters where terms cancel: pearson, d2z
and euclidean_z.  Each bound is built from the magnitudes of the terms that
cancel, with the host's sequential-summation error over D terms
((D + 8) u, u = 2^-53) and the card's few roundings; a value that is not
finite gets an infinite bound, so its row is always re-computed.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, List, Tuple

import numpy as np
import torch

from ..cluster.device_store import DeviceStore
from ..features import flags as F
from ..kmer.counting import PointSet
from ..ops.device_features import check_fused
from ..ops.pair_stats import derive_singles, pair_stats

_U = 2.0 ** -53   # unit roundoff of float64

# singles whose identity form and the host's direct sums round alike up to
# a few ulps of the result: exact integer operands, a few correctly rounded
# operations on each side
_PLAIN = frozenset({
    F.FEAT_EUCLIDEAN, F.FEAT_INTERSECTION, F.FEAT_KULCZYNSKI2,
    F.FEAT_SIMRATIO, F.FEAT_NORMALIZED_VECTORS,
})
# exact integers on both sides
_EXACT = frozenset({F.FEAT_MANHATTAN, F.FEAT_EMD, F.FEAT_LENGTHD})


@dataclass
class TableStats:
    """What the builder did over one training run."""

    tables: int = 0
    pairs: int = 0
    launches: int = 0          # pair_stats kernel launches (CUDA only)
    rechecked_rows: int = 0    # rows re-computed by the host oracle
    device_seconds: float = 0.0   # store upload to read-back, synced
    host_seconds: float = 0.0     # the host re-check


def singles_error(stats: torch.Tensor, raw: torch.Tensor, mags_a, mags_b,
                  self_a, self_b, std_a, std_b, d: int,
                  flags_list) -> torch.Tensor:
    """[P, S] float64 absolute bounds of |raw - host oracle| for the
    derive_singles values `raw` of the same statistics and moments."""
    dot = stats[:, 1].to(torch.float64)
    ap = mags_a / d
    aq = mags_b / d
    # the cancelling parts: cov = dot - d ap aq, na = self_a - d ap^2
    dapq = d * ap * aq
    cov = dot - dapq
    na = self_a - d * ap ** 2
    nb = self_b - d * aq ** 2
    # the card's roundings of cov, na, nb (one product, one difference each,
    # counted twice)
    e_cov = 2 * _U * (dapq + cov.abs())
    e_na = 2 * _U * (d * ap ** 2 + na.abs())
    e_nb = 2 * _U * (d * aq ** 2 + nb.abs())
    # the host's sequential sums over d terms, relative to the sum of their
    # absolute values, plus the roundings of each term
    h = (d + 16) * _U
    sab = std_a * std_b
    out = []
    for j, flag in enumerate(flags_list):
        v = raw[:, j]
        if flag in _EXACT:
            err = torch.zeros_like(v)
        elif flag in _PLAIN:
            err = 8 * _U * v.abs()
        elif flag == F.FEAT_PEARSON_COEFF:
            den = torch.sqrt(na * nb)
            # sum |dp dq| <= sqrt(na nb) (Cauchy-Schwarz)
            err = (e_cov / den + h
                   + v.abs() * (0.5 * (e_na / na.abs() + e_nb / nb.abs())
                                + h + 8 * _U))
        elif flag == F.FEAT_D2z:
            ez = torch.sqrt(na.abs() * nb.abs()) / sab
            err = e_cov / sab + h * ez + 4 * _U * v.abs()
        elif flag == F.FEAT_EUCLIDEAN_Z:
            ea = na.abs() / std_a ** 2
            eb = nb.abs() / std_b ** 2
            t_mag = ea + eb + 2 * (cov / sab).abs()
            dt = (e_na / std_a ** 2 + e_nb / std_b ** 2 + 2 * e_cov / sab
                  + (h + 8 * _U) * t_mag)
            # |sqrt(t1) - sqrt(t2)| <= dt / max(sqrt(t1), sqrt(dt)) when
            # |t1 - t2| <= dt: sound down to identical rows, where the host
            # sums exact zeros
            err = dt / torch.maximum(v.abs(), torch.sqrt(dt))
        else:  # pragma: no cover - guarded by check_fused
            raise ValueError(f"flag {flag} not derivable from fused stats")
        out.append(err)
    return torch.stack(out, dim=1)


class TorchDeviceTableBuilder:
    """Raw-singles tables with absolute error bounds for (a_row, b_row) pair
    lists of one point set, on its own DeviceStore.

    Raises DeviceLoopUnsupported when a single is not derivable from the
    pair statistics (the `slow` and `extraslow` feature sets) or the point
    set lies outside the exact-integer envelope."""

    MAX_CHUNK = 1 << 17

    def __init__(self, ps: PointSet, singles: List[int], device,
                 stats: TableStats = None):
        check_fused(singles)
        self.singles = list(singles)
        self.device = torch.device(device)
        self.stats = TableStats() if stats is None else stats
        t0 = time.perf_counter()
        self.store = DeviceStore.from_pointset(ps, self.device)
        self.stats.device_seconds += time.perf_counter() - t0

    def raw_with_err(self, a_rows, b_rows) -> Tuple[np.ndarray, np.ndarray]:
        """[P, S] float64 raw singles and absolute error bounds; entries
        that are not finite come back as 0 with an infinite bound."""
        a_rows = np.ascontiguousarray(a_rows, dtype=np.int64)
        b_rows = np.ascontiguousarray(b_rows, dtype=np.int64)
        n = len(a_rows)
        S = len(self.singles)
        if n == 0:
            return np.zeros((0, S)), np.zeros((0, S))
        t0 = time.perf_counter()
        launches0 = pair_stats.launches
        st = self.store
        idx = torch.from_numpy(np.concatenate([a_rows, b_rows])).to(self.device)
        parts = []
        for s in range(0, n, self.MAX_CHUNK):
            a = idx[s:min(n, s + self.MAX_CHUNK)]
            b = idx[n + s:n + min(n, s + self.MAX_CHUNK)]
            stats = pair_stats(st.counts, a, b)
            moments = (st.mags[a], st.mags[b], st.selfdot[a], st.selfdot[b],
                       st.stddevs[a], st.stddevs[b])
            raw = derive_singles(stats, *moments, st.lens[a], st.lens[b],
                                 st.counts.shape[1], self.singles)
            err = singles_error(stats, raw, *moments, st.counts.shape[1],
                                self.singles)
            parts.append(torch.stack([raw, err]))
        both = torch.cat(parts, dim=1).cpu().numpy()
        raw, err = both[0], both[1]
        bad = ~(np.isfinite(raw) & np.isfinite(err))
        raw[bad] = 0.0
        err[bad] = math.inf
        self.stats.tables += 1
        self.stats.pairs += n
        self.stats.launches += pair_stats.launches - launches0
        self.stats.device_seconds += time.perf_counter() - t0
        return raw, err


def device_raw_singles(ps: PointSet, a_rows, b_rows, singles,
                       host_exact_fn: Callable[[np.ndarray], np.ndarray],
                       device, stats: TableStats = None) -> np.ndarray:
    """[P, S] raw singles through the card with exact extrema.

    host_exact_fn(idx) must return the float64-oracle raw rows for the pair
    subset idx (native raw_singles_batch / features.host).  Every pair whose
    error interval could reach a per-single min or max is re-computed
    exactly and its row overwritten, so downstream normalization bounds are
    bit-identical to the host build (device_tables.py:151-180)."""
    builder = TorchDeviceTableBuilder(ps, singles, device, stats)
    raw, err = builder.raw_with_err(a_rows, b_rows)
    if not len(raw):
        return raw
    # min-candidates: pairs whose interval can reach min_k(raw_k + e_k) —
    # the true arg-extreme is provably inside this set, and (by the same
    # interval argument) no un-replaced approximate value can lie outside
    # the exact extrema, so the matrix min/max ARE the oracle bounds
    slack = 8 * err + 1e-12 * np.maximum(np.abs(raw), 1.0)
    cand = ((raw - slack) <= (raw + slack).min(axis=0)[None, :]) | \
           ((raw + slack) >= (raw - slack).max(axis=0)[None, :])
    rows = np.nonzero(cand.any(axis=1))[0]
    if len(rows):
        t0 = time.perf_counter()
        exact = host_exact_fn(rows)
        raw[rows] = exact
        builder.stats.rechecked_rows += len(rows)
        builder.stats.host_seconds += time.perf_counter() - t0
    return raw
