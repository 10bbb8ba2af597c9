"""fastcar's all-vs-query search: the host route and the route on the card.

One block of fastcar's search (meshclust2_tpu/fastcar.py:search, lines
191-300) is a flat batch of (db row, query row) pairs inside a length
window, over one point set of the block's db rows followed by its queries.
Each pair gets a keep decision (the classifier gate, c_round(prob) > 0)
and, when kept, a similarity (the regression head's sum clipped to [0, 1]).

`HostOracle` is the JAX package's host route: the native scorer where it
implements both models, else the float64 `CompiledModel` in HostScorer-
sized chunks.  It decides every pair of a pool the kernels do not take, and
every pair the card's route re-checks, so both routes print the same bytes.

`TorchDeviceSearch` is the port of meshclust2_tpu/fastcar.py:
_device_search_batches (lines 117-188): one DeviceStore a block, one
TorchDeviceUpdater for each model over it, the window pairs through the
fused pair-statistics kernel in slices (`TorchDeviceUpdater.score_sums`),
the GLM sums alone read back.  The gate is s >= positive_edge(bias); the
regression value clip(s, 0, 1).  The card's float64 differs from the
oracle's by operation order and, for pearson, d2z and euclidean_z, by the
identity form of their cancelling sums (train/device_tables.py), so a pair
goes to the oracle when:
  - its classifier sum lies within max(8 s_err, margin * max(|edge|, 1))
    of the edge;
  - its regression value's printed form, f"{100 * v:g}", could change
    within max(8 s_err, margin * max(|s|, 1)) of its sum, or the sum lies
    that near 0 or 1 (the JAX package's band is 8 * max(serr, 1e-13) for
    its double-float sums; the port takes the updater's float64 margin,
    `resolve_margins`, so that MC2_DD_MARGIN forces every pair through the
    re-check);
  - either sum is not finite.
s_err, the fused kernel's bound on a sum of a model with full-vector
singles, is 0 for any other model.

Spans (utils/clock.py): `search.upload` (the store and the updaters),
`search.sums` (the sums and their reads), `search.recheck` (the oracle's
re-checks).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..features import host as H
from ..kmer.counting import PointSet
from ..model import thresholds as TH
from ..model.classifier import CompiledModel
from ..utils.clock import span
from .device_store import DeviceStore
from .device_update import TorchDeviceUpdater
from .engine import HostScorer, c_round


class HostOracle:
    """The host route's scorers over a block's combined point set
    (meshclust2_tpu/fastcar.py:251-289), built at first use."""

    def __init__(self, combined: PointSet, model_c: Optional[CompiledModel],
                 model_r: Optional[CompiledModel]):
        from ..native import NativeScorer

        self.ps = combined
        self.model_c = model_c
        self.model_r = model_r
        self.native_ok = all(m is None or NativeScorer.supports(m)
                             for m in (model_c, model_r))
        self._native = {}

    def _scorer(self, model: CompiledModel):
        from ..native import NativeScorer

        key = id(model)
        if key not in self._native:
            self._native[key] = NativeScorer.create(self.ps, model)
        return self._native[key]

    def _chunked(self, fn, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        out = np.empty(len(a))
        CH = HostScorer.CHUNK
        for s in range(0, len(a), CH):
            out[s:s + CH] = fn(H.side_from_pointset(self.ps, a[s:s + CH]),
                               H.side_from_pointset(self.ps, b[s:s + CH]))
        return out

    def keep(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """The classifier gate, c_round(prob) > 0."""
        if self.native_ok:
            prob, _ = self._scorer(self.model_c).score(a, b)
        else:
            prob = self._chunked(lambda x, y: self.model_c.score(x, y)[0], a, b)
        return c_round(prob) > 0

    def value(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """The regression head's sum clipped to [0, 1]."""
        if self.native_ok:
            sums, _ = self._scorer(self.model_r).score(a, b, raw_sum=True)
            return np.clip(sums, 0.0, 1.0)
        return self._chunked(self.model_r.regression_value, a, b)


def host_search(oracle: HostOracle, a: np.ndarray, b: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(keep, sim) of every pair by the oracle alone."""
    keep = (oracle.keep(a, b) if oracle.model_c is not None
            else np.ones(len(a), dtype=bool))
    sim = np.ones(len(a))
    if oracle.model_r is not None and keep.any():
        sel = np.nonzero(keep)[0]
        sim = np.zeros(len(a))
        sim[sel] = oracle.value(a[sel], b[sel])
    return keep, sim


def printed_may_differ(s: np.ndarray, eps) -> np.ndarray:
    """Sums s whose printed similarity f"{100 * clip(x, 0, 1):g}" may
    differ for some x within eps of s, and those within eps of 0 or 1 or
    not finite.  %g keeps six significant digits, so the printed value of
    y = 100 x in [10^e, 10^(e+1)) changes where y / 10^(e-5) crosses a
    half-integer; the test runs over twice the band, a superset."""
    s = np.asarray(s, dtype=np.float64)
    eps = 2 * np.asarray(eps, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        lo = 100 * np.clip(s - eps, 0.0, 1.0)
        hi = 100 * np.clip(s + eps, 0.0, 1.0)
        e_lo = np.floor(np.log10(lo))
        e_hi = np.floor(np.log10(hi))
        q = 10.0 ** (e_hi - 5)
        crosses = np.floor(lo / q + 0.5) != np.floor(hi / q + 0.5)
    return (~np.isfinite(s) | (lo <= 0) | (hi >= 100) | (e_lo != e_hi)
            | crosses)


def _sums(upd: TorchDeviceUpdater, a: np.ndarray, b: np.ndarray):
    """(s, s_err) of the pairs; s_err is read back only for a model with
    full-vector singles (0 for any other).  The span `search.sums`, its
    reads included."""
    with span("search.sums"):
        if upd.full:
            return upd.score_sums(a, b, with_err=True)
        return upd.score_sums(a, b), 0.0


class TorchDeviceSearch:
    """The window pairs of one block on the card, over one DeviceStore of
    the block's combined point set.  Raises DeviceLoopUnsupported for a
    model that the device loops do not take (plane singles, or a single
    with no device implementation), or a pool the store does not take
    (callers route those by ops/device_features.py:loop_refusal and
    device_store.store_refusal first)."""

    def __init__(self, combined: PointSet, model_c: Optional[CompiledModel],
                 model_r: Optional[CompiledModel], device):
        with span("search.upload"):
            store = DeviceStore.from_pointset(combined, device)
            self.upd_c = TorchDeviceUpdater(model_c, store) if model_c else None
            self.upd_r = TorchDeviceUpdater(model_r, store) if model_r else None
        self.rechecked_c = 0
        self.rechecked_r = 0

    def search(self, a: np.ndarray, b: np.ndarray, oracle: HostOracle
               ) -> Tuple[np.ndarray, np.ndarray]:
        """(keep, sim) of pairs (a[i], b[i]), as `host_search` gives them."""
        keep = np.ones(len(a), dtype=bool)
        if self.upd_c is not None:
            s, s_err = _sums(self.upd_c, a, b)
            edge = TH.positive_edge(self.upd_c.model.bias)
            keep = s >= edge
            thr = np.maximum(8 * s_err, self.upd_c.margin * max(abs(edge), 1.0))
            unc = ~np.isfinite(s) | (np.abs(s - edge) <= thr)
            idx = np.nonzero(unc)[0]
            if len(idx):
                with span("search.recheck"):
                    keep[idx] = oracle.keep(a[idx], b[idx])
            self.rechecked_c += len(idx)
        sim = np.ones(len(a))
        if self.upd_r is not None and keep.any():
            sel = np.nonzero(keep)[0]
            s_r, s_err = _sums(self.upd_r, a[sel], b[sel])
            vals = np.clip(s_r, 0.0, 1.0)
            eps = np.maximum(8 * s_err,
                             self.upd_r.margin * np.maximum(np.abs(s_r), 1.0))
            idx = np.nonzero(printed_may_differ(s_r, eps))[0]
            if len(idx):
                with span("search.recheck"):
                    vals[idx] = oracle.value(a[sel[idx]], b[sel[idx]])
            self.rechecked_r += len(idx)
            sim = np.zeros(len(a))
            sim[sel] = vals
        return keep, sim
