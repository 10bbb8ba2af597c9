"""Pair scoring on the card, with exact float64 re-checks.

The counterpart of meshclust2_tpu/ops/device_features.py:DeviceScorer (lines
433-507) in its fused configuration: every batch, block-vs-one-center or
row-vs-row, goes through the pair-statistics kernel, then `derive_singles`
and the classifier epilogue in float64 on the device.  Pairs whose decision
or ranking the device's rounding could change are re-scored by the float64
host oracle (`HostScorer`), so clustering decisions equal the host's.

MeanShiftEngine (cluster/engine.py) runs its device accumulate loop and
updater exactly when its session holds them; the scorer serves the
engine's host-driven loops.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..cluster.device_store import DeviceStore
from ..cluster.engine import HostScorer
from ..features import flags as F
from ..kmer.counting import PointSet
from ..model.classifier import (CompiledModel, TorchModel, decision_from_raw,
                                model_to_torch)
from .pair_stats import derive_singles, pair_stats

# singles derivable from the kernel's (sum-min, dot, EMD) plus per-row
# moments (meshclust2_tpu/ops/device_features.py:39-44)
_FUSED_DERIVABLE = frozenset({
    F.FEAT_MANHATTAN, F.FEAT_EUCLIDEAN, F.FEAT_INTERSECTION,
    F.FEAT_KULCZYNSKI2, F.FEAT_SIMRATIO, F.FEAT_NORMALIZED_VECTORS,
    F.FEAT_PEARSON_COEFF, F.FEAT_D2z, F.FEAT_EUCLIDEAN_Z, F.FEAT_EMD,
    F.FEAT_LENGTHD,
})

# (i) decisions closer than this to a rounding threshold (round(prob) at
# 0.5 / 1.5) are re-checked, as in the JAX DeviceScorer
PROB_MARGIN = 2e-4
# (ii) dists within this relative band of the call's maximum are re-ranked,
# the argmax always among them (the JAX DeviceScorer's 02b47a6 contract)
DIST_REL_BAND = 1e-4
# (iii) dists within this relative band of their neighbour in the call's
# sorted dists are re-checked.  The merge pass takes a per-center argmax over
# subsets of one call (cluster/engine.py:876-890), and the accumulate
# window's same-center cache over subsets of an earlier call, which (ii)
# does not protect.  The device's float64 values differ from the host
# oracle's only by rounding in another operation order (~1e-15 relative),
# so two dists further apart than 1e-9 * max(|max|, 1) rank alike on both,
# and exact ties (equal inputs) always fall inside the band.
DIST_TIE_BAND = 1e-9


def check_fused(singles) -> None:
    """Raise DeviceLoopUnsupported unless every single derives from the
    pair statistics and per-row moments."""
    # imported here: device_loop imports this module
    from ..cluster.device_loop import DeviceLoopUnsupported

    bad = set(singles) - _FUSED_DERIVABLE
    if bad:
        names = sorted(F.FEAT_NAMES.get(s, hex(s)) for s in bad)
        raise DeviceLoopUnsupported(
            f"features {names} are not derivable from the pair statistics")


def pair_decision(store: DeviceStore, params: TorchModel, singles,
                  a_idx: torch.Tensor, b_idx: torch.Tensor,
                  stats: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(GLM sum, prob, dist), each float64 [P] on the store's device, for
    pairs (a_idx[p], b_idx[p]): the pair-statistics kernel (unless `stats`
    are given), `derive_singles` and the classifier epilogue."""
    st = store
    if stats is None:
        stats = pair_stats(st.counts, a_idx, b_idx)
    raw = derive_singles(
        stats, st.mags[a_idx], st.mags[b_idx], st.selfdot[a_idx],
        st.selfdot[b_idx], st.stddevs[a_idx], st.stddevs[b_idx],
        st.lens[a_idx], st.lens[b_idx], st.counts.shape[1], singles)
    return decision_from_raw(params, raw)


def recheck_mask(prob: np.ndarray, dist: np.ndarray) -> np.ndarray:
    """Pairs of one scoring call whose decision or rank needs the exact
    float64 oracle: rules (i), (ii) and (iii) above."""
    mask = np.abs(prob - np.floor(prob) - 0.5) < PROB_MARGIN
    if len(dist):
        m = dist.max()
        scale = max(abs(m), 1.0)
        mask |= dist >= m - DIST_REL_BAND * scale
        order = np.argsort(dist, kind="stable")
        tie = np.diff(dist[order]) <= DIST_TIE_BAND * scale
        mask[order[1:][tie]] = True
        mask[order[:-1][tie]] = True
    return mask


class TorchDeviceScorer:
    """Scorer protocol (cluster/engine.py:Scorer) over the pair-statistics
    kernel, with float64 host re-checks of borderline pairs."""

    def __init__(self, ps: PointSet, model: CompiledModel, device,
                 store: Optional[DeviceStore] = None):
        check_fused(model.singles)
        self.ps = ps
        self.model = model
        self.device = torch.device(device)
        self.store = (DeviceStore.from_pointset(ps, self.device)
                      if store is None else store)
        self.params = model_to_torch(model, self.device)
        self._host = HostScorer(ps, model)
        self.scored_pairs = 0
        self.rechecked_pairs = 0

    def warm_up(self) -> None:
        """Build the kernel and run it once, so that a timed window that
        follows holds scoring only."""
        self._device_decision(np.zeros(1, np.int64), np.zeros(1, np.int64))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _device_decision(self, a: np.ndarray, b: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray]:
        ai = torch.from_numpy(a).to(self.device)
        bi = torch.from_numpy(b).to(self.device)
        _, prob, dist = pair_decision(self.store, self.params,
                                      self.model.singles, ai, bi)
        both = torch.stack([prob, dist]).cpu().numpy()
        return both[0], both[1]

    def score(self, a_rows, b_rows) -> Tuple[np.ndarray, np.ndarray]:
        a = np.atleast_1d(np.asarray(a_rows, dtype=np.int64))
        b = np.atleast_1d(np.asarray(b_rows, dtype=np.int64))
        if len(b) == 1 and len(a) > 1:
            b = np.broadcast_to(b, a.shape)
        if len(a) == 1 and len(b) > 1:
            a = np.broadcast_to(a, b.shape)
        if a.shape != b.shape or a.ndim != 1:
            raise ValueError(f"row arrays {a.shape} and {b.shape} do not pair")
        if len(a) == 0:
            return np.empty(0), np.empty(0)
        a = np.ascontiguousarray(a)
        b = np.ascontiguousarray(b)
        lo = min(a.min(), b.min())
        hi = max(a.max(), b.max())
        if lo < 0 or hi >= self.ps.n:
            raise IndexError(f"row index out of [0, {self.ps.n}): {lo}..{hi}")
        prob, dist = self._device_decision(a, b)
        self.scored_pairs += len(a)
        idx = np.nonzero(recheck_mask(prob, dist))[0]
        if len(idx):
            self.rechecked_pairs += len(idx)
            p2, d2 = self._host.score(a[idx], b[idx])
            prob[idx] = p2
            dist[idx] = d2
        return prob, dist
