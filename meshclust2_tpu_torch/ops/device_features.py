"""Pair scoring on the card, with exact float64 re-checks.

The counterpart of meshclust2_tpu/ops/device_features.py:DeviceScorer (lines
433-507) in its fused configuration: every batch, block-vs-one-center or
row-vs-row, goes through one launch of the fused pair-statistics kernel
(ops/pair_stats.py:pair_stats_decision: the statistics, the full-vector
singles where the model has them, `derive_singles` and the classifier
epilogue in float64 on the device).  Pairs whose decision or ranking the
device's rounding could change are re-scored by the float64 host oracle
(`HostScorer`), so clustering decisions equal the host's.

The device paths take every single of model/classifier.py:SINGLE_CODES.
A model with any other (markov, sim_mm, rre_k_r, spearman, d2s, d2*, afd,
n2r/n2rc/n2rrc: the JAX package's plane singles) is refused by
`check_fused`; the CLI and fastcar send it to the host scorer first
(`model_refusal`).

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
from ..model.classifier import SINGLE_CODES, CompiledModel, model_to_torch
from .pair_stats import pair_stats_decision

# the singles the device paths compute: those the kernel derives from its
# (sum-min, dot, EMD) plus per-row moments, and the full-vector ones it sums
# over the two rows (meshclust2_tpu/cluster/device_loop.py:57-82)
DEVICE_SINGLES = frozenset(SINGLE_CODES)

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
# does not protect.  The device's float64 values of the statistics-derived
# singles differ from the host oracle's only by rounding in another
# operation order (~1e-15 relative), so two dists further apart than
# 1e-9 * max(|max|, 1) rank alike on both, and exact ties (equal inputs)
# always fall inside the band.  The fused kernel's bounds s_err and
# dist_err (0 without full-vector singles) widen each rule's band to at
# least 8 times them.
DIST_TIE_BAND = 1e-9


def model_refusal(singles) -> Optional[str]:
    """Why the device paths do not take a model with these singles (it has
    singles without a device implementation), or None when they do."""
    bad = set(singles) - DEVICE_SINGLES
    if not bad:
        return None
    names = sorted(F.FEAT_NAMES.get(s, hex(s)) for s in bad)
    return f"features {names} have no device implementation"


def check_fused(singles) -> None:
    """Raise DeviceLoopUnsupported for a model with a single that has no
    device implementation (`model_refusal`)."""
    # imported here: device_loop imports this module
    from ..cluster.device_loop import DeviceLoopUnsupported

    why = model_refusal(singles)
    if why is not None:
        raise DeviceLoopUnsupported(why)


def recheck_mask(prob: np.ndarray, dist: np.ndarray, s_err: np.ndarray,
                 dist_err: np.ndarray) -> np.ndarray:
    """Pairs of one scoring call whose decision or rank needs the exact
    float64 oracle: rules (i), (ii) and (iii) above, with the bounds s_err
    and dist_err: rule (i)'s band is at least 8 s_err (prob moves by at
    most a quarter of s's error), rule (ii)'s at least 8 (dist_err + the
    maximum's dist_err) and rule (iii)'s at least 8 times the two
    neighbours' dist_err."""
    mask = np.abs(prob - np.floor(prob) - 0.5) < np.maximum(PROB_MARGIN, 8 * s_err)
    if len(dist):
        m = dist.max()
        scale = max(abs(m), 1.0)
        rel = np.maximum(DIST_REL_BAND * scale,
                         8 * (dist_err + dist_err[np.argmax(dist)]))
        order = np.argsort(dist, kind="stable")
        tie_band = np.maximum(DIST_TIE_BAND * scale,
                              8 * (dist_err[order[1:]] + dist_err[order[:-1]]))
        mask |= dist >= m - rel
        tie = np.diff(dist[order]) <= tie_band
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

    def _device_decision(self, a: np.ndarray, b: np.ndarray):
        """(prob, dist, s_err, dist_err) of the pairs (a[p], b[p]), b of
        length 1 for one center, in one upload and one read-back; the
        bounds are 0 for a model without full-vector singles."""
        idx = torch.from_numpy(np.concatenate([a, b])).to(self.device)
        _, dec = pair_stats_decision(self.store, self.params, idx[:len(a)],
                                     idx[len(a):])
        got = dec[1:].cpu().numpy()
        return got[0], got[1], got[2], got[3]

    def score(self, a_rows, b_rows) -> Tuple[np.ndarray, np.ndarray]:
        a = np.atleast_1d(np.asarray(a_rows, dtype=np.int64))
        b = np.atleast_1d(np.asarray(b_rows, dtype=np.int64))
        # one center: the kernel's center form
        b_dev = b if len(b) == 1 else None
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
        prob, dist, s_err, dist_err = self._device_decision(
            a, b if b_dev is None else b_dev)
        self.scored_pairs += len(a)
        idx = np.nonzero(recheck_mask(prob, dist, s_err, dist_err))[0]
        if len(idx):
            self.rechecked_pairs += len(idx)
            p2, d2 = self._host.score(a[idx], b[idx])
            prob[idx] = p2
            dist[idx] = d2
        return prob, dist
