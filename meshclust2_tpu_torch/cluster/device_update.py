"""The update/merge phase's batches on the card.

The port of meshclust2_tpu/cluster/device_update.py:DeviceUpdater (lines
66-550), with its public surface and return contracts: `filter_closest`
(one call per update iteration: the classifier filter of every center
against its neighbourhood, then each center's closest-to-mean over the kept
members), `merge_segmented` (the merge pass's decisions and per-center best
candidate), `score_sum_dist`, the `scored_pairs` / `rechecked_pairs`
counters and `prof_line()`.  MeanShiftEngine drives it through a session's
`updater` (cluster/engine.py:671-677, 801-839, 900-935) and re-checks on
the host whatever a call marks uncertain.

Decisions come from the float64 GLM sum against the exact float64 edges of
meshclust2_tpu/model/thresholds.py (`nonzero_bands`, `merge_band`); a pair
whose sum lies within `margin * max(|edge|, 1)` of an edge is uncertain.
The margins are the JAX package's (`resolve_margins`: 1e-8, ties 1e-12,
`MC2_DD_MARGIN` / `MC2_DD_TIE_MARGIN`).  The card's float64 differs from
the host oracle only by operation order, so the double-float error terms of
the TPU version are zero here (`last_serr`).

Dropped as TPU artefacts: the pair and segment buckets, the `valid`
padding, the MAX_ITER_PAIRS / MAX_PAIR_CHUNK splits and the jit cache.
Each call uploads its index arrays in one copy and reads its results back
in one copy.
"""
from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np
import torch

from ..model import thresholds as TH
from ..model.classifier import CompiledModel, model_to_torch
from ..ops.closest_mean import closest_mean
from ..ops.device_features import check_fused, pair_decision
from ..ops.pair_stats import pair_stats
from .device_loop import resolve_margins
from .device_store import DeviceStore


class TorchDeviceUpdater:
    """Batched filter, closest-to-mean and merge decisions for the update
    phase, over a shared DeviceStore."""

    def __init__(self, model: CompiledModel, store: DeviceStore,
                 margin=None, tie_margin=None):
        check_fused(model.singles)
        self.model = model
        self.store = store
        self.device = store.counts.device
        self.params = model_to_torch(model, self.device)
        self.margin, self.tie_margin = resolve_margins(margin, tie_margin)
        self.band0 = TH.nonzero_bands(model.bias)   # c_round(prob) != 0
        self.band1 = TH.merge_band(model.bias)      # c_round(prob) == 1
        self.last_serr = np.zeros(0)
        self._reset_counters()

    def _reset_counters(self) -> None:
        self.scored_pairs = 0
        self.rechecked_pairs = 0
        # MC2_DEVICE_PROF accounting (host wall time, each call ends in a sync)
        self.t_score = 0.0
        self.t_closest = 0.0
        self.n_score = 0
        self.n_closest = 0

    def prof_line(self) -> str:
        return (f"device update: score {self.t_score:.2f}s/{self.n_score} "
                f"calls, closest {self.t_closest:.2f}s/{self.n_closest} "
                f"calls, {self.scored_pairs} pairs "
                f"({self.rechecked_pairs} host-rechecked)")

    def warm_up(self) -> None:
        """Build both kernels and run one call of each batch, so that a
        timed window that follows holds clustering only; the counters
        start from zero afterwards."""
        z = np.zeros(1, np.int64)
        self.filter_closest(z, z, z, 1)
        self.merge_segmented(np.zeros(2, np.int64), np.ones(1, np.int64), z, 1)
        self._reset_counters()

    # -- helpers ------------------------------------------------------------

    def _upload(self, *arrays: np.ndarray) -> List[torch.Tensor]:
        """int64 index arrays -> device tensors, in one host-to-device copy."""
        flat = np.concatenate([np.asarray(a, dtype=np.int64) for a in arrays])
        dev = torch.from_numpy(flat).to(self.device)
        return list(torch.split(dev, [len(a) for a in arrays]))

    def _band(self, s: torch.Tensor, band) -> Tuple[torch.Tensor, torch.Tensor]:
        """(in-band, uncertain) masks of float64 sums s against [lo, hi)
        (device_update.py:_band_decide)."""
        lo, hi = band
        inb = torch.ones_like(s, dtype=torch.bool)
        unc = torch.zeros_like(inb)
        for edge, ge in ((lo, True), (hi, False)):
            if np.isfinite(edge):
                inb &= (s >= edge) if ge else (s < edge)
                unc |= (s - edge).abs() <= self.margin * max(abs(edge), 1.0)
            elif (edge == -np.inf) != ge:
                # hi == -inf or lo == +inf: the band is empty
                inb.zero_()
        return inb, unc

    # -- batches ------------------------------------------------------------

    def score_sum_dist(self, a_rows, b_rows) -> Tuple[np.ndarray, np.ndarray]:
        """(GLM sum, dist) as float64 for pairs (a_rows[i], b_rows[i]) in the
        reference's argument order.  Decisions from them are trusted only
        outside `margin` of an edge; `last_serr` is zero (float64 on the
        card carries no double-float error term)."""
        a = np.asarray(a_rows, dtype=np.int64)
        b = np.asarray(b_rows, dtype=np.int64)
        n = len(a)
        self.last_serr = np.zeros(n)
        if n == 0:
            return np.zeros(0), np.zeros(0)
        t0 = time.perf_counter()
        ai, bi = self._upload(a, b)
        s, _, dist = pair_decision(self.store, self.params, self.model.singles,
                                   ai, bi)
        both = torch.stack([s, dist]).cpu().numpy()
        self.scored_pairs += n
        self.t_score += time.perf_counter() - t0
        self.n_score += 1
        return both[0], both[1]

    def filter_closest(self, cen_rows: np.ndarray, b_rows: np.ndarray,
                       seg: np.ndarray, C: int):
        """Update-filter keep decisions plus per-center closest-to-mean over
        the kept pairs.  Returns (keep [P], keep_uncertain [P], first [C]
        pair position into b_rows with P = no kept member,
        closest_uncertain [C]).  seg must be nondecreasing."""
        P = len(b_rows)
        if P == 0:
            return (np.zeros(0, bool), np.zeros(0, bool),
                    np.full(C, 0, np.int64), np.zeros(C, bool))
        t0 = time.perf_counter()
        st = self.store
        cen, b, sg = self._upload(cen_rows, b_rows, seg)
        s, _, _ = pair_decision(st, self.params, self.model.singles, cen[sg], b)
        inb, unc = self._band(s, self.band0)
        keep = ~inb
        first, cunc = closest_mean(st.counts, st.mags, b, sg, keep, C,
                                   maxc=st.maxc, tie_margin=self.tie_margin)
        buf = torch.cat([first.view(torch.uint8), keep.view(torch.uint8),
                         unc.view(torch.uint8), cunc.view(torch.uint8)]
                        ).cpu().numpy()
        self.scored_pairs += P
        self.t_closest += time.perf_counter() - t0
        self.n_closest += 1
        return (buf[8 * C:8 * C + P].view(bool),
                buf[8 * C + P:8 * C + 2 * P].view(bool),
                buf[:8 * C].view(np.int64),
                buf[8 * C + 2 * P:].view(bool))

    def merge_segmented(self, cen_rows: np.ndarray, jj: np.ndarray,
                        seg: np.ndarray, C: int):
        """Merge decisions for candidate pairs (center jj[p], center seg[p]):
        per-pair uncertainty of res1 = c_round(prob) == 1, plus per center
        (any res1, best candidate pair position with -1 = none, ambiguous
        ranking).  The later candidate wins exact dist ties
        (Trainer.cpp:104).  seg must be nondecreasing."""
        P = len(jj)
        if P == 0:
            return (np.zeros(0, bool), np.zeros(C, bool),
                    np.full(C, -1, np.int64), np.zeros(C, bool))
        t0 = time.perf_counter()
        st = self.store
        cen, j, sg = self._upload(cen_rows, jj, seg)
        a_idx = cen[j]
        b_idx = cen[sg]
        stats = pair_stats(st.counts, a_idx, b_idx)
        s, _, dist = pair_decision(st, self.params, self.model.singles,
                                   a_idx, b_idx, stats=stats)
        res1, unc = self._band(s, self.band1)
        f64 = dict(dtype=torch.float64, device=self.device)
        i64 = dict(dtype=torch.int64, device=self.device)
        d = torch.where(res1, dist, torch.full_like(dist, -np.inf))
        dmax = torch.full((C,), -np.inf, **f64).scatter_reduce(0, sg, d, "amax")[sg]
        pos = torch.arange(P, **i64)
        best = torch.full((C,), -1, **i64).scatter_reduce(
            0, sg, torch.where(res1 & (d == dmax), pos, -1), "amax")
        any_m = torch.zeros(C, **i64).scatter_reduce(
            0, sg, res1.to(torch.int64), "amax") > 0
        # ambiguity: a candidate within the tie margin of the best counts as
        # a safe tie only when its inputs equal the best's (the same pair
        # statistics and the same moments of the candidate row; the center
        # row is common to the segment), as the closest-to-mean tie guard
        # treats equal integers; any other near candidate sends the center
        # to the host
        bp = best.clamp(min=0)[sg]
        a_best = a_idx[bp]
        same = (stats == stats[bp]).all(dim=1)
        for m in (st.mags, st.selfdot, st.stddevs, st.lens):
            same &= m[a_idx] == m[a_best]
        near = res1 & ((d - dmax).abs() <= self.tie_margin * dmax.abs().clamp(min=1.0))
        amb = torch.zeros(C, **i64).scatter_reduce(
            0, sg, (near & ~same).to(torch.int64), "amax") > 0
        buf = torch.cat([best.view(torch.uint8), unc.view(torch.uint8),
                         any_m.view(torch.uint8), amb.view(torch.uint8)]
                        ).cpu().numpy()
        self.scored_pairs += P
        self.t_score += time.perf_counter() - t0
        self.n_score += 1
        return (buf[8 * C:8 * C + P].view(bool),
                buf[8 * C + P:8 * C + P + C].view(bool),
                buf[:8 * C].view(np.int64),
                buf[8 * C + P + C:].view(bool))
