"""The update/merge phase's batches on the card.

The port of meshclust2_tpu/cluster/device_update.py:DeviceUpdater (lines
66-550), with its public surface and return contracts: `filter_closest`
(one call per update iteration: the classifier filter of every center
against its neighbourhood, then each center's closest-to-mean over the kept
members), `merge_segmented` (the merge pass's decisions and per-center best
candidate), the `scored_pairs` / `rechecked_pairs` counters and
`prof_line()`.  In the place of `score_sum_dist` and its `last_serr`,
`score_sums` gives fastcar's search (cluster/device_search.py) the GLM
sums alone, in slices.  MeanShiftEngine drives it through a session's
`updater` (cluster/engine.py:671-677, 801-839, 900-935) and re-checks on
the host whatever a call marks uncertain.

Decisions come from the float64 GLM sum against the exact float64 edges of
meshclust2_tpu/model/thresholds.py (`nonzero_bands`, `merge_band`); a pair
whose sum lies within `margin * max(|edge|, 1)` of an edge is uncertain.
The margins are the JAX package's (`resolve_margins`: 1e-8, ties 1e-12,
`MC2_DD_MARGIN` / `MC2_DD_TIE_MARGIN`).  For the statistics-derived singles
the card's float64 differs from the host oracle only by operation order,
so the TPU version's double-float error terms have no counterpart here;
the fused kernel's bounds s_err and dist_err (0 for a model without
full-vector singles) widen the bands to at least 8 s_err and 8 dist_err,
as the JAX version takes its own (`_band_device`, the merge pass's
near-tie guard); with full-vector singles an exact merge tie needs equal
candidate rows.

Dropped as TPU artefacts: the pair and segment buckets, the `valid`
padding, the MAX_ITER_PAIRS / MAX_PAIR_CHUNK splits and the jit cache.
Each call uploads its index arrays in one copy and reads its results back
in one copy.
"""
from __future__ import annotations

import os
import time
from typing import List, Tuple

import numpy as np
import torch

from ..model import thresholds as TH
from ..model.classifier import CompiledModel, model_to_torch
from ..ops.closest_mean import closest_mean
from ..ops.device_features import check_fused
from ..ops.pair_stats import has_vector, pair_stats_decision
from .device_loop import resolve_margins
from .device_store import DeviceStore

# pairs a launch of `score_sums` (fastcar's search slices)
SEARCH_SLICE = 1 << 24


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
        # a model with full-vector singles: an exact tie needs equal rows
        self.full = has_vector(self.params)
        self.margin, self.tie_margin = resolve_margins(margin, tie_margin)
        self.band0 = TH.nonzero_bands(model.bias)   # c_round(prob) != 0
        self.band1 = TH.merge_band(model.bias)      # c_round(prob) == 1
        self._reset_counters()

    def _reset_counters(self) -> None:
        self.scored_pairs = 0
        self.rechecked_pairs = 0
        # MC2_DEVICE_PROF accounting (host wall time, each call ends in a sync)
        self.t_score = 0.0
        self.t_closest = 0.0
        self.n_score = 0
        self.n_closest = 0
        # the largest segment of a filter_closest call, positions and kept
        # rows (counted under MC2_DEVICE_PROF only: ~0.5 ms of host time a
        # call at 100,000 pairs)
        self.max_segment = 0
        self.max_kept = 0

    def prof_line(self) -> str:
        return (f"device update: score {self.t_score:.2f}s/{self.n_score} "
                f"calls, closest {self.t_closest:.2f}s/{self.n_closest} "
                f"calls, {self.scored_pairs} pairs "
                f"({self.rechecked_pairs} host-rechecked), largest segment "
                f"{self.max_segment} positions, {self.max_kept} kept")

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

    def _band(self, dec: torch.Tensor, band) -> Tuple[torch.Tensor, torch.Tensor]:
        """(in-band, uncertain) masks of the float64 sums dec[0] against
        [lo, hi) (device_update.py:_band_decide); uncertain within
        max(8 s_err, margin * max(|edge|, 1)) of an edge (_band_device)."""
        s = dec[0]
        lo, hi = band
        inb = torch.ones_like(s, dtype=torch.bool)
        unc = torch.zeros_like(inb)
        for edge, ge in ((lo, True), (hi, False)):
            if np.isfinite(edge):
                inb &= (s >= edge) if ge else (s < edge)
                thr = torch.clamp(8 * dec[3], min=self.margin * max(abs(edge), 1.0))
                unc |= (s - edge).abs() <= thr
            elif (edge == -np.inf) != ge:
                # hi == -inf or lo == +inf: the band is empty
                inb.zero_()
        return inb, unc

    # -- batches ------------------------------------------------------------

    def score_sums(self, a_rows, b_rows, slice_pairs: int = SEARCH_SLICE,
                   with_err: bool = False):
        """The float64 GLM sums of pairs (a_rows[i], b_rows[i]) in the
        reference's argument order, in launches of at most `slice_pairs`
        pairs: each uploads its slice's indices, runs the fused kernel and
        reads back s only (with_err: (s, s_err), the sums' absolute bounds,
        0 without full-vector singles).  A slice holds ~80 bytes a pair on
        the card (indices 16, statistics 24, decisions 40).  A decision
        from them is trusted only outside max(8 s_err, margin) of an
        edge."""
        a = np.asarray(a_rows, dtype=np.int64)
        b = np.asarray(b_rows, dtype=np.int64)
        out = np.empty((2, len(a)))
        rows = slice(0, 4, 3) if with_err else slice(0, 1)   # s (and s_err)
        t0 = time.perf_counter()
        for s in range(0, len(a), slice_pairs):
            ai, bi = self._upload(a[s:s + slice_pairs], b[s:s + slice_pairs])
            _, dec = pair_stats_decision(self.store, self.params, ai, bi)
            got = dec[rows].cpu().numpy()
            out[:len(got), s:s + len(ai)] = got
            self.n_score += 1
        self.scored_pairs += len(a)
        self.t_score += time.perf_counter() - t0
        return (out[0], out[1]) if with_err else out[0]

    def filter_keep(self, a_idx: torch.Tensor, b: torch.Tensor):
        """The filter's decisions on the card, no read-back: the fused
        kernel on the pairs (a_idx[p] = the center, b[p] = the member) and
        the band test.  Returns (keep [P], keep uncertain [P]).  The phase
        updater (cluster/device_phase.py) calls it, then its own
        closest-to-mean and candidates launch."""
        _, dec = pair_stats_decision(self.store, self.params, a_idx, b)
        inb, unc = self._band(dec, self.band0)
        return ~inb, unc

    def filter_device(self, a_idx: torch.Tensor, b: torch.Tensor,
                      sg: torch.Tensor, C: int):
        """The device half of `filter_closest`, tensors in and out, no
        read-back: `filter_keep`, then closest_mean over the C segments sg
        (nondecreasing).  Returns (keep [P], keep uncertain [P], first [C]
        with P = no kept member, closest uncertain [C]) on the card."""
        st = self.store
        keep, unc = self.filter_keep(a_idx, b)
        first, cunc = closest_mean(st.counts, st.mags, b, sg, keep, C,
                                   maxc=st.maxc, tie_margin=self.tie_margin)
        return keep, unc, first, cunc

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
        cen, b, sg = self._upload(cen_rows, b_rows, seg)
        keep, unc, first, cunc = self.filter_device(cen[sg], b, sg, C)
        buf = torch.cat([first.view(torch.uint8), keep.view(torch.uint8),
                         unc.view(torch.uint8), cunc.view(torch.uint8)]
                        ).cpu().numpy()
        self.scored_pairs += P
        self.t_closest += time.perf_counter() - t0
        self.n_closest += 1
        if os.environ.get("MC2_DEVICE_PROF"):
            seg = np.asarray(seg)
            self.max_segment = max(self.max_segment, int(np.bincount(seg).max()))
            self.max_kept = max(self.max_kept, int(np.bincount(
                seg, weights=buf[8 * C:8 * C + P]).max()))
        return (buf[8 * C:8 * C + P].view(bool),
                buf[8 * C + P:8 * C + 2 * P].view(bool),
                buf[:8 * C].view(np.int64),
                buf[8 * C + 2 * P:].view(bool))

    def merge_device(self, a_idx: torch.Tensor, b_idx: torch.Tensor,
                     sg: torch.Tensor, C: int, valid=None):
        """The device half of `merge_segmented`, tensors in and out, no
        read-back: candidate pairs (a_idx[p] = the candidate's center,
        b_idx[p] = the center of segment sg[p]); `valid` (bool [P]) masks
        out positions that are no candidates.  Returns (pair uncertain
        [P], any res1 [C], best position [C] with -1 = none, ambiguous
        [C]) on the card.  The phase updater (cluster/device_phase.py)
        calls it too."""
        st = self.store
        P = len(a_idx)
        stats, dec = pair_stats_decision(st, self.params, a_idx, b_idx)
        dist = dec[2]
        res1, unc = self._band(dec, self.band1)
        if valid is not None:
            res1 &= valid
            unc &= valid
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
        # the bounds of the candidate and of the segment's largest
        # (meshclust2_tpu/cluster/device_update.py:422-430)
        derr = dec[4]
        emax = torch.zeros(C, **f64).scatter_reduce(
            0, sg, torch.where(res1, derr, 0.0), "amax")[sg]
        thr = torch.fmax(8 * (derr + emax), self.tie_margin * dmax.abs().clamp(min=1.0))
        near = res1 & ((d - dmax).abs() <= thr)
        if self.full:
            # the statistics and moments do not determine a full-vector
            # single: a near candidate's row must equal the best's (every
            # other position compares the best's row with itself)
            a_chk = torch.where(near & same, a_idx, a_best)
            same &= _rows_equal(st.counts, a_chk, a_best)
        amb = torch.zeros(C, **i64).scatter_reduce(
            0, sg, (near & ~same).to(torch.int64), "amax") > 0
        return unc, any_m, best, amb

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
        cen, j, sg = self._upload(cen_rows, jj, seg)
        unc, any_m, best, amb = self.merge_device(cen[j], cen[sg], sg, C)
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


# rows a slice of `_rows_equal` compares (bounds its [slice, D] gathers)
_EQ_SLICE = 1 << 15


def _rows_equal(counts: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """counts[a[p]] == counts[b[p]] in every bin, per p, compared as the
    stored bits (CUDA has no uint16 gather: uint16 rows as int16), in
    slices of _EQ_SLICE positions."""
    src = counts.view(torch.int16) if counts.dtype == torch.uint16 else counts
    out = torch.empty(len(a), dtype=torch.bool, device=counts.device)
    for s in range(0, len(a), _EQ_SLICE):
        e = s + _EQ_SLICE
        out[s:e] = (src[a[s:e]] == src[b[s:e]]).all(dim=1)
    return out
