"""Pair scoring on the card, with exact float64 re-checks.

The counterpart of meshclust2_tpu/ops/device_features.py:DeviceScorer (lines
433-507) in its fused configuration: every batch, block-vs-one-center or
row-vs-row, goes through one launch of the fused pair-statistics kernel
(ops/pair_stats.py:pair_stats_decision: the statistics, the full-vector
singles where the model has them, `derive_singles` and the classifier
epilogue in float64 on the device).  A model with plane singles (markov,
sim_mm, rre_k_r, spearman, d2s, d2*, afd, n2r/n2rc/n2rrc) takes two
launches a call: `plane_singles` over the per-pool planes of
`TorchDeviceFeatureEngine` (the counterpart of the JAX
DeviceFeatureEngine, lines 62-189), then the fused kernel's PLANE
instantiation.  Pairs whose decision or ranking the device's rounding could
change are re-scored by the float64 host oracle (`HostScorer`), so
clustering decisions equal the host's.

The scorer takes every single of model/classifier.py:SINGLE_CODES
(`scorer_refusal`); afd needs k = 2 and raises otherwise, as on the host.
The device loops (the accumulator, the updater and fastcar's search) take
the statistics-derived and full-vector singles only (`loop_refusal`), as
the JAX package's device loops and DeviceUpdater refuse the plane singles:
the CLI runs a plane model through this scorer alone, and fastcar sends it
to its host route.

MeanShiftEngine (cluster/engine.py) runs its device accumulate loop and
updater exactly when its session holds them; the scorer serves the
engine's host-driven loops.
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..cluster.device_store import DeviceStore
from ..cluster.engine import HostScorer
from ..features import flags as F
from ..features import host as H
from ..kmer.counting import PointSet
from ..model.classifier import (PLANE_SINGLES, SINGLE_CODES, STATS_SINGLES,
                                VECTOR_SINGLES, CompiledModel, model_to_torch)
from .pair_stats import pair_stats_decision
from .plane_singles import NEEDS, Planes, plane_singles, rank_dtype, table_len

# the singles the scorer computes: those the fused kernel derives from its
# (sum-min, dot, EMD) plus per-row moments, the full-vector ones it sums
# over the two rows, and the plane singles
SCORER_SINGLES = frozenset(SINGLE_CODES)
# the singles the device loops compute: the plane singles left out
# (meshclust2_tpu/cluster/device_loop.py:57-82)
LOOP_SINGLES = frozenset(STATS_SINGLES + VECTOR_SINGLES)

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


def _refusal(singles, taken) -> Optional[str]:
    bad = set(singles) - taken
    if not bad:
        return None
    names = sorted(F.FEAT_NAMES.get(s, hex(s)) for s in bad)
    return f"features {names} have no device implementation"


def scorer_refusal(singles) -> Optional[str]:
    """Why the device scorer does not take a model with these singles
    (singles it has no formula for, such as align), or None when it does."""
    return _refusal(singles, SCORER_SINGLES)


def loop_refusal(singles) -> Optional[str]:
    """Why the device loops (the accumulator, the updater, fastcar's search)
    do not take a model with these singles (plane singles or singles
    without any device implementation), or None when they do."""
    return _refusal(singles, LOOP_SINGLES)


def check_fused(singles) -> None:
    """Raise DeviceLoopUnsupported for a model that the device loops do not
    take (`loop_refusal`)."""
    # imported here: device_loop imports this module
    from ..cluster.device_loop import DeviceLoopUnsupported

    why = loop_refusal(singles)
    if why is not None:
        raise DeviceLoopUnsupported(why)


def check_scorer(singles, k: int) -> None:
    """Raise DeviceLoopUnsupported for a model that the scorer does not take
    (`scorer_refusal`), and ValueError for afd at k != 2, as the host oracle
    raises (features/host.py:afd)."""
    from ..cluster.device_loop import DeviceLoopUnsupported

    why = scorer_refusal(singles)
    if why is not None:
        raise DeviceLoopUnsupported(why)
    if F.FEAT_AFD in singles and k != 2:
        raise ValueError("AFD requires k == 2")


class LogTableMismatch(RuntimeError):
    """numpy's log of a table entry differs from its log of the same value
    inside a row: the plane store's tables would not be the host's bits."""


RANK_DTYPES = {torch.int16: np.int16, torch.int32: np.int32}


def check_logs(host_logs: np.ndarray, from_table: np.ndarray, what: str) -> None:
    """Raise LogTableMismatch unless the table's entries equal, bit for bit,
    the logs numpy forms over the rows."""
    if not np.array_equal(host_logs.view(np.int64), from_table.view(np.int64)):
        raise LogTableMismatch(f"the table's {what} differs from numpy's log "
                               f"over the rows: the plane store cannot "
                               f"promise the host's bits")


class TorchDeviceFeatureEngine:
    """The plane store of one pool: the per-row planes and tables that the
    model's plane singles read (ops/plane_singles.py:NEEDS), built on the
    host in float64 with the port's own host formulas (features/host.py:
    tiedrank, _expected_counts, markov, n2_z), in row chunks, and uploaded
    once.  Each entry is, bit for bit, the intermediate the host oracle
    forms for that row in a pair batch: markov's logs are two tables over
    every count and group sum the store's type holds, taken with numpy's
    log and checked over every row against the logs the host forms
    (`LogTableMismatch` if one differs), and spearman's rank deviations
    are stored as the integers 2 dev.  The counterpart of
    meshclust2_tpu/ops/device_features.py:DeviceFeatureEngine.__init__
    (lines 86-132) and _n2_plane (lines 174-189), which keep float32 copies.
    `seconds` is the build's host time, upload included."""

    # rows per host step: _expected_counts makes a [rows, D, k] float64
    # temporary
    ROW_CHUNK = 1024

    def __init__(self, ps: PointSet, singles, store: DeviceStore):
        t0 = time.perf_counter()
        self.flags = tuple(s for s in singles if s in PLANE_SINGLES)
        device = store.counts.device
        d = ps.dim
        names = set().union(*(NEEDS[f] for f in self.flags))
        shapes = {"markov_self": (), "rank2": (d,), "rank_ss": (), "h": (d,),
                  "n2r": (d,), "n2rc": (d,), "n2rrc": (d,)}
        host = {name: np.empty((ps.n,) + shapes[name],
                               dtype=RANK_DTYPES[rank_dtype(d)] if name == "rank2"
                               else np.float64)
                for name in names if name in shapes}
        if "log_count" in names:
            n_log = table_len(store.counts.dtype)
            with np.errstate(divide="ignore"):
                host["log_count"] = log_count = np.log(np.arange(n_log, dtype=np.float64))
                host["log_group"] = log_group = np.log(
                    np.arange(4 * (n_log - 1) + 1, dtype=np.float64))
        n2_flags = {"n2r": F.FEAT_N2R, "n2rc": F.FEAT_N2RC, "n2rrc": F.FEAT_N2RRC}
        for s in range(0, ps.n, self.ROW_CHUNK):
            rows = np.arange(s, min(ps.n, s + self.ROW_CHUNK))
            side = H.side_from_pointset(ps, rows)
            c = side.counts
            if "log_count" in names:
                ci = ps.counts[rows].astype(np.int64)
                gi = ci.reshape(len(rows), d // 4, 4).sum(axis=2)
                check_logs(np.log(c), log_count[ci], "log c")
                check_logs(np.log(c.reshape(len(rows), d // 4, 4).sum(axis=2)),
                           log_group[gi], "log of a group sum")
            if "markov_self" in names:
                host["markov_self"][rows] = H.markov(side, side)
            if "rank2" in names:
                dev = H.tiedrank(c) - (d + 1) / 2.0
                host["rank2"][rows] = 2 * dev       # exact integers
                host["rank_ss"][rows] = (dev * dev).sum(axis=1)
            if "h" in names:
                host["h"][rows] = c - H._expected_counts(side)[0]
            for name, flag in n2_flags.items():
                if name in names:
                    host[name][rows] = H.n2_z(H.n2_vector(flag, c, ps.k))

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        self.planes = Planes(
            counts=store.counts, mags=store.mags,
            real_mags=up((ps.mags - d).astype(np.float64)),
            one_mers=up(ps.one_mers.astype(np.float64)), k=ps.k,
            **{name: up(a) for name, a in host.items()})
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.seconds = time.perf_counter() - t0


def recheck_rules(prob: np.ndarray, dist: np.ndarray, s_err: np.ndarray,
                  dist_err: np.ndarray, margin: float = 0.0):
    """The pairs of one scoring call that each of rules (i), (ii) and (iii)
    above sends to the exact float64 oracle, as three masks, with the
    bounds s_err and dist_err: rule (i)'s band is at least 8 s_err (prob
    moves by at most a quarter of s's error), rule (ii)'s at least 8
    (dist_err + the maximum's dist_err) and rule (iii)'s at least 8 times
    the two neighbours' dist_err.  `margin` (the scorer's MC2_DD_MARGIN,
    cluster/device_loop.py:resolve_margins) widens rule (i)'s band to at
    least itself and rule (ii)'s to at least itself times the scale: a
    forced wide margin sends more pairs to the oracle, and the default
    1e-8 lies below both constants."""
    near_edge = np.abs(prob - np.floor(prob) - 0.5) < np.maximum(
        max(PROB_MARGIN, margin), 8 * s_err)
    near_max = np.zeros(len(dist), dtype=bool)
    tied = np.zeros(len(dist), dtype=bool)
    if len(dist):
        m = dist.max()
        scale = max(abs(m), 1.0)
        rel = np.maximum(max(DIST_REL_BAND, margin) * scale,
                         8 * (dist_err + dist_err[np.argmax(dist)]))
        order = np.argsort(dist, kind="stable")
        tie_band = np.maximum(DIST_TIE_BAND * scale,
                              8 * (dist_err[order[1:]] + dist_err[order[:-1]]))
        near_max = dist >= m - rel
        tie = np.diff(dist[order]) <= tie_band
        tied[order[1:][tie]] = True
        tied[order[:-1][tie]] = True
    return near_edge, near_max, tied


def recheck_mask(prob: np.ndarray, dist: np.ndarray, s_err: np.ndarray,
                 dist_err: np.ndarray, margin: float = 0.0) -> np.ndarray:
    """The pairs of one scoring call that any rule sends to the oracle
    (`recheck_rules`)."""
    near_edge, near_max, tied = recheck_rules(prob, dist, s_err, dist_err, margin)
    return near_edge | near_max | tied


class TorchDeviceScorer:
    """Scorer protocol (cluster/engine.py:Scorer) over the pair-statistics
    kernel (and, for a model with plane singles, the plane-singles kernel
    over the pool's planes, `engine`), with float64 host re-checks of
    borderline pairs."""

    def __init__(self, ps: PointSet, model: CompiledModel, device,
                 store: Optional[DeviceStore] = None):
        check_scorer(model.singles, ps.k)
        self.ps = ps
        self.model = model
        self.device = torch.device(device)
        self.store = (DeviceStore.from_pointset(ps, self.device)
                      if store is None else store)
        self.params = model_to_torch(model, self.device)
        self.engine: Optional[TorchDeviceFeatureEngine] = None
        if any(s in PLANE_SINGLES for s in model.singles):
            self.engine = TorchDeviceFeatureEngine(ps, model.singles, self.store)
        # imported here: device_loop imports this module
        from ..cluster.device_loop import resolve_margins

        self.margin = resolve_margins(None, None)[0]
        self._host = HostScorer(ps, model)
        self.scored_pairs = 0
        self.rechecked_pairs = 0
        # pairs each of rules (i), (ii), (iii) sent to the oracle (a pair
        # may count under several), and the host seconds of the re-checks
        self.rechecked_by_rule = np.zeros(3, dtype=np.int64)
        self.recheck_seconds = 0.0

    def warm_up(self) -> None:
        """Build the kernels and run them once, so that a timed window that
        follows holds scoring only."""
        self._device_decision(np.zeros(1, np.int64), np.zeros(1, np.int64))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _device_decision(self, a: np.ndarray, b: np.ndarray):
        """(prob, dist, s_err, dist_err) of the pairs (a[p], b[p]), b of
        length 1 for one center, in one upload and one read-back; the
        bounds are 0 for a model without full-vector or plane singles."""
        idx = torch.from_numpy(np.concatenate([a, b])).to(self.device)
        a_t, b_t = idx[:len(a)], idx[len(a):]
        plane = None
        if self.engine is not None:
            plane = plane_singles(self.engine.planes, a_t, b_t, self.engine.flags)
        _, dec = pair_stats_decision(self.store, self.params, a_t, b_t, plane)
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
        rules = recheck_rules(prob, dist, s_err, dist_err, self.margin)
        self.rechecked_by_rule += [int(r.sum()) for r in rules]
        idx = np.nonzero(rules[0] | rules[1] | rules[2])[0]
        if len(idx):
            self.rechecked_pairs += len(idx)
            t0 = time.perf_counter()
            p2, d2 = self._host.score(a[idx], b[idx])
            self.recheck_seconds += time.perf_counter() - t0
            prob[idx] = p2
            dist[idx] = d2
        return prob, dist
