"""Mean-shift clustering engine.

Drives the two phases of the reference algorithm (ClusterFactory.cpp:620-656):

  accumulation  — greedy sweep over the length-sorted pool: repeatedly score
                  a window of candidates around the current center, pull in
                  classifier positives, re-center on the member closest to
                  the arithmetic mean (ClusterFactory.cpp:552-610);
  update/merge  — iterative per-center re-centering over +/-delta neighbor
                  clusters and classifier-directed merging
                  (ClusterFactory.cpp:287-401,635-655).

The control flow is host-driven (it is inherently sequential and
data-dependent); all O(window x 4^k) scoring goes through a Scorer, which is
either the float64 host oracle (exact) or the batched device path
(ops/device_features.py) with exact rechecks on borderline margins.

The port's copy of meshclust2_tpu/cluster/engine.py.  The device phases
come from a session (cluster/device_session.py:TorchDeviceSession): the
accumulate loop runs on the card exactly when the session holds an
accumulator, the whole update phase when it holds a phase (the JAX
engine's hook, l. 945-1015), and the update phase's per-iteration batches
when it holds an updater (also after a guarded abort of the phase).  Left
out are the JAX package's device programs that the engine would build
itself (the sessionless accumulator and updater) and its one-dispatch
programs (the combined accumulate+update dispatch, its pending phase
result and segment relaunches).  Every host path (host accumulate, native
resolve, abort resume, native update) is the JAX package's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Protocol, Tuple

import numpy as np

from ..kmer.counting import PointSet
from ..model.classifier import CompiledModel
from ..features import host as H
from .bvec import BVec


class Scorer(Protocol):
    def score(self, a_rows: np.ndarray, b_rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(prob, dist) for pairs (a_rows[i], b_rows[i]) in that argument
        order (order matters for asymmetric features)."""
        ...


class HostScorer:
    """Exact float64 scoring via the host oracle (chunked to bound the
    [chunk, 4^k] float64 temporaries)."""

    CHUNK = 2048

    def __init__(self, ps: PointSet, model: CompiledModel):
        self.ps = ps
        self.model = model

    def score(self, a_rows, b_rows):
        a_rows = np.atleast_1d(np.asarray(a_rows))
        b_rows = np.atleast_1d(np.asarray(b_rows))
        if len(b_rows) == 1 and len(a_rows) > 1:
            b_rows = np.broadcast_to(b_rows, a_rows.shape)
        if len(a_rows) == 1 and len(b_rows) > 1:
            a_rows = np.broadcast_to(a_rows, b_rows.shape)
        n = len(a_rows)
        if n <= self.CHUNK:
            A = H.side_from_pointset(self.ps, a_rows)
            B = H.side_from_pointset(self.ps, b_rows)
            return self.model.score(A, B)
        probs = np.empty(n)
        dists = np.empty(n)
        for s in range(0, n, self.CHUNK):
            e = min(n, s + self.CHUNK)
            A = H.side_from_pointset(self.ps, a_rows[s:e])
            B = H.side_from_pointset(self.ps, b_rows[s:e])
            p, d = self.model.score(A, B)
            probs[s:e] = p
            dists[s:e] = d
        return probs, dists


class _ScoreMemo:
    """Exact cross-call score reuse for the update/merge phase.

    Scores depend only on the ordered (a, b) rows, and near convergence
    ~78% of each update iteration's (center, member) pairs repeat from the
    previous iteration (centers stabilize, memberships settle).  Keys are
    a*n + b into a sorted store; hits are returned verbatim (bit-identical),
    misses go to the wrapped scorer and join the store."""

    def __init__(self, scorer, n: int):
        self.scorer = scorer
        self.n = n
        self.scored = 0  # pairs that actually reached the wrapped scorer
        self.keys = np.empty(0, dtype=np.int64)
        self.prob = np.empty(0, dtype=np.float64)
        self.dist = np.empty(0, dtype=np.float64)

    def score(self, a_rows, b_rows):
        a = np.atleast_1d(np.asarray(a_rows, dtype=np.int64))
        b = np.atleast_1d(np.asarray(b_rows, dtype=np.int64))
        if len(b) == 1 and len(a) > 1:
            b = np.broadcast_to(b, a.shape)
        if len(a) == 1 and len(b) > 1:
            a = np.broadcast_to(a, b.shape)
        keys = a * self.n + b
        m = len(self.keys)
        if m == 0:
            prob, dist = self.scorer.score(a, b)
            self.scored += len(keys)
            self._insert(keys, prob, dist)
            return prob, dist
        pos = np.minimum(np.searchsorted(self.keys, keys), m - 1)
        hit = self.keys[pos] == keys
        prob = np.empty(len(keys), dtype=np.float64)
        dist = np.empty(len(keys), dtype=np.float64)
        prob[hit] = self.prob[pos[hit]]
        dist[hit] = self.dist[pos[hit]]
        miss = ~hit
        if miss.any():
            p, d = self.scorer.score(a[miss], b[miss])
            self.scored += int(miss.sum())
            prob[miss] = p
            dist[miss] = d
            self._insert(keys[miss], p, d)
        return prob, dist

    def _insert(self, keys, prob, dist):
        # sort only the new batch, then C-level interleave into the sorted
        # store (misses are never already present; in-batch dupes deduped)
        order = np.argsort(keys, kind="stable")
        k, p, d = keys[order], prob[order], dist[order]
        if len(k) > 1:
            keep = np.empty(len(k), dtype=bool)
            keep[:1] = True
            keep[1:] = k[1:] != k[:-1]
            if not keep.all():
                k, p, d = k[keep], p[keep], d[keep]
        pos = np.searchsorted(self.keys, k)
        self.keys = np.insert(self.keys, pos, k)
        self.prob = np.insert(self.prob, pos, p)
        self.dist = np.insert(self.dist, pos, d)


def c_round(x):
    """floor(x + 0.5): equal to C round() for the non-negative values it is
    applied to here (probabilities, means); they differ on negative halves
    (floor(-0.5+0.5)=0 vs C round(-0.5)=-1), so do not reuse on signed
    quantities."""
    return np.floor(np.asarray(x, dtype=np.float64) + 0.5)


def distance_d(counts_rows: np.ndarray, top: np.ndarray) -> np.ndarray:
    """DivergencePoint::distance_d against a double-valued mean histogram
    (DivergencePoint.cpp:54-66): 10000*(1-frac^2) with
    dist = sum 2*min(p_i, round(top_i)) and mag accumulated into a uint64_t,
    i.e. each (p_i + top_i) TRUNCATED before summing — both sums are
    integer-exact, making the value deterministic."""
    r = np.floor(top + 0.5)  # C round() for non-negative values
    dist = 2.0 * np.minimum(counts_rows, r[None, :]).sum(axis=1, dtype=np.float64)
    mag = np.trunc(counts_rows + top[None, :]).sum(axis=1, dtype=np.float64)
    frac = dist / mag
    return 10000.0 * (1.0 - frac * frac)


@dataclass
class Cluster:
    center_row: int
    members: List[int]
    deleted: bool = False


@dataclass
class EngineStats:
    windows_scored: int = 0
    pairs_scored: int = 0
    clusters_before_update: int = 0
    update_iterations: int = 0


class MeanShiftEngine:
    def __init__(
        self,
        ps: PointSet,
        model: CompiledModel,
        similarity: float,
        scorer: Optional[Scorer] = None,
        delta: int = 5,
        iterations: int = 15,
        bin_size: int = 1000,
        device_session=None,
    ):
        self.ps = ps
        self.model = model
        self.sim = similarity
        self.scorer = scorer or HostScorer(ps, model)
        self.delta = delta
        self.iterations = iterations
        self.bin_size = bin_size
        # pre-built device state (cluster/device_session.py): store already
        # uploaded, programs compiled — the clustering phases only execute
        self.device_session = device_session
        # multihost runs keep histogram rows sharded across processes and
        # fetch the few host-needed rows on demand (parallel/multihost.py)
        self.row_fetcher = None
        self.stats = EngineStats()
        self.__counts_f: Optional[np.ndarray] = None
        # same-center scan cache for the accumulate loop: when get_mean
        # re-centers onto the SAME row (common near convergence), the next
        # window scan re-scores surviving (row, center) pairs whose values
        # are already known — reuse them verbatim (exact: scores depend only
        # on the two points).  ~27% of accumulate pairs on typical pools.
        self._cache_center = -1
        self._cache_epoch = 0
        self._cache_stamp = np.zeros(ps.n, dtype=np.int64)
        self._cache_prob = np.empty(ps.n, dtype=np.float64)
        self._cache_dist = np.empty(ps.n, dtype=np.float64)

    @property
    def _counts_f(self) -> np.ndarray:
        # float64 counts are only needed on the numpy fallback paths (the
        # native argmin kernel reads the integer counts directly); built
        # lazily to avoid an 8x-width copy of the whole matrix up front
        if self.__counts_f is None:
            self.__counts_f = self.ps.counts.astype(np.float64)
        return self.__counts_f

    # ---------------- accumulation phase ----------------

    def _get_close(self, bv: BVec, center: int):
        """Trainer::get_close (Trainer.cpp:22-71) over the center's length
        window.  Returns (argmax_row, argmax_pos, is_min, marked_positions)."""
        length = int(self.ps.lengths[center])
        begin_len = int(length * self.sim)   # uint64 truncation of double product
        end_len = int(length / self.sim)
        front, back, back_empty = bv.get_range(begin_len, end_len)
        if back_empty:
            return None, None, True, front, back
        rows, bin_ids, slots = bv.window(front, back)
        if len(rows) == 0:
            return None, None, True, front, back
        lens = self.ps.lengths[rows]
        # same uint64-truncated bounds as the bin-range query above
        # (Trainer.cpp:39-47 recomputes them per candidate)
        pass_mask = (lens >= begin_len) & (lens <= end_len)
        if not pass_mask.any():
            return None, None, True, front, back
        sel = np.nonzero(pass_mask)[0]
        rsel = rows[sel]
        if (
            center == self._cache_center
            and bool((self._cache_stamp[rsel] == self._cache_epoch).all())
        ):
            prob = self._cache_prob[rsel]
            dist = self._cache_dist[rsel]
        else:
            prob, dist = self.scorer.score(rsel, np.array([center]))
            self.stats.pairs_scored += len(sel)
            self._cache_center = center
            self._cache_epoch += 1
            self._cache_stamp[rsel] = self._cache_epoch
            self._cache_prob[rsel] = prob
            self._cache_dist[rsel] = dist
        self.stats.windows_scored += 1
        pos_mask = c_round(prob) > 0
        is_min = not pos_mask.any()
        # argmax by dist, first strict max wins (sequential pmax,
        # Trainer.cpp:57)
        best_i = int(np.argmax(dist))  # np.argmax returns first max
        best_sel = int(sel[best_i])
        marked = sel[pos_mask]
        bv.mark_slots(bin_ids[marked], slots[marked])
        return (
            int(rows[best_sel]),
            (int(bin_ids[best_sel]), int(slots[best_sel])),
            is_min,
            front,
            back,
        )

    def _rows(self, rows: np.ndarray) -> np.ndarray:
        """Histogram rows as a host array — from the local matrix or, on
        multihost runs, fetched from the sharded global matrix."""
        if self.row_fetcher is not None:
            return self.row_fetcher(rows)
        return self.ps.counts[rows]

    def _get_mean(self, current: List[int]) -> int:
        """Member closest to the arithmetic mean (ClusterFactory.cpp:337-380),
        first strict minimum wins."""
        rows = np.asarray(current, dtype=np.int64)
        if self.row_fetcher is None:
            from ..native import mean_shift_argmin_batch

            res = mean_shift_argmin_batch(
                self.ps.counts, self.ps.mags, rows,
                np.array([0, len(rows)], dtype=np.int64),
            )
            if res is not None:
                return int(res[0])
        cnts = self._rows(rows)
        top = cnts.astype(np.float64).mean(axis=0)
        d = distance_d(cnts, top)
        return int(rows[int(np.argmin(d))])

    def accumulate_all(self, bv: BVec) -> List[Cluster]:
        from ..utils.progress import Progress

        prog = Progress(self.ps.n, "Accumulation")  # ClusterFactory.cpp:625
        device = self._device_accumulate(bv, prog)
        if device is not None:
            prog.end()
            self.stats.clusters_before_update = len(device)
            return device
        clusters: List[Cluster] = []
        native = self._native_accumulate(bv, prog)
        if native is not None:
            prog.end()
            self.stats.clusters_before_update = len(native)
            return native
        last = bv.pop()
        self._host_accumulate_loop(bv, prog, clusters, last, None)
        prog.end()
        self.stats.clusters_before_update = len(clusters)
        return clusters

    def _host_accumulate_loop(self, bv: BVec, prog, clusters: List[Cluster],
                              last: Optional[int],
                              current: Optional[List[int]],
                              pending_mean: bool = False) -> List[Cluster]:
        """The reference accumulate loop (ClusterFactory.cpp:552-610), entry
        at an arbitrary point so the device path can hand over mid-run:
        `current=None` starts a fresh cluster at `last`; `pending_mean=True`
        re-centers on the member mean before the first window scan."""
        while last is not None:
            if current is None:
                current = [last]
            while True:
                if pending_mean:
                    last = self._get_mean(current)
                    pending_mean = False
                best_row, best_pos, is_min, front, back = self._get_close(bv, last)
                if is_min:
                    clusters.append(Cluster(center_row=last, members=current))
                    prog.step(len(current))
                    if best_row is None:
                        last = bv.pop()
                    else:
                        last = best_row
                        bv.erase(*best_pos)
                    current = None
                    break
                current.extend(bv.remove_available(front, back))
                last = self._get_mean(current)
            # loop continues with the next center (or exits when pool empty)
        return clusters

    def _device_accumulate(self, bv: BVec, prog) -> Optional[List[Cluster]]:
        """Device-resident accumulate (cluster/device_loop.py): the phase as
        a step loop on the card.  Runs exactly when the session holds an
        accumulator (MC2_NO_DEVICE_LOOP leaves it out); returns None to fall
        through to the native/host paths.  A guarded abort (a decision
        within the margin of a threshold) resumes the float64 host loop
        from the exact abort point, so output is always bit-faithful to the
        host semantics."""
        import os

        if os.environ.get("MC2_NO_DEVICE_LOOP"):
            return None
        acc = None if self.device_session is None \
            else self.device_session.accumulator
        if acc is None:
            return None
        strict = bool(os.environ.get("MC2_DEVICE_STRICT"))
        # an accumulator over a row-sharded store has no fallback: a rank
        # that went on alone on the host would leave its peers waiting at
        # a collective
        no_fallback = strict or getattr(acc, "no_fallback", False)

        def launch(bv_, carry=None):
            return acc.run(bv_, carry=carry) if carry is not None \
                else acc.run(bv_)

        try:
            raw, state = launch(bv)
        except Exception as e:  # noqa: BLE001 - any device failure
            if no_fallback:
                raise
            print(f"device accumulate failed ({type(e).__name__}: {e}); "
                  "falling back to the host paths")
            return None
        self.stats.windows_scored += getattr(acc, "last_windows", 0)
        self.stats.pairs_scored += getattr(acc, "last_pairs", 0)
        if raw is not None:
            return [Cluster(center_row=c, members=m) for c, m in raw]
        # abort-resume: the host resolves the margin-uncertain steps with
        # the exact f64 semantics, then relaunches the device loop from that
        # point instead of finishing the whole tail on the host.  Bounded in
        # case of a margin storm (forced-margin tests want the host
        # fallback).
        max_resumes = int(os.environ.get("MC2_DEV_MAX_RESUMES", "32"))
        resumes = 0
        # resolution now runs through the native driver (~1 ms/step), so
        # resolving a batch of steps is far cheaper than an extra device
        # relaunch (~0.3-0.5 s even with diff fetches): start at 128 and
        # escalate when the device re-aborts quickly (tie-dense regions)
        host_steps = 128
        import time as _time

        while (state is not None and resumes < max_resumes
               and getattr(acc, "_ready", None) is not None):
            t_res = _time.time()
            if os.environ.get("MC2_DEVICE_PROF"):
                print(f"device accumulate: abort stage {state.stage} "
                      f"(cause {getattr(acc, 'last_abort_cause', 0)}) "
                      f"after {len(state.clusters_done)} clusters; "
                      f"host resolves {host_steps} steps")
            clusters_done, current, last, bv2 = self._resolve_steps(
                state, host_steps)
            if last is None:
                return clusters_done
            alive_rows = (np.concatenate([b for b in bv2.bins])
                          if bv2.size() else np.zeros(0, np.int64))
            carry = acc.make_carry(
                [(c.center_row, c.members) for c in clusters_done],
                current, last, alive_rows)
            if os.environ.get("MC2_DEVICE_PROF"):
                print(f"device accumulate: resolve+carry {(_time.time() - t_res):.2f}s")
            try:
                raw, state = launch(bv2, carry=carry)
            except Exception as e:  # noqa: BLE001 - any device failure
                # the resolved host state is exact: finish on the host
                if no_fallback:
                    raise
                print(f"device relaunch failed ({type(e).__name__}: {e}); "
                      "host completes")
                from .device_loop import ResumeState

                state = ResumeState(stage=1, clusters_done=[
                    (c.center_row, c.members) for c in clusters_done],
                    current_rows=current, last_row=last, bv=bv2)
                break
            self.stats.windows_scored += getattr(acc, "last_windows", 0)
            self.stats.pairs_scored += getattr(acc, "last_pairs", 0)
            resumes += 1
            # backoff: aborts arriving in bursts (tie-dense regions) are
            # cheaper to clear with a batch of exact host steps than with
            # one ~0.3-0.5 s device round trip per step — but per-step
            # host cost varies 30x with window size (1 ms at 100k, ~30 ms
            # in the 1M tie-dense tail), so budget TIME, not steps: aim
            # for ~1 s of resolution per abort
            resolve_secs = _time.time() - t_res
            rate = host_steps / max(resolve_secs, 1e-3)
            budget = int(max(16, min(4096, rate)))
            if getattr(acc, "last_steps", 0) >= 512:
                host_steps = min(128, budget)
            else:
                host_steps = min(max(4 * host_steps, 16), budget, 4096)
            if raw is not None:
                if resumes and os.environ.get("MC2_DEVICE_PROF"):
                    print(f"device accumulate: completed after {resumes} "
                          "abort-resume round trips")
                return [Cluster(center_row=c, members=m) for c, m in raw]
        if strict:
            raise RuntimeError(
                f"device accumulate aborted (stage {state.stage}) under "
                f"MC2_DEVICE_STRICT after {len(state.clusters_done)} clusters")
        # guarded abort: continue on the host from the exact state.  The
        # whole remaining tail goes through the native resumable driver in
        # ONE call when the model supports it (the per-step Python loop
        # with native scoring calls cost ~10-15 s for the 1M tail).
        print(f"device accumulate: guarded abort (stage {state.stage}); "
              f"host completes from cluster {len(state.clusters_done)}")
        resolved = self._resolve_steps_native(state, 3 * self.ps.n + 64)
        if resolved is not None:
            clusters, current, last, _bv = resolved
            assert last is None, "unbounded native resume did not finish"
            for cl in clusters:
                prog.step(len(cl.members))
        else:
            clusters = [Cluster(center_row=c, members=m)
                        for c, m in state.clusters_done]
            for cl in clusters:
                prog.step(len(cl.members))
            saved_scorer = self.scorer
            from ..native import NativeScorer

            fast = None if self.ps.counts is None \
                else NativeScorer.create(self.ps, self.model)
            self.scorer = fast or self._host_oracle()
            try:
                self._host_accumulate_loop(
                    state.bv, prog, clusters, state.last_row,
                    list(state.current_rows),
                    pending_mean=(state.stage == 2))
            finally:
                self.scorer = saved_scorer
        return clusters

    def _resolve_steps(self, state, k: int):
        """Resolve up to k accumulate steps exactly (f64 semantics) from a
        device abort point (device_loop.ResumeState).  Returns
        (clusters_done, current_rows, last_row, bv) after the steps;
        last_row None means the pool emptied and clustering is complete.

        Routed through the native resume driver when the model is
        native-supported (native/accumulate.cpp:accumulate_resume — the
        Python per-step path cost ~84 s across the 1M run's 8 abort-resume
        cycles); the Python loop below is the exact-semantics fallback."""
        native = self._resolve_steps_native(state, k)
        if native is not None:
            return native
        bv = state.bv
        clusters = [Cluster(center_row=c, members=m)
                    for c, m in state.clusters_done]
        current = list(state.current_rows)
        last = state.last_row
        if not current:
            current = [last]
        pending_mean = state.stage == 2
        for _ in range(k):
            if pending_mean:
                # the absorb already applied; closest-to-mean was uncertain
                last = self._get_mean(current)
                pending_mean = False
                continue
            # one window scan (ClusterFactory.cpp:552-610 inner step)
            best_row, best_pos, is_min, front, back = \
                self._get_close(bv, last)
            if is_min:
                clusters.append(Cluster(center_row=last, members=current))
                if best_row is None:
                    last = bv.pop()
                else:
                    last = best_row
                    bv.erase(*best_pos)
                if last is None:
                    return clusters, None, None, bv
                current = [last]
            else:
                current.extend(bv.remove_available(front, back))
                last = self._get_mean(current)
        return clusters, current, last, bv

    def _resolve_steps_native(self, state, k: int):
        """Native-driver _resolve_steps (bit-identical decisions; the
        native scorer is the proven-equal oracle).  None = use the Python
        fallback."""
        import os

        if os.environ.get("MC2_NO_NATIVE_RESOLVE"):
            return None
        if getattr(self, "_resolve_native_failed", False):
            return None
        if self.row_fetcher is not None or self.ps.counts is None:
            self._resolve_native_failed = True
            return None
        sc = getattr(self, "_resolve_native_scorer", None)
        if sc is None:
            from ..native import NativeScorer

            sc = NativeScorer.create(self.ps, self.model)
            if sc is None:
                self._resolve_native_failed = True
                return None
            self._resolve_native_scorer = sc
        current = list(state.current_rows) or [state.last_row]
        res = sc.resume(state.bv, self.sim, current, state.last_row,
                        state.stage == 2, k)
        if res is None:
            self._resolve_native_failed = True
            return None
        clusters_raw, cur, last, bins, windows, pairs = res
        self.stats.windows_scored += windows
        self.stats.pairs_scored += pairs
        clusters = [Cluster(center_row=c, members=m)
                    for c, m in state.clusters_done]
        clusters.extend(Cluster(center_row=int(c), members=m.tolist())
                        for c, m in clusters_raw)
        bv = state.bv
        if last is None:
            return clusters, None, None, bv
        bv.bins = [np.asarray(b, dtype=np.int64) for b in bins]
        bv.marks = [np.zeros(len(b), dtype=bool) for b in bins]
        return clusters, cur.tolist(), int(last), bv

    def _native_accumulate(self, bv: BVec, prog) -> Optional[List[Cluster]]:
        """One-call native accumulate driver (native/accumulate.cpp): the
        whole sequential loop — bvec queries, window scans, the same-center
        cache, scoring, closest-to-mean — without per-step Python/ctypes
        overhead.  Requires the scorer to BE the native scorer (so decisions
        are computed by the same code either way); returns None to fall back
        to the Python loop."""
        import os

        from ..native import NativeScorer

        if os.environ.get("MC2_NO_NATIVE_ACCUMULATE"):
            return None
        if type(self.scorer) is not NativeScorer:
            return None
        res = self.scorer.accumulate(bv, self.sim, progress_step=prog.step)
        if res is None:
            return None
        centers, offsets, members, windows, pairs = res
        self.stats.windows_scored += windows
        self.stats.pairs_scored += pairs
        return [
            Cluster(
                center_row=int(centers[i]),
                members=members[offsets[i]:offsets[i + 1]].tolist(),
            )
            for i in range(len(centers))
        ]

    # ---------------- update/merge phase ----------------

    def _get_device_updater(self):
        """The session's TorchDeviceUpdater, or None (host scoring)."""
        if self.device_session is None:
            return None
        return self.device_session.updater

    def _host_oracle(self):
        if not hasattr(self, "_host_oracle_cached"):
            self._host_oracle_cached = HostScorer(self.ps, self.model)
        return self._host_oracle_cached

    def _batched_mean_shift_update(self, clusters: List[Cluster], delta: int) -> List[int]:
        """All centers' re-estimations of one iteration in a single scoring
        batch (the reference's `#pragma omp parallel for` over j,
        ClusterFactory.cpp:639-641; iterations are independent because they
        read only neighbor *members*, never neighbor centers)."""
        C = len(clusters)
        # flat member table: cluster j's members occupy flat[moff[j]:moff[j+1]],
        # so each center's +/-delta neighborhood is one contiguous slice
        member_arrays = [np.asarray(c.members, dtype=np.int64) for c in clusters]
        flat = np.concatenate(member_arrays) if C else np.zeros(0, np.int64)
        moff = np.zeros(C + 1, dtype=np.int64)
        np.cumsum([len(a) for a in member_arrays], out=moff[1:])
        js = np.arange(C)
        starts = moff[np.maximum(0, js - delta)]
        ends = moff[np.minimum(C - 1, js + delta) + 1]
        per_j = ends - starts
        total = int(per_j.sum())
        seg = np.repeat(js, per_j)
        # flat indices for every (center j, neighborhood member) pair
        base = np.repeat(starts, per_j)
        offs = np.arange(total, dtype=np.int64) - np.repeat(
            np.cumsum(per_j) - per_j, per_j
        )
        b_arr = flat[base + offs]
        cen_rows = np.array([c.center_row for c in clusters], dtype=np.int64)
        cen_lens = self.ps.lengths[cen_rows]
        # length window prefilter (Trainer.cpp:125-131), uint64-truncated
        min_lens = (self.sim * cen_lens).astype(np.int64)
        max_lens = (cen_lens / self.sim).astype(np.int64)
        lens = self.ps.lengths[b_arr]
        lp = (lens >= min_lens[seg]) & (lens <= max_lens[seg])
        b_arr = b_arr[lp]
        seg = seg[lp]
        a_arr = cen_rows[seg]
        updater = self._get_device_updater()
        if updater is not None:
            # ONE fused device dispatch: filter decisions + per-center
            # closest-to-mean; margin-uncertain pairs/segments fall back to
            # the f64 host oracle below
            self.stats.pairs_scored += len(a_arr)
            return self._device_update_iter(clusters, cen_rows, b_arr, seg,
                                            delta, C)
        if len(a_arr):
            # (pairs_scored is credited by update_phase from the memo's
            # actual-miss count, so cache hits are never double-counted)
            prob, _ = self.scorer.score(a_arr, b_arr)
            keep = c_round(prob) != 0
        else:
            keep = np.zeros(0, bool)
        # per-center closest-to-mean over the kept members (batched native
        # path; numpy fallback).  seg is nondecreasing by construction, so
        # per-center slices come from boundaries, not full-array masks.
        bounds = np.searchsorted(seg, np.arange(C + 1))
        kept_rows_per_j = [
            b_arr[bounds[j]:bounds[j + 1]][keep[bounds[j]:bounds[j + 1]]]
            for j in range(C)
        ]
        from ..native import mean_shift_argmin_batch

        # closest-to-mean depends only on the kept row set; near convergence
        # most clusters' kept sets repeat between iterations, so reuse the
        # previous result when the set is identical (exact)
        new_centers: List[int] = [0] * C
        todo: List[int] = []
        for j in range(C):
            good = kept_rows_per_j[j]
            cl = clusters[j]
            if len(good) == 0:
                new_centers[j] = (
                    int(cl.members[0]) if delta == 0 else cl.center_row
                )
                continue
            prev = getattr(cl, "_ms_kept", None)
            if prev is not None and np.array_equal(prev, good):
                new_centers[j] = cl._ms_result
            else:
                todo.append(j)
        if todo:
            offsets = np.zeros(len(todo) + 1, dtype=np.int64)
            for t, j in enumerate(todo):
                offsets[t + 1] = offsets[t] + len(kept_rows_per_j[j])
            flat = np.concatenate([kept_rows_per_j[j] for j in todo])
            native = None if self.row_fetcher is not None else \
                mean_shift_argmin_batch(
                    self.ps.counts, self.ps.mags, flat, offsets
                )
            for t, j in enumerate(todo):
                good = kept_rows_per_j[j]
                if native is not None:
                    res = int(native[t])
                else:
                    cg = self._rows(good)
                    top = cg.astype(np.float64).mean(axis=0)
                    d = distance_d(cg, top)
                    res = int(good[int(np.argmin(d))])
                new_centers[j] = res
                cl = clusters[j]
                cl._ms_kept = good
                cl._ms_result = res
        return new_centers

    def _device_update_iter(self, clusters: List[Cluster], cen_rows, b_arr,
                            seg, delta: int, C: int) -> List[int]:
        """One fused device dispatch for the iteration's filter + per-center
        closest-to-mean (device_update.filter_closest).  Margin-uncertain
        keep decisions are re-scored by the f64 oracle; their segments —
        plus guard-tripped or empty segments — fall back to the exact host
        closest path (Trainer.cpp:122-157 semantics)."""
        updater = self._get_device_updater()
        keep, kunc, first, cunc = updater.filter_closest(
            cen_rows.astype(np.int64), b_arr, seg, C)
        P = len(b_arr)
        affected = np.zeros(C, dtype=bool)
        idx = np.nonzero(kunc)[0]
        if len(idx):
            updater.rechecked_pairs += len(idx)
            prob, _ = self._host_oracle().score(cen_rows[seg[idx]], b_arr[idx])
            keep2 = np.floor(prob + 0.5) != 0
            flipped = keep2 != keep[idx]
            keep[idx] = keep2
            # a flipped keep changes the kept set: that center's device
            # closest-to-mean result is stale
            affected[seg[idx[flipped]]] = True
        bounds = np.searchsorted(seg, np.arange(C + 1))
        new_centers: List[int] = [0] * C
        for j in range(C):
            lo, hi = int(bounds[j]), int(bounds[j + 1])
            kj = keep[lo:hi]
            cl = clusters[j]
            if not kj.any():
                new_centers[j] = int(cl.members[0]) if delta == 0 else cl.center_row
            elif not cunc[j] and not affected[j] and first[j] < P:
                new_centers[j] = int(b_arr[first[j]])
            else:
                good = b_arr[lo:hi][kj]
                cg = self._rows(good)
                top = cg.astype(np.float64).mean(axis=0)
                d = distance_d(cg, top)
                new_centers[j] = int(good[int(np.argmin(d))])
        return new_centers

    def _merge_pass(self, clusters: List[Cluster], delta: int) -> bool:
        """Classifier-directed center merging (ClusterFactory.cpp:382-401,
        Trainer.cpp:73-109).  All (i, j in i+1..i+delta) center pairs are
        scored in one batch — legal because merge decisions depend only on
        center points and lengths, which are fixed during the pass; the
        absorb/delete bookkeeping is then applied in the reference's
        sequential order."""
        C = len(clusters)
        cen_rows = np.array([c.center_row for c in clusters], dtype=np.int64)
        cen_lens = self.ps.lengths[cen_rows]
        # all (i, j in i+1..i+delta) candidate pairs, built without a loop
        iis = np.arange(C)
        per_i = np.minimum(C - 1, iis + delta) - iis  # candidates per center
        per_i = np.maximum(per_i, 0)
        total = int(per_i.sum())
        seg = np.repeat(iis, per_i)
        jj = seg + 1 + (
            np.arange(total, dtype=np.int64)
            - np.repeat(np.cumsum(per_i) - per_i, per_i)
        )
        min_lengths = (cen_lens * self.sim).astype(np.int64)
        max_lengths = (cen_lens / self.sim).astype(np.int64)
        lp = (cen_lens[jj] >= min_lengths[seg]) & (cen_lens[jj] <= max_lengths[seg])
        seg = seg[lp]
        jj = jj[lp]
        a_arr = cen_rows[jj]
        num_merge = 0
        if len(a_arr):
            # order (candidate center j, center i) (Trainer.cpp:93)
            updater = self._get_device_updater()
            if updater is not None:
                merged = self._device_merge(clusters, cen_rows, jj, seg, C)
                self.stats.pairs_scored += len(a_arr)
                num_merge = merged
            else:
                prob, dist = self.scorer.score(a_arr, cen_rows[seg])
                res1 = c_round(prob) == 1
                bounds = np.searchsorted(seg, np.arange(C + 1))
                for i in range(C):
                    lo, hi = bounds[i], bounds[i + 1]
                    if lo == hi:
                        continue
                    m = res1[lo:hi]
                    if not m.any():
                        continue
                    d = dist[lo:hi][m]
                    cj = jj[lo:hi][m]
                    # ties: later candidate wins (best.second > dist keeps
                    # best only when strictly greater, Trainer.cpp:104)
                    best_k = len(d) - 1 - int(np.argmax(d[::-1]))
                    # every candidate satisfies j > i by construction
                    ret = int(cj[best_k])
                    num_merge += 1
                    clusters[ret].members.extend(clusters[i].members)
                    clusters[i].deleted = True
        if num_merge:
            clusters[:] = [c for c in clusters if not c.deleted]
        return num_merge > 0

    def _device_merge(self, clusters: List[Cluster], cen_rows, jj, seg,
                      C: int) -> int:
        """Merge decisions through the fused device kernel
        (device_update.merge_segmented); centers with margin-uncertain
        probabilities or ambiguous distance rankings are re-scored whole by
        the f64 host oracle, so merges match the reference bit for bit."""
        updater = self._get_device_updater()
        unc, any_m, best, amb = updater.merge_segmented(cen_rows, jj, seg, C)
        affected = np.asarray(amb, dtype=bool).copy()
        if unc.any():
            affected[seg[unc]] = True
        bounds = np.searchsorted(seg, np.arange(C + 1))
        num_merge = 0
        for i in range(C):
            lo, hi = int(bounds[i]), int(bounds[i + 1])
            if lo == hi:
                continue
            if affected[i]:
                updater.rechecked_pairs += hi - lo
                prob, dist = self._host_oracle().score(
                    cen_rows[jj[lo:hi]], cen_rows[seg[lo:hi]])
                m = np.floor(prob + 0.5) == 1
                if not m.any():
                    continue
                d = dist[m]
                cj = jj[lo:hi][m]
                best_k = len(d) - 1 - int(np.argmax(d[::-1]))
                ret = int(cj[best_k])
            elif any_m[i] and best[i] >= 0:
                ret = int(jj[best[i]])
            else:
                continue
            num_merge += 1
            clusters[ret].members.extend(clusters[i].members)
            clusters[i].deleted = True
        return num_merge

    def update_phase(self, clusters: List[Cluster], checkpoint: Optional[str] = None,
                     start_it: int = 0,
                     num_clusters: Optional[List[int]] = None) -> None:
        from ..utils.progress import Progress

        num_clusters = list(num_clusters) if num_clusters else []
        prog = Progress(self.iterations, "Update")  # ClusterFactory.cpp:634
        prog.set(start_it)
        phase = getattr(self.device_session, "phase", None)
        if phase is not None and checkpoint is None and start_it == 0:
            # the whole phase on the card (cluster/device_phase.py); after a
            # guarded abort the per-iteration path below resumes from the
            # abort iteration (after abort 2 the early-stop test that ended
            # the phase's loop breaks at once, and only the delta = 0 pass
            # is redone).  A phase that raises fails the run.
            n_before = len(clusters)
            res = phase.run(clusters)
            clusters[:] = [Cluster(center_row=c, members=m)
                           for c, m in res.clusters]
            self.stats.pairs_scored += res.pairs
            self.stats.update_iterations += res.it
            num_clusters.extend(res.hist)
            start_it = res.it
            prog.set(res.it)
            import os as _os

            if _os.environ.get("MC2_DEVICE_PROF"):
                print(f"device update phase: {phase.last_seconds:.3f}s, "
                      f"{res.it} iterations, {res.pairs} pairs, abort "
                      f"{res.abort}, {n_before} clusters before, hist "
                      f"{res.hist}")
            if res.abort == 0:
                prog.end()
                return
            print(f"device update phase: guarded abort (stage {res.abort}) "
                  f"at iteration {res.it}; host continues")
        if self._native_update(clusters, prog, checkpoint, start_it,
                               num_clusters):
            prog.end()
            return
        saved_scorer = self.scorer
        # with the device updater, re-scoring is cheaper than the memo's
        # sorted-store maintenance (and decisions bypass self.scorer anyway)
        memo = (None if self._get_device_updater() is not None
                else _ScoreMemo(saved_scorer, self.ps.n))
        if memo is not None:
            self.scorer = memo
        try:
            for it in range(start_it, self.iterations):
                if it >= 3 and len(clusters) == num_clusters[it - 3]:
                    break
                new_centers = self._batched_mean_shift_update(clusters, self.delta)
                for c, nc in zip(clusters, new_centers):
                    c.center_row = nc
                self._merge_pass(clusters, self.delta)
                num_clusters.append(len(clusters))
                self.stats.update_iterations += 1
                prog.step()
                if checkpoint:
                    self._save_checkpoint(checkpoint, clusters, "update", it + 1,
                                          num_clusters)
            prog.end()
            new_centers = self._batched_mean_shift_update(clusters, 0)
            for c, nc in zip(clusters, new_centers):
                c.center_row = nc
            import os as _os

            updater = self._get_device_updater()
            if updater is not None and _os.environ.get("MC2_DEVICE_PROF"):
                print(updater.prof_line())
        finally:
            # pairs_scored = pairs that actually reached the wrapped scorer
            # (same semantics as the accumulate phase's cache-miss counting)
            if memo is not None:
                self.stats.pairs_scored += memo.scored
            self.scorer = saved_scorer

    def _native_update(self, clusters: List[Cluster], prog, checkpoint,
                       start_it: int, num_clusters: List[int]) -> bool:
        """One-call native update/merge driver (native/update.cpp) — the
        whole phase without the Python memo's sorted-array store or the
        per-iteration numpy pair bookkeeping.  Checkpointing/resume ride
        the driver's per-iteration state callback and start_it/prior-count
        entry points; mutates `clusters` in place and returns True on
        success."""
        import os

        from ..native import NativeScorer

        if os.environ.get("MC2_NO_NATIVE_UPDATE"):
            return False
        if type(self.scorer) is not NativeScorer:
            return False
        state_cb = None
        cb_error: List[BaseException] = []
        if checkpoint:
            from .checkpoint import save_checkpoint_arrays

            counts_hist = list(num_clusters)

            def state_cb(it, centers, offsets, members):
                counts_hist.append(len(centers))
                try:
                    save_checkpoint_arrays(
                        checkpoint, centers, offsets, members,
                        phase="update", iteration=it,
                        num_clusters=counts_hist,
                        fingerprint=self._run_fingerprint(),
                    )
                except BaseException as e:  # noqa: BLE001 — no raising into C
                    cb_error.append(e)
                    return 1
                return 0

        res = self.scorer.update(clusters, self.sim, self.delta,
                                 self.iterations, progress_step=prog.step,
                                 start_it=start_it,
                                 prior_counts=num_clusters[:start_it],
                                 state_cb=state_cb)
        if cb_error:
            raise cb_error[0]
        if res is None:
            return False
        centers, offsets, members, its, pairs = res
        self.stats.update_iterations += its
        self.stats.pairs_scored += pairs
        clusters[:] = [
            Cluster(
                center_row=int(centers[i]),
                members=members[offsets[i]:offsets[i + 1]].tolist(),
            )
            for i in range(len(centers))
        ]
        return True

    def _run_fingerprint(self) -> str:
        from .checkpoint import dataset_fingerprint

        fp = getattr(self, "_fingerprint", None)
        if fp is None:
            fp = self._fingerprint = dataset_fingerprint(
                self.ps, (self.sim, self.delta, self.iterations, self.bin_size)
            )
        return fp

    def _save_checkpoint(self, path, clusters, phase, iteration, num_clusters):
        from .checkpoint import save_checkpoint

        save_checkpoint(path, clusters, phase=phase, iteration=iteration,
                        num_clusters=num_clusters,
                        fingerprint=self._run_fingerprint())

    # ---------------- public API ----------------

    def run(self, clock=None, checkpoint: Optional[str] = None,
            resume: Optional[str] = None) -> List[Cluster]:
        start_it = 0
        saved_counts: Optional[List[int]] = None
        if resume:
            from .checkpoint import load_checkpoint

            clusters, meta = load_checkpoint(resume, self._run_fingerprint())
            print(f"Resumed {len(clusters)} clusters from {resume} "
                  f"(phase {meta['phase']}, iteration {meta['iteration']})")
            start_it = meta["iteration"]
            saved_counts = meta["num_clusters"]
            self.stats.clusters_before_update = len(clusters)
        else:
            bv = BVec(self.ps.lengths, self.bin_size)
            bv.insert_all(self.ps.lengths)
            bv.insert_finalize(self.ps.lengths)
            clusters = self.accumulate_all(bv)
            print(f"Number of clusters before update: {len(clusters)}")
        if clock is not None:
            clock.stamp("accumulate")
        if checkpoint and not resume:
            self._save_checkpoint(checkpoint, clusters, "accumulated", 0, [])
        self.update_phase(clusters, checkpoint=checkpoint, start_it=start_it,
                          num_clusters=saved_counts)
        return clusters

    def to_output(self, clusters: List[Cluster]) -> List[dict]:
        out = []
        for cl in clusters:
            members = [
                (
                    int(self.ps.lengths[r]),
                    self.ps.headers[r],
                    r == cl.center_row,
                )
                for r in cl.members
            ]
            out.append({"members": members})
        return out
