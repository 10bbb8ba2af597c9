"""MeShClust2's mean-shift clustering, step by step, on a pool's histograms.

The algorithm of ClusterFactory.cpp:552-656 and Trainer.cpp, as a plain
host loop over the length-binned pool (bvec.cpp) with the pair scoring in
`model.py` and the closest-to-mean in PyTorch on the card:

  accumulate: from the first row of the first non-empty bin, score every
    pool row in the center's length window, mark the positives; when there
    are none, the cluster closes and the window's best-dist row (or the
    pool's next row) seeds the next; else the marked rows join the cluster,
    leave the pool, and the center moves to the member closest to the
    members' mean (first strict minimum);
  update: per iteration, every center re-centres on the closest-to-mean of
    its +-delta neighbour clusters' members that it classifies positive,
    then each center i merges into its best positive (largest dist, the
    later on a tie) among the next delta centers; it stops after 15
    iterations or when the count of clusters has not changed over three;
    a last pass with delta 0.

The pool's order is the reference's: sorted by header, then by length with
std::sort (introsort.py), ids in that order; each bin is sorted by length
the same way.  Every tie rule is the upstream one.  This is a copy of the
algorithm's semantics, not of any program's data structures: it imports
nothing of the program.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import model as M
from .introsort import sort_perm


class BVec:
    """The reference's length-binned pool (bvec.cpp): ~bin_size rows a bin,
    bins keyed by their first length, each bin sorted by length with
    std::sort, rows marked by a window scan and removed in bin-major slot
    order."""

    def __init__(self, lengths: np.ndarray, bin_size: int = 1000):
        lengths = np.asarray(lengths, dtype=np.int64)
        srt = np.sort(lengths)
        self.bounds = srt[::bin_size].astype(np.int64)
        nb = len(self.bounds)
        self.lengths = lengths
        hi = np.searchsorted(self.bounds, lengths, side="right")
        which = np.where((hi == 0) | (hi >= nb), nb - 1, hi - 1)
        self.bins: List[np.ndarray] = []
        for i in range(nb):
            rows = np.nonzero(which == i)[0].astype(np.int64)
            if len(rows):
                rows = rows[sort_perm(lengths[rows])]
            self.bins.append(rows)
        self.marks = [np.zeros(len(b), dtype=bool) for b in self.bins]

    def pop(self) -> Optional[int]:
        for i, b in enumerate(self.bins):
            if len(b):
                self.bins[i] = b[1:]
                self.marks[i] = self.marks[i][1:]
                return int(b[0])
        return None

    def _index_of(self, length: int) -> Tuple[int, int]:
        nb = len(self.bounds)
        hi = int(np.searchsorted(self.bounds, length, side="right"))
        if hi == 0:
            return nb - 1, 0
        if hi >= nb:
            return nb - 1, nb - 1
        return hi - 1, hi - 1

    def _inner(self, length: int, idx: int, front: bool):
        """(bin, slot) of the first (front) or last (back) row of `length`
        in bin idx by the upstream binary search, or (bin, None) where the
        bin is empty and no other bin has rows."""
        if idx >= len(self.bins) or len(self.bins[idx]) == 0:
            order = range(len(self.bins)) if front else \
                range(len(self.bins) - 1, -1, -1)
            for i in order:
                if len(self.bins[i]):
                    return i, 0
            return idx, None
        b = self.bins[idx]
        lens = self.lengths
        lo_slot = hi_slot = 0
        low, high = 0, len(b) - 1
        while low <= high:
            mid = (low + high) // 2
            d = int(lens[b[mid]])
            if d == length:
                lo_slot = hi_slot = mid
                break
            elif length < d:
                high = mid
            else:
                low = mid + 1
            if low == high:
                lo_slot, hi_slot = low, high
                break
        if front:
            i = lo_slot
            while i >= 0 and int(lens[b[i]]) == length:
                lo_slot = i
                i -= 1
            return idx, lo_slot
        i = hi_slot
        while i < len(b) and int(lens[b[i]]) == length:
            hi_slot = i
            i += 1
        return idx, hi_slot

    def get_range(self, begin_len: int, end_len: int):
        f_bin, f_slot = self._inner(begin_len, self._index_of(begin_len)[0], True)
        b_bin, b_slot = self._inner(end_len, self._index_of(end_len)[1], False)
        back_empty = b_slot is None
        if f_slot is None:
            f_slot = 0
            back_empty = True
        return (f_bin, f_slot), (b_bin, b_slot or 0), back_empty

    def window(self, front, back):
        """Rows from front (inclusive) to back (exclusive), bin-major."""
        (r, c), (br, bc) = front, back
        while r < len(self.bins) and c >= len(self.bins[r]):
            r, c = r + 1, 0
        rows, bins, slots = [], [], []
        while r < len(self.bins) and (r, c) < (br, bc):
            hi = bc if r == br else len(self.bins[r])
            if hi > c:
                rows.append(self.bins[r][c:hi])
                bins.append(np.full(hi - c, r, dtype=np.int64))
                slots.append(np.arange(c, hi, dtype=np.int64))
            r, c = r + 1, 0
        if not rows:
            z = np.zeros(0, dtype=np.int64)
            return z, z, z
        return np.concatenate(rows), np.concatenate(bins), np.concatenate(slots)

    def mark(self, bins: np.ndarray, slots: np.ndarray) -> None:
        for r in np.unique(bins):
            self.marks[r][slots[bins == r]] = True

    def erase(self, r: int, c: int) -> None:
        self.bins[r] = np.delete(self.bins[r], c)
        self.marks[r] = np.delete(self.marks[r], c)

    def remove_marked(self, front, back) -> np.ndarray:
        out = []
        for i in range(front[0], min(back[0], len(self.bins) - 1) + 1):
            m = self.marks[i]
            if m.any():
                out.append(self.bins[i][m])
                self.bins[i] = self.bins[i][~m]
                self.marks[i] = m[~m]
        return np.concatenate(out) if out else np.zeros(0, dtype=np.int64)


@dataclass
class Cluster:
    center: int
    members: List[int]
    deleted: bool = False


class MeanShift:
    """One clustering of a pool (`model.Pool` in the reference's order)."""

    def __init__(self, pool: M.Pool, head: M.Head, sim: float, delta: int = 5,
                 iterations: int = 15, dtype=np.float64, bin_size: int = 1000):
        self.pool = pool
        self.head = head
        self.sim = sim
        self.delta = delta
        self.iterations = iterations
        self.dtype = np.dtype(dtype)
        self.bin_size = bin_size
        self.steps = 0

    # -- scoring ------------------------------------------------------------

    def score(self, a: np.ndarray, b: np.ndarray):
        raw = M.raw_singles(self.head, self.pool, a, b, self.dtype)
        s, dist = M.glm(self.head, raw)
        return M.prob(s), dist

    def closest_to_mean(self, rows: np.ndarray, offsets: np.ndarray) -> np.ndarray:
        """Per segment rows[offsets[j]:offsets[j+1]]: the row whose
        10000 (1 - f^2), f = 2 sum min(c, round(mean)) / sum trunc(c + mean),
        is least (DivergencePoint.cpp:54-66), the first on a tie."""
        pool, dt = self.pool, self.dtype
        nseg = len(offsets) - 1
        lens = np.diff(offsets)
        seg = np.repeat(np.arange(nseg), lens)
        dev = pool.device
        rows_t = torch.as_tensor(rows, dtype=torch.int64, device=dev)
        seg_t = torch.as_tensor(seg, dtype=torch.int64, device=dev)
        sums = torch.zeros(nseg, pool.d, dtype=torch.float64, device=dev)
        step = 1 << 14
        for s in range(0, len(rows), step):
            sums.index_add_(0, seg_t[s:s + step],
                            pool.counts[rows_t[s:s + step]].to(torch.float64))
        tdt = torch.float64 if dt == np.float64 else torch.float32
        n_t = torch.as_tensor(lens, dtype=tdt, device=dev)
        top = sums.to(tdt) / n_t[:, None]
        num = np.empty(len(rows), dtype=np.int64)
        den = np.empty(len(rows), dtype=np.int64)
        for s in range(0, len(rows), step):
            c = pool.counts[rows_t[s:s + step]].to(tdt)
            t = top[seg_t[s:s + step]]
            num[s:s + step] = (2 * torch.minimum(c, torch.floor(t + 0.5))
                               ).sum(1, dtype=torch.float64).to(torch.int64).cpu().numpy()
            den[s:s + step] = torch.trunc(c + t).sum(1, dtype=torch.float64
                                                     ).to(torch.int64).cpu().numpy()
        frac = num.astype(dt) / den.astype(dt)
        d = dt.type(10000) * (dt.type(1) - frac * frac)
        order = np.lexsort((np.arange(len(rows)), d, seg))
        first = order[np.searchsorted(seg[order], np.arange(nseg))]
        return rows[first]

    # -- accumulate (ClusterFactory.cpp:552-610, Trainer.cpp:22-71) ---------

    def _get_close(self, bv: BVec, center: int):
        length = int(self.pool.lengths[center])
        begin_len = int(length * self.sim)
        end_len = int(length / self.sim)
        front, back, back_empty = bv.get_range(begin_len, end_len)
        if back_empty:
            return None, None, True, front, back
        rows, bins, slots = bv.window(front, back)
        if len(rows) == 0:
            return None, None, True, front, back
        lens = self.pool.lengths[rows]
        ok = (lens >= begin_len) & (lens <= end_len)
        if not ok.any():
            return None, None, True, front, back
        sel = np.nonzero(ok)[0]
        prob, dist = self.score(rows[sel], np.array([center]))
        pos = M.positive(prob)
        best = int(sel[int(np.argmax(dist))])
        marked = sel[pos]
        bv.mark(bins[marked], slots[marked])
        return (int(rows[best]), (int(bins[best]), int(slots[best])),
                not pos.any(), front, back)

    def accumulate(self) -> List[Cluster]:
        bv = BVec(self.pool.lengths, self.bin_size)
        clusters: List[Cluster] = []
        last = bv.pop()
        while last is not None:
            current = [last]
            while True:
                self.steps += 1
                best_row, best_pos, is_min, front, back = \
                    self._get_close(bv, last)
                if is_min:
                    clusters.append(Cluster(last, current))
                    if best_row is None:
                        last = bv.pop()
                    else:
                        last = best_row
                        bv.erase(*best_pos)
                    break
                current.extend(bv.remove_marked(front, back).tolist())
                rows = np.asarray(current, dtype=np.int64)
                last = int(self.closest_to_mean(
                    rows, np.array([0, len(rows)]))[0])
        return clusters

    # -- update (ClusterFactory.cpp:287-401, 635-655) ----------------------

    def _recenter(self, clusters: List[Cluster], delta: int) -> List[int]:
        C = len(clusters)
        members = [np.asarray(c.members, dtype=np.int64) for c in clusters]
        flat = np.concatenate(members) if C else np.zeros(0, np.int64)
        moff = np.zeros(C + 1, dtype=np.int64)
        np.cumsum([len(m) for m in members], out=moff[1:])
        js = np.arange(C)
        starts = moff[np.maximum(0, js - delta)]
        ends = moff[np.minimum(C - 1, js + delta) + 1]
        per = ends - starts
        seg = np.repeat(js, per)
        b = flat[np.repeat(starts, per)
                 + np.arange(int(per.sum())) - np.repeat(np.cumsum(per) - per, per)]
        cen = np.array([c.center for c in clusters], dtype=np.int64)
        clen = self.pool.lengths[cen]
        lo = (self.sim * clen).astype(np.int64)
        hi = (clen / self.sim).astype(np.int64)
        blen = self.pool.lengths[b]
        ok = (blen >= lo[seg]) & (blen <= hi[seg])
        b, seg = b[ok], seg[ok]
        keep = np.zeros(len(b), dtype=bool)
        if len(b):
            prob, _ = self.score(cen[seg], b)
            keep = np.floor(prob + prob.dtype.type(0.5)) != 0
        new = [(c.members[0] if delta == 0 else c.center) for c in clusters]
        kb, ks = b[keep], seg[keep]
        if len(kb):
            segs, idx = np.unique(ks, return_index=True)
            offsets = np.append(idx, len(ks))
            chosen = self.closest_to_mean(kb, offsets)
            for j, r in zip(segs.tolist(), chosen.tolist()):
                new[j] = int(r)
        return new

    def _merge(self, clusters: List[Cluster], delta: int) -> bool:
        C = len(clusters)
        cen = np.array([c.center for c in clusters], dtype=np.int64)
        clen = self.pool.lengths[cen]
        ii = np.arange(C)
        per = np.maximum(np.minimum(C - 1, ii + delta) - ii, 0)
        seg = np.repeat(ii, per)
        jj = seg + 1 + (np.arange(int(per.sum())) - np.repeat(np.cumsum(per) - per, per))
        lo = (clen * self.sim).astype(np.int64)
        hi = (clen / self.sim).astype(np.int64)
        ok = (clen[jj] >= lo[seg]) & (clen[jj] <= hi[seg])
        seg, jj = seg[ok], jj[ok]
        merged = 0
        if len(jj):
            prob, dist = self.score(cen[jj], cen[seg])
            one = np.floor(prob + prob.dtype.type(0.5)) == 1
            bounds = np.searchsorted(seg, np.arange(C + 1))
            for i in range(C):
                lo_i, hi_i = bounds[i], bounds[i + 1]
                m = one[lo_i:hi_i]
                if not m.any():
                    continue
                d = dist[lo_i:hi_i][m]
                cj = jj[lo_i:hi_i][m]
                # the later candidate wins a tie (Trainer.cpp:104)
                ret = int(cj[len(d) - 1 - int(np.argmax(d[::-1]))])
                merged += 1
                clusters[ret].members.extend(clusters[i].members)
                clusters[i].deleted = True
        if merged:
            clusters[:] = [c for c in clusters if not c.deleted]
        return merged > 0

    def update(self, clusters: List[Cluster]) -> None:
        counts: List[int] = []
        for it in range(self.iterations):
            if it >= 3 and len(clusters) == counts[it - 3]:
                break
            for c, nc in zip(clusters, self._recenter(clusters, self.delta)):
                c.center = nc
            self._merge(clusters, self.delta)
            counts.append(len(clusters))
        for c, nc in zip(clusters, self._recenter(clusters, 0)):
            c.center = nc

    def run(self) -> List[Cluster]:
        clusters = self.accumulate()
        self.update(clusters)
        return clusters
