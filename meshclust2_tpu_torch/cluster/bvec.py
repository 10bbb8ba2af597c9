"""Length-binned point pool — behavioral equivalent of the reference's bvec
(bvec.cpp / bvec_iterator.cpp).

Points are referenced by integer row index into a PointSet whose rows are in
ascending-length order.  The pool partitions points into ~bin_size bins keyed
by length boundaries; candidate windows for a center are (bin, slot) ranges
queried by length.  Several quirks of the reference are preserved because
they are observable in cluster output:

  - window end position is exclusive (ClusterFactory's `i < iend` loop,
    Trainer.cpp:42);
  - a begin-length below the smallest bin bound resolves to the *last* bin
    (index_of initializes low = size-1, bvec.cpp:125-147), which empties the
    window for multi-bin pools;
  - insertion lands in the single bin index_of selects (the reference's
    "middle of the least-filled eligible bins", bvec.cpp:149-184, is
    degenerate because index_of's intervals are disjoint);
  - removal collects marked entries bin-major in slot order
    (bvec.cpp:341-384).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


class BVec:
    """Bins are numpy int64 row arrays with parallel boolean mark arrays;
    all window/removal operations are vectorized."""

    def __init__(self, lengths: np.ndarray, bin_size: int = 1000):
        lengths = np.sort(np.asarray(lengths, dtype=np.int64))
        self.begin_bounds: List[int] = [int(lengths[i]) for i in range(0, len(lengths), bin_size)]
        nb = len(self.begin_bounds)
        self._build: List[List[int]] = [[] for _ in range(nb)]
        self.bins: List[np.ndarray] = [np.zeros(0, np.int64) for _ in range(nb)]
        self.marks: List[np.ndarray] = [np.zeros(0, bool) for _ in range(nb)]
        self._lengths: Optional[np.ndarray] = None
        self._bounds_arr = np.asarray(self.begin_bounds, dtype=np.int64)

    # -- construction -------------------------------------------------------

    def insert(self, row: int, length: int) -> None:
        # the reference's "middle of the least-filled eligible bins"
        # (bvec.cpp:149-184) is degenerate: index_of's intervals are
        # disjoint, so the eligible range is always a single bin (or the
        # below-all-bounds (nb-1, 0) quirk, where front is that single
        # fallback bin too)
        front, _ = self._index_of(length)
        self._build[front].append(row)

    def insert_all(self, lengths: np.ndarray) -> None:
        """Vectorized insert of rows 0..n-1 — the same single-bin
        index_of selection as insert(), batched (at 1M rows the per-row
        Python loop was seconds)."""
        lengths = np.asarray(lengths, dtype=np.int64)
        nb = len(self.begin_bounds)
        hi_cnt = np.searchsorted(self._bounds_arr, lengths, side="right")
        front = np.where((hi_cnt == 0) | (hi_cnt >= nb), nb - 1, hi_cnt - 1)
        order = np.argsort(front, kind="stable")  # rows stay in id order
        sorted_bins = front[order]
        starts = np.searchsorted(sorted_bins, np.arange(nb))
        ends = np.searchsorted(sorted_bins, np.arange(nb), side="right")
        for b in range(nb):
            if ends[b] > starts[b]:
                self._build[b].extend(order[starts[b]:ends[b]].tolist())

    def insert_finalize(self, lengths: np.ndarray) -> None:
        """Sort each bin by length (bvec.cpp:215-233) with the native
        std::sort permutation helper, so equal-length tie order matches the
        reference's unstable introsort."""
        from ..native import sort_perm

        self._lengths = np.asarray(lengths, dtype=np.int64)
        for i, b in enumerate(self._build):
            arr = np.asarray(b, dtype=np.int64)
            if len(arr):
                perm = sort_perm(self._lengths[arr].astype(np.uint64))
                arr = arr[perm]
            self.bins[i] = arr
            self.marks[i] = np.zeros(len(arr), dtype=bool)
        self._build = [[] for _ in self._build]

    # -- queries ------------------------------------------------------------

    def pop(self) -> Optional[int]:
        for i, b in enumerate(self.bins):
            if len(b):
                row = int(b[0])
                self.bins[i] = b[1:]
                self.marks[i] = self.marks[i][1:]
                return row
        return None

    def size(self) -> int:
        return sum(len(b) for b in self.bins)

    def empty(self) -> bool:
        return all(len(b) == 0 for b in self.bins)

    def _index_of(self, length: int) -> Tuple[int, int]:
        """Bin range whose [begin, next_begin) interval contains `length`
        (bvec.cpp:122-147).  Returns (low, high) with the reference's
        initialization quirk: low = nbins-1 when nothing matches.

        The reference scans all bins; with non-decreasing bounds the match
        set is always the single index searchsorted-1 (or empty), so this is
        one binary search — same results, O(log nbins) instead of O(nbins)."""
        nb = len(self.begin_bounds)
        hi_cnt = int(np.searchsorted(self._bounds_arr, length, side="right"))
        if hi_cnt == 0:          # below every bound: loop matches nothing
            return nb - 1, 0
        if hi_cnt >= nb:         # at/above the last bound: last-bin rule
            return nb - 1, nb - 1
        return hi_cnt - 1, hi_cnt - 1

    def _inner_index_of(self, length: int, idx: int, want_front: bool, want_back: bool):
        """(bvec.cpp:51-120).  Returns (idx, front, back); front/back None
        when not requested."""
        front_out = back_out = None
        if idx >= len(self.bins) or len(self.bins[idx]) == 0:
            if want_front:
                for i in range(len(self.bins)):
                    if len(self.bins[i]):
                        idx = i
                        front_out = 0
                        break
            if want_back:
                for i in range(len(self.bins) - 1, -1, -1):
                    if len(self.bins[i]):
                        idx = i
                        back_out = 0
                        break
            return idx, front_out, back_out
    # binary search within the bin, replicating the reference's loop with its
    # low==high break (bvec.cpp:76-104)
        lens = self._lengths
        b = self.bins[idx]
        front = back = 0
        low, high = 0, len(b) - 1
        while low <= high:
            mid = (low + high) // 2
            d = int(lens[b[mid]])
            if d == length:
                front = back = mid
                break
            elif length < d:
                high = mid
            else:
                low = mid + 1
            if low == high:
                front = low
                back = high
                break
        if want_front:
            i = front
            while i >= 0 and int(lens[b[i]]) == length:
                front = i
                i -= 1
            front_out = front
        if want_back:
            i = back
            while i < len(b) and int(lens[b[i]]) == length:
                back = i
                i += 1
            back_out = back
        return idx, front_out, back_out

    def get_range(self, begin_len: int, end_len: int):
        """((front_bin, front_slot), (back_bin, back_slot), back_empty)
        (bvec.cpp:260-330)."""
        f_bin = self._index_of(begin_len)[0]
        b_bin = self._index_of(end_len)[1]
        f_bin, f_slot, _ = self._inner_index_of(begin_len, f_bin, True, False)
        b_bin, _, b_slot = self._inner_index_of(end_len, b_bin, False, True)
        back_empty = b_slot is None
        if f_slot is None:
            f_slot = 0
            back_empty = True
        return (f_bin, f_slot), (b_bin, b_slot or 0), back_empty

    def window(self, front, back):
        """All candidates from front inclusive to back exclusive in bin-major
        order — the `for (i = istart; i < iend; ++i)` walk (Trainer.cpp:42,
        bvec_iterator.h:40-48).  Returns (rows, bin_ids, slots) arrays."""
        fr, fc = front
        br, bc = back
        # normalize start position like operator++ would after exhausting a bin
        r, c = fr, fc
        while r < len(self.bins) and c >= len(self.bins[r]):
            r += 1
            c = 0
        rows_parts, bin_parts, slot_parts = [], [], []
        while r < len(self.bins) and (r, c) < (br, bc):
            hi = bc if r == br else len(self.bins[r])
            if hi > c:
                rows_parts.append(self.bins[r][c:hi])
                bin_parts.append(np.full(hi - c, r, dtype=np.int64))
                slot_parts.append(np.arange(c, hi, dtype=np.int64))
            r += 1
            c = 0
        if not rows_parts:
            z = np.zeros(0, dtype=np.int64)
            return z, z.copy(), z.copy()
        return (
            np.concatenate(rows_parts),
            np.concatenate(bin_parts),
            np.concatenate(slot_parts),
        )

    def mark_slots(self, bin_ids: np.ndarray, slots: np.ndarray) -> None:
        for r in np.unique(bin_ids):
            self.marks[r][slots[bin_ids == r]] = True

    def erase(self, r: int, c: int) -> None:
        self.bins[r] = np.delete(self.bins[r], c)
        self.marks[r] = np.delete(self.marks[r], c)

    def remove_available(self, front, back) -> np.ndarray:
        """Collect and remove every marked entry in bins front..back
        (full bins, not slot-bounded) in bin-major slot order
        (bvec.cpp:341-384)."""
        a, b = front[0], back[0]
        out = []
        for i in range(a, min(b, len(self.bins) - 1) + 1):
            m = self.marks[i]
            if m.any():
                out.append(self.bins[i][m])
                keep = ~m
                self.bins[i] = self.bins[i][keep]
                self.marks[i] = m[keep]
        if not out:
            return np.zeros(0, dtype=np.int64)
        return np.concatenate(out)
