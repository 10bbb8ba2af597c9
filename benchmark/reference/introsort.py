"""libstdc++'s std::sort (introsort), in Python, over an index vector.

The clustering orders its pool with std::sort on keys that tie (equal
lengths), and std::sort is not stable: which of two equal-length
sequences comes first is the algorithm's swap sequence, and that order is
seen in the clusters (a bin's first row seeds the next cluster).  So the
reference repeats the algorithm step for step: `__introsort_loop` with the
median-of-three pivot and `__unguarded_partition`, the heap sort past the
depth limit, and `__final_insertion_sort` with its threshold of 16, as in
GCC's bits/stl_algo.h and bits/stl_heap.h.  Sorting an index vector by a
key comparator makes the same swaps as sorting the keys themselves.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

_THRESHOLD = 16


def sort_perm(keys: Sequence) -> np.ndarray:
    """The permutation that std::sort(perm, perm + n, [](a, b) {return
    keys[a] < keys[b];}) leaves in an iota vector."""
    k = list(keys.tolist() if isinstance(keys, np.ndarray) else keys)
    n = len(k)
    p = list(range(n))
    if n > 1:
        # sort (key, index) pairs in lock step: v[i] is the key of p[i]
        v = [k[i] for i in p]
        _introsort_loop(v, p, 0, n, 2 * (n.bit_length() - 1))
        _final_insertion_sort(v, p, 0, n)
    return np.asarray(p, dtype=np.int64)


def _swap(v: List, p: List, i: int, j: int) -> None:
    v[i], v[j] = v[j], v[i]
    p[i], p[j] = p[j], p[i]


def _introsort_loop(v, p, first: int, last: int, depth: int) -> None:
    while last - first > _THRESHOLD:
        if depth == 0:
            _heap_sort(v, p, first, last)
            return
        depth -= 1
        cut = _partition_pivot(v, p, first, last)
        _introsort_loop(v, p, cut, last, depth)
        last = cut


def _partition_pivot(v, p, first: int, last: int) -> int:
    mid = first + (last - first) // 2
    _median_to_first(v, p, first, first + 1, mid, last - 1)
    return _unguarded_partition(v, p, first + 1, last, first)


def _median_to_first(v, p, result: int, a: int, b: int, c: int) -> None:
    if v[a] < v[b]:
        if v[b] < v[c]:
            _swap(v, p, result, b)
        elif v[a] < v[c]:
            _swap(v, p, result, c)
        else:
            _swap(v, p, result, a)
    elif v[a] < v[c]:
        _swap(v, p, result, a)
    elif v[b] < v[c]:
        _swap(v, p, result, c)
    else:
        _swap(v, p, result, b)


def _unguarded_partition(v, p, first: int, last: int, pivot: int) -> int:
    pv = v[pivot]
    while True:
        while v[first] < pv:
            first += 1
        last -= 1
        while pv < v[last]:
            last -= 1
        if not first < last:
            return first
        _swap(v, p, first, last)
        first += 1


def _final_insertion_sort(v, p, first: int, last: int) -> None:
    if last - first > _THRESHOLD:
        _insertion_sort(v, p, first, first + _THRESHOLD)
        for i in range(first + _THRESHOLD, last):
            _unguarded_linear_insert(v, p, i)
    else:
        _insertion_sort(v, p, first, last)


def _insertion_sort(v, p, first: int, last: int) -> None:
    if first == last:
        return
    for i in range(first + 1, last):
        if v[i] < v[first]:
            # move_backward(first, i, i + 1), then the value to the front
            val, idx = v[i], p[i]
            v[first + 1:i + 1] = v[first:i]
            p[first + 1:i + 1] = p[first:i]
            v[first], p[first] = val, idx
        else:
            _unguarded_linear_insert(v, p, i)


def _unguarded_linear_insert(v, p, last: int) -> None:
    val, idx = v[last], p[last]
    nxt = last - 1
    while val < v[nxt]:
        v[last], p[last] = v[nxt], p[nxt]
        last = nxt
        nxt -= 1
    v[last], p[last] = val, idx


# -- the heap sort past the depth limit (std::__partial_sort with middle ==
# last: __heap_select, which is make_heap here, then sort_heap) -------------

def _heap_sort(v, p, first: int, last: int) -> None:
    n = last - first
    if n >= 2:
        parent = (n - 2) // 2
        while True:
            _adjust_heap(v, p, first, parent, n, v[first + parent],
                         p[first + parent])
            if parent == 0:
                break
            parent -= 1
    while last - first > 1:
        last -= 1
        val, idx = v[last], p[last]
        v[last], p[last] = v[first], p[first]
        _adjust_heap(v, p, first, 0, last - first, val, idx)


def _adjust_heap(v, p, first: int, hole: int, n: int, val, idx) -> None:
    top = hole
    child = hole
    while child < (n - 1) // 2:
        child = 2 * (child + 1)
        if v[first + child] < v[first + child - 1]:
            child -= 1
        v[first + hole], p[first + hole] = v[first + child], p[first + child]
        hole = child
    if n % 2 == 0 and child == (n - 2) // 2:
        child = 2 * (child + 1)
        v[first + hole], p[first + hole] = (v[first + child - 1],
                                            p[first + child - 1])
        hole = child - 1
    # __push_heap
    parent = (hole - 1) // 2
    while hole > top and v[first + parent] < val:
        v[first + hole], p[first + hole] = v[first + parent], p[first + parent]
        hole = parent
        parent = (hole - 1) // 2
    v[first + hole], p[first + hole] = val, idx
