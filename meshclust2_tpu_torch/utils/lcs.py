"""Longest-common-subsequence length.

Functional equivalent of the reference's LCSLen (utility/LCSLen.cpp:20-100):
a two-row O(min-memory) DP over inclusive [start, end] windows of two
sequences, returning only the LCS *length*.  (No reference binary calls it;
it is provided for inventory completeness, SURVEY §2.5.)

Instead of translating the scalar two-row loop, the DP is vectorized over
anti-diagonals: every cell on diagonal i+j=d depends only on diagonals d-1
(up/left) and d-2 (diag), so each diagonal is one numpy max over slices.
The recurrence max(up, left, diag + eq) is equivalent to the classic
if-equal/else form because adjacent LCS cells differ by at most 1.
"""
from __future__ import annotations

from typing import Union

import numpy as np


def _as_codes(seq: Union[str, bytes, np.ndarray]) -> np.ndarray:
    if isinstance(seq, str):
        return np.frombuffer(seq.encode("latin-1"), dtype=np.uint8)
    if isinstance(seq, (bytes, bytearray)):
        return np.frombuffer(bytes(seq), dtype=np.uint8)
    return np.asarray(seq)


def lcs_length(
    seq1: Union[str, bytes, np.ndarray],
    seq2: Union[str, bytes, np.ndarray],
    start1: int = 0,
    end1: int = -1,
    start2: int = 0,
    end2: int = -1,
) -> int:
    """LCS length over seq1[start1..end1] x seq2[start2..end2], ends
    inclusive (the reference's window convention, LCSLen.cpp:20-28);
    end=-1 means the last index."""
    a = _as_codes(seq1)
    b = _as_codes(seq2)
    if end1 < 0:
        end1 = len(a) - 1
    if end2 < 0:
        end2 = len(b) - 1
    if start1 < 0 or start2 < 0 or start1 > end1 or start2 > end2:
        raise ValueError(
            f"Invalid Input. Start1 is {start1}. End 1 is {end1}. "
            f"Start2 is {start2}. End2 is {end2}."
        )
    a = a[start1 : end1 + 1]
    b = b[start2 : end2 + 1]
    m, n = len(a), len(b)
    if m == 0 or n == 0:
        return 0

    # D[i] holds L[i, d-i] for the current diagonal d; out-of-range slots
    # stay 0, which doubles as the i=0 / j=0 boundary.
    prev2 = np.zeros(m + 1, dtype=np.int32)
    prev1 = np.zeros(m + 1, dtype=np.int32)
    for d in range(2, m + n + 1):
        lo = max(1, d - n)
        hi = min(m, d - 1)
        cur = np.zeros(m + 1, dtype=np.int32)
        i = np.arange(lo, hi + 1)
        eq = (a[i - 1] == b[d - i - 1]).astype(np.int32)
        cur[lo : hi + 1] = np.maximum(
            np.maximum(prev1[lo - 1 : hi], prev1[lo : hi + 1]),
            prev2[lo - 1 : hi] + eq,
        )
        prev2, prev1 = prev1, cur
    return int(prev1[m])
