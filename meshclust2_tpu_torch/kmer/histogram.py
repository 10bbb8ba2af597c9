"""Plain dense histogram point.

Functional equivalent of the reference's Histogram<T> (clutil/Histogram.h,
Histogram.cpp — marked upstream as "Artifact from early development of
MeShClust" and never instantiated by any shipped binary; rebuilt for
inventory completeness, SURVEY §2.2).  Operations are vectorized numpy over
the bin vector instead of per-element loops; integer dtypes keep C's
truncating scale/divide semantics via explicit casts.

The upstream distance()/operator- throw "Not implemented" at runtime; the
commented-out body (Histogram.cpp:160-171) is an L1 distance, which is what
`distance` computes here — strictly more usable than parity-with-throw.
"""
from __future__ import annotations

import numpy as np


class RawHistogram:
    """A mutable dense histogram over fixed bins (Histogram<T> equivalent)."""

    def __init__(self, data, dtype=None):
        if isinstance(data, (int, np.integer)):  # Histogram(unsigned int size)
            self.points = np.zeros(int(data), dtype=dtype or np.int64)
        else:
            self.points = np.array(data, dtype=dtype) if dtype else np.asarray(data).copy()

    def scale(self, d: float) -> "RawHistogram":
        """operator*= : per-bin multiply, truncating back to the bin dtype."""
        self.points = (self.points * d).astype(self.points.dtype)
        return self

    def divide(self, d: float) -> "RawHistogram":
        """operator/= : per-bin divide, truncating back to the bin dtype."""
        self.points = (self.points / d).astype(self.points.dtype)
        return self

    def add(self, other: "RawHistogram") -> "RawHistogram":
        """operator+= over the common prefix of bins."""
        n = min(len(self.points), len(other.points))
        self.points[:n] += other.points[:n].astype(self.points.dtype)
        return self

    def strictly_less(self, other: "RawHistogram") -> bool:
        """operator< : true iff every common-prefix bin is strictly less."""
        n = min(len(self.points), len(other.points))
        return bool((self.points[:n] < other.points[:n]).all())

    def add_one(self) -> "RawHistogram":
        self.points += 1
        return self

    def sub_one(self) -> "RawHistogram":
        self.points -= 1
        return self

    def zero(self) -> "RawHistogram":
        self.points[:] = 0
        return self

    def magnitude(self) -> int:
        return int(self.points.astype(np.uint64).sum())

    def distance(self, other: "RawHistogram") -> int:
        """L1 distance over the common prefix (the upstream intent,
        Histogram.cpp:160-171)."""
        n = min(len(self.points), len(other.points))
        a = self.points[:n].astype(np.int64)
        b = other.points[:n].astype(np.int64)
        return int(np.abs(a - b).sum())

    def set(self, other: "RawHistogram") -> "RawHistogram":
        self.points = other.points.copy()
        return self

    def clone(self) -> "RawHistogram":
        return RawHistogram(self.points.copy())
