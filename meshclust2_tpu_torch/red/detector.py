"""Red candidate-region detection (DetectorMaxima.cpp, ChromDetectorMaxima.cpp).

Per segment: Gaussian-smooth the raw scores, take boxcar first/second
derivatives, find zero-crossing maxima that sit in high-scoring
neighborhoods, split runs of maxima at low-scoring separators, and extend
the resulting regions outward while the local fraction of low scores stays
under the percentage threshold.

Smoothing and derivatives are vectorized (convolution / sliding sums); the
region extension walk is per-region, matching the reference's sequential
merge semantics.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np


def c_round(x):
    x = np.asarray(x, dtype=np.float64)
    return np.where(x < 0, np.ceil(x - 0.5), np.floor(x + 0.5))


class DetectorMaxima:
    """One segment's candidate regions (DetectorMaxima.cpp:23-516)."""

    def __init__(self, seg_start: int, seg_end: int, s: float, w: int,
                 m: float, t: float, p: float, e: int, o_scores: np.ndarray,
                 lt_prefix: np.ndarray = None):
        self.seg_start = seg_start
        self.seg_end = seg_end
        self.s = int(s)
        self.half_s = int(s)  # halfS = s (DetectorMaxima.cpp:38)
        self.w = int(w)
        self.m = m
        self.t = t
        self.p = p
        self.e = int(e)
        self.o_scores = o_scores
        if lt_prefix is not None:
            self._lt_pre = lt_prefix
        self.regions: List[List[int]] = []

        smoothed = self._smooth()
        first, second = self._derivatives(smoothed)
        maxima = self._find_maxima(first, second)
        separators = self._find_separators(maxima)
        self._find_regions(maxima, separators)
        self._extend_regions()

    # ------------------------------------------------------------------

    def _smooth(self) -> np.ndarray:
        """Gaussian mask of width 2s+1, sigma=s/3.5, weight-normalized at
        boundaries (DetectorMaxima.cpp:132-203)."""
        s = self.s
        sigma = s / 3.5
        i = np.arange(2 * s + 1)
        mask = np.exp(-((i - s) ** 2) / (2 * sigma**2)) / math.sqrt(
            2 * math.pi * sigma**2
        )
        seg = self.o_scores[self.seg_start : self.seg_end + 1].astype(np.float64)
        num = np.convolve(seg, mask[::-1], mode="same")
        den = np.convolve(np.ones_like(seg), mask[::-1], mode="same")
        # np.convolve 'same' centers the kernel; the mask is symmetric so
        # orientation is irrelevant, and dividing by the local weight sum
        # reproduces the boundary normalization.
        return num / den

    def _derivatives(self, scores: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Boxcar first/second differences over window w
        (DetectorMaxima.cpp:205-266): for i in [w, len-w):
          first[i-w]  = round(right_sum - left_sum)
          second[i-w] = round(left_sum + right_sum - 2w * scores[i])
        with left = sum(scores[i-w .. i-1]), right = sum(scores[i+1 .. i+w])."""
        w = self.w
        n = len(scores)
        if n < 2 * w + 1:
            return np.zeros(0), np.zeros(0)
        from ..native import red_derivatives

        nat = red_derivatives(scores, w)
        if nat is not None:
            return nat
        c = np.concatenate([[0.0], np.cumsum(scores)])
        i = np.arange(w, n - w)
        left = c[i] - c[i - w]
        right = c[i + w + 1] - c[i + 1]
        first = c_round(right - left)
        second = c_round(left + right - 2 * w * scores[i])
        return first, second

    def _lt_prefix(self) -> np.ndarray:
        """Lazily cached prefix counts of o_scores < t, so every
        below-threshold window count is two gathers."""
        pre = getattr(self, "_lt_pre", None)
        if pre is None:
            pre = np.zeros(len(self.o_scores) + 1, dtype=np.int64)
            np.cumsum(self.o_scores < self.t, out=pre[1:])
            self._lt_pre = pre
        return pre

    def _find_maxima(self, first: np.ndarray, second: np.ndarray) -> List[int]:
        """(DetectorMaxima.cpp:268-321), vectorized: zero crossings of the
        first derivative with negative second derivative, magnitude above m,
        and a below-threshold fraction under p around the peak."""
        if len(first) < 2:
            return []
        f0, f1 = first[:-1], first[1:]
        cross = (f1 == 0) | ((f0 < 0) & (f1 > 0)) | ((f0 > 0) & (f1 < 0))
        cand = np.nonzero(cross & (second[1:] < 0))[0] + 1
        if not len(cand):
            return []
        cand = cand[np.abs(first[cand - 1] - first[cand]) > self.m]
        if not len(cand):
            return []
        peaks = cand + self.w + self.seg_start
        ps = np.maximum(peaks - self.half_s, self.seg_start)
        pe = np.minimum(peaks + self.half_s, self.seg_end)
        pre = self._lt_prefix()
        count = pre[pe + 1] - pre[ps]
        v = 100.0 * count / (pe - ps + 1)
        return [int(p) for p in peaks[v < self.p]]

    def _find_separators(self, maxima: List[int]) -> List[Tuple[int, int]]:
        """(DetectorMaxima.cpp:333-358)"""
        if len(maxima) < 2:
            return []
        pre = self._lt_prefix()
        mx = np.asarray(maxima, dtype=np.int64)
        s, e = mx[:-1], mx[1:]
        v = 100.0 * (pre[e + 1] - pre[s]) / (e - s + 1)
        return [(int(a), int(b)) for a, b in zip(s[v >= self.p], e[v >= self.p])]

    def _find_regions(self, maxima: List[int], separators) -> None:
        """(DetectorMaxima.cpp:360-384)"""
        if not maxima:
            return
        start = maxima[0]
        for s, e in separators:
            self.regions.append([start, s])
            start = e
        self.regions.append([start, maxima[-1]])

    def _extend_regions(self) -> None:
        """(DetectorMaxima.cpp:389-516)"""
        o = self.o_scores
        t = self.t
        e_step = self.e
        gg = 0
        while gg < len(self.regions):
            region = self.regions[gg]
            region_start, region_end = region
            if region_start == region_end:
                region_start = max(region_start - self.half_s, self.seg_start)
                region[0] = region_start
                region_end = min(region_end + self.half_s, self.seg_end)
                region[1] = region_end

            # left: step outward while low-score fraction stays under p
            l_end = self.seg_start if gg == 0 else self.regions[gg - 1][1]
            u = region_start
            while u >= l_end:
                d = max(u - e_step + 1, l_end)
                v = 100.0 * int((o[d : u + 1] < t).sum()) / e_step
                if v >= self.p:
                    break
                region_start = d
                u -= e_step
            # left: per-base erode/extend (DetectorMaxima.cpp:429-444)
            if o[region_start] < t:
                for a in range(region_start, region_end):
                    if o[a] >= t:
                        region_start = a
                        break
            else:
                a = region_start
                while a >= l_end:
                    if o[a] >= t:
                        region_start = a
                    else:
                        break
                    a -= 1
            region[0] = region_start

            # right: step outward
            r_end = self.seg_end if gg == len(self.regions) - 1 else self.regions[gg + 1][0]
            u = region_end
            while u <= r_end:
                d = min(u + e_step - 1, r_end)
                v = 100.0 * int((o[u : d + 1] < t).sum()) / e_step
                if v >= self.p:
                    break
                region_end = d
                u += e_step
            # right: per-base erode/extend
            if o[region_end] < t:
                for a in range(region_end, region_start, -1):
                    if o[a] >= t:
                        region_end = a
                        break
            else:
                a = region_end
                while a <= r_end:
                    if o[a] >= t:
                        region_end = a
                    else:
                        break
                    a += 1
            region[1] = region_end

            # merge with previous if overlapping
            if gg > 0:
                prev = self.regions[gg - 1]
                if _overlapping(prev[0], prev[1], region_start, region_end):
                    prev[1] = region_end
                    del self.regions[gg]
                else:
                    gg += 1
            if gg == 0:
                gg += 1


def _overlapping(s1, e1, s2, e2) -> bool:
    """Util::isOverlapping semantics: closed intervals share a base."""
    return not (e1 < s2 or e2 < s1)


def detect_chrom(
    s: float, w: float, m: float, t: float, p: float, e: int,
    o_scores: np.ndarray, segments: np.ndarray,
) -> List[Tuple[int, int]]:
    """ChromDetectorMaxima::start (ChromDetectorMaxima.cpp:27-58): run the
    detector per segment, skipping segments shorter than 2w+10."""
    out: List[Tuple[int, int]] = []
    eff_len = 2 * w + 10
    # shared below-threshold prefix: one cumsum per chromosome instead of
    # one full-length cumsum per segment (O(n) vs O(n_segments * n))
    lt_prefix = np.zeros(len(o_scores) + 1, dtype=np.int64)
    np.cumsum(o_scores < t, out=lt_prefix[1:])
    for seg_start, seg_end in segments:
        if seg_end - seg_start + 1 > eff_len:
            det = DetectorMaxima(int(seg_start), int(seg_end), s, int(w), m, t,
                                 p, e, o_scores, lt_prefix=lt_prefix)
            out.extend((r[0], r[1]) for r in det.regions)
    return out
