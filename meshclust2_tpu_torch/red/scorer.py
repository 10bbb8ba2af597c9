"""Red per-base scoring (Scorer.cpp:29-143).

Each base of a segment gets the adjusted count of the k-mer starting there;
the last k-1 bases of a segment repeat the final full window's score.
takeLog maps nonzero scores to ceil(log(score)/log(base)), with base 1
adjusted to 1.5 and scores of 1 left alone in that case.
"""
from __future__ import annotations

import math

import numpy as np

from ..io.fasta import SequenceRecord
from ..kmer.counting import kmer_indices
from .table import EnrichmentTable


class ChromScores:
    def __init__(self, record: SequenceRecord, table: EnrichmentTable):
        from ..native import red_score_bases

        self.record = record
        self.k = table.k
        n = len(record.codes)
        k = table.k
        scores = red_score_bases(record.codes, record.segments, k, table.scores)
        if scores is None:
            scores = np.zeros(n, dtype=np.int64)
            for s, e in record.segments:
                m = e - s + 2 - k
                if m > 0:
                    idx = kmer_indices_segment(record.codes, s, e, k)
                    scores[s : s + m] = table.scores[idx]
                    scores[s + m : e + 1] = scores[s + m - 1]
                # segments shorter than k keep zeros (wholesaleValueOf is
                # never called; the tail-fill loop copies zeros)
        self.scores = scores
        seg_mask = np.zeros(n, dtype=bool)
        for s, e in record.segments:
            seg_mask[s : e + 1] = True
        self._seg_mask = seg_mask
        self.max = int(scores[seg_mask].max()) if seg_mask.any() else -1

    def count_less_or_equal(self, thr: float) -> int:
        return int((self.scores[self._seg_mask] <= thr).sum())

    def take_log(self, base: float) -> None:
        """(Scorer.cpp:50-72)"""
        is_one = abs(base - 1.0) < np.finfo(float).eps
        log_base = math.log(1.5) if is_one else math.log(base)
        s = self.scores
        m = self._seg_mask & (s != 0)
        if is_one:
            m &= s > 1
        vals = s[m].astype(np.float64)
        s[m] = np.ceil(np.log(vals) / log_base).astype(np.int64)

    def write(self, f, header: str) -> None:
        """-sco output format (Scorer.cpp:82-103)."""
        f.write(header + "\n")
        s = self.scores
        for i in range(0, len(s), 50):
            f.write(" ".join(str(int(v)) for v in s[i : i + 50]) + " \n")
        f.write("\n")


def kmer_indices_segment(codes: np.ndarray, s: int, e: int, k: int) -> np.ndarray:
    n = e - s + 2 - k
    v = np.zeros(n, dtype=np.int64)
    for j in range(k):
        v = v * 4 + codes[s + j : s + j + n]
    return v
