"""Red stage 1: genome-wide adjusted k-mer counts.

Rebuild of TableBuilder + EnrichmentMarkovView (TableBuilder.cpp:27-104,
EnrichmentMarkovView.cpp:69-215): count all k-mers of the genome into a
dense 4^k table, estimate the expected count of each k-mer under an order-o
Markov background, and keep score = round(observed - expected) when
observed >= minObs and observed > expected, else 0.

Everything is vectorized: background model tables are bincounts, conditional
probabilities are grouped normalizations, and the chain probability of all
4^k words is a product of gathered conditionals over digit windows.

One observable reference quirk is preserved: the reference's quaternary
string counter grows by a leading zero once it reaches words starting with
digit 3, so expectations for the last quarter of the table are computed for
the shifted word y//4 (EnrichmentMarkovView.cpp:196-213).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..io.fasta import SequenceRecord


def c_round(x):
    return np.where(np.asarray(x) < 0, np.ceil(np.asarray(x) - 0.5), np.floor(np.asarray(x) + 0.5))


def _word_counts(records: Sequence[SequenceRecord], k: int) -> np.ndarray:
    """Counts of length-k words over all segments of all records."""
    from ..kmer.counting import kmer_indices
    from ..native import count_words_raw

    counts = np.zeros(4**k, dtype=np.int64)
    for rec in records:
        if count_words_raw(rec.codes, rec.segments, k, counts):
            continue
        idx = kmer_indices(rec.codes, rec.segments, k)
        if len(idx):
            counts += np.bincount(idx, minlength=4**k)
    return counts


class EnrichmentTable:
    """The adjusted-count table Red scores against."""

    def __init__(self, records: Sequence[SequenceRecord], k: int, order: int,
                 min_obs: int, factor: float = 10000.0):
        if order < 0 or order >= k:
            raise ValueError("order must satisfy 0 <= order < k")
        self.k = k
        self.order = order
        self.min_obs = min_obs
        self.genome_length = int(sum(r.effective_size for r in records))
        l = self.genome_length  # EnrichmentMarkovView::count accumulates
        # segment lengths (EnrichmentMarkovView.cpp:69-82)

        observed = _word_counts(records, k)

        # background model tables for word lengths 1..order+1, each
        # normalized per 4-group to round(factor * conditional)
        # (EnrichmentMarkovView.cpp:89-108)
        probs: List[np.ndarray] = []
        for m in range(order + 1):
            cnt = _word_counts(records, m + 1).astype(np.float64)
            g = cnt.reshape(-1, 4)
            sums = g.sum(axis=1, keepdims=True)
            with np.errstate(invalid="ignore", divide="ignore"):
                p = c_round(factor * g / sums).reshape(-1)
            probs.append(p / factor)

        from ..native import red_chain_scores

        scores = red_chain_scores(observed, probs, k, order, float(l), min_obs)
        if scores is None:
            scores = self._chain_scores_numpy(observed, probs, k, order, l,
                                              min_obs)
        self.scores = scores
        self.max_value = int(scores.max()) if len(scores) else 0

    @staticmethod
    def _chain_scores_numpy(observed, probs, k, order, l, min_obs):
        """Vectorized fallback for the native fused chain (bitwise-identical
        multiplication order)."""
        d = 4**k
        y = np.arange(d, dtype=np.int64)
        # the shifted-word quirk: words starting with digit 3 use y // 4
        w = np.where(y >= 3 * (d // 4), y >> 2, y)

        # digits big-endian: digit j of word w is (w >> 2*(k-1-j)) & 3
        def window_value(word, j, length):
            """integer value of digits j..j+length-1 of `word`."""
            shift = 2 * (k - length - j)
            return (word >> shift) & ((1 << (2 * length)) - 1)

        chain = np.full(d, float(l))
        # lower-order prefix conditionals: models m=0..order-1 over prefix
        # digits (EnrichmentMarkovView.cpp:134-141)
        for m in range(order):
            chain *= probs[m][window_value(w, 0, m + 1)]
        # order-o sliding conditionals (EnrichmentMarkovView.cpp:144-170)
        top = probs[order]
        results_size = k - order - 1
        for i in range(results_size):
            chain *= top[window_value(w, i, order + 1)]
        chain *= top[window_value(w, results_size, order + 1)]

        keep = (observed >= min_obs) & (observed > chain)
        return np.where(keep, c_round(observed - chain), 0.0).astype(np.int64)

    def print_table(self, path: str) -> None:
        """-tbl output: one `digits -> value` row per k-mer."""
        k = self.k
        with open(path, "w") as f:
            for y, v in enumerate(self.scores):
                digits = "".join(
                    str((y >> (2 * (k - 1 - j))) & 3) for j in range(k)
                )
                f.write(f"{digits} -> {v}\n")
