"""Markov-random chromosome generation.

Functional equivalent of the reference's ChromosomeRandom
(nonltr/ChromosomeRandom.cpp:27-270): learn an order-`order` Markov chain
over the standard alphabet from a chromosome's valid segments, then emit a
random sequence of identical length/segment structure.  Used upstream only
as test scaffolding for Red's paper experiments (no shipped binary calls
it); provided for inventory completeness (SURVEY §2.4).

Behavioral parity points kept (the rest is re-expressed in vectorized
numpy):
  - every word count is initialized to 1 (initializeTable);
  - words containing any non-standard character are skipped (countWords —
    upstream logs "Ignoring" for them);
  - only segments with length > order+1 are generated; shorter ones (and
    everything outside segments) stay as the `unread` fill character;
  - the first `order` characters of each segment copy the original bases
    mapped through the IUPAC substitution table (R->G, Y->C, ..., X->G:
    ChromosomeRandom.cpp:56-72);
  - sampling uses the reference's integer percentage lottery: each symbol
    gets the interval [start, start + int(100*p)], consecutive intervals
    abut at end+1, and the draw is rng() % total (generateRandomSequence)
    — including its rounding bias.  The RNG itself is pluggable (upstream
    uses C rand() seeded by time, so there is no exact stream to match).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

# IUPAC fallback for the copied seed characters (ChromosomeRandom.cpp:56-72)
_SEED_MAP = {
    "A": "A", "C": "C", "G": "G", "T": "T",
    "R": "G", "Y": "C", "M": "A", "K": "T", "S": "G", "W": "T",
    "H": "C", "B": "T", "V": "A", "D": "T", "N": "C", "X": "G",
}


def _word_counts(base: str, segments: Sequence[Tuple[int, int]], n: int,
                 alphabet: str) -> np.ndarray:
    """[A^n] counts (pseudo-initialized to 1) of n-length words whose
    characters are all standard, over inclusive [s, e] segments."""
    a_count = len(alphabet)
    lut = np.full(256, -1, dtype=np.int64)
    for i, ch in enumerate(alphabet):
        lut[ord(ch)] = i
    counts = np.ones(a_count**n, dtype=np.int64)
    codes_all = lut[np.frombuffer(base.encode("latin-1"), dtype=np.uint8)]
    weights = (a_count ** np.arange(n - 1, -1, -1)).astype(np.int64)
    for s, e in segments:
        if e - s + 1 < n:
            continue
        codes = codes_all[s : e + 1]
        valid = codes >= 0
        # word ids via sliding windows (vectorized rolling hash)
        win = np.lib.stride_tricks.sliding_window_view(codes, n)
        ok = np.lib.stride_tricks.sliding_window_view(valid, n).all(axis=1)
        ids = (win * weights).sum(axis=1)[ok]
        counts += np.bincount(ids, minlength=a_count**n)
    return counts


def markov_random_chromosome(
    base: str,
    segments: Sequence[Tuple[int, int]],
    order: int,
    unread: str = "N",
    alphabet: str = "ACGT",
    rng: Optional[Callable[[], int]] = None,
    seed: Optional[int] = None,
) -> str:
    """Generate a random chromosome with base's length and segment layout.

    segments: inclusive (start, end) pairs of valid regions (the encoding
    layer's SequenceRecord.segments rows are exactly this shape).
    rng: a 0-argument callable returning a non-negative int (the lottery
    draws rng() % total); defaults to numpy's PCG64 on `seed`.
    """
    if order < 0:
        raise ValueError(
            f"The Markov order must be non-negative. The order received is: {order}."
        )
    n = order + 1
    a_count = len(alphabet)
    if rng is None:
        g = np.random.default_rng(seed)
        rng = lambda: int(g.integers(0, 2**31))

    counts = _word_counts(base, segments, n, alphabet)
    # per-prefix conditional probabilities (convertToProbabilities)
    probs = counts.reshape(-1, a_count).astype(np.float64)
    probs /= probs.sum(axis=1, keepdims=True)
    # integer lottery widths: int(100 * p) per symbol, interval end+1 steps
    widths = (100.0 * probs).astype(np.int64)
    totals = (widths + 1).sum(axis=1)  # chanceSoFar after the last entry
    starts = np.cumsum(widths + 1, axis=1) - (widths + 1)

    out = np.full(len(base), unread, dtype="U1")
    lut = np.full(256, -1, dtype=np.int64)
    for i, ch in enumerate(alphabet):
        lut[ord(ch)] = i
    for s, e in segments:
        if e - s + 1 <= n:
            continue
        # seed characters: original bases through the substitution map
        prefix = 0
        for w in range(s, s + n - 1):
            ch = _SEED_MAP.get(base[w].upper(), None)
            if ch is None:
                raise ValueError(f"unexpected character {base[w]!r} at {w}")
            out[w] = ch
            prefix = prefix * a_count + int(lut[ord(ch)])
        mod = a_count ** (n - 1)
        for h in range(s + n - 1, e + 1):
            row = prefix  # index of the (n-1)-prefix group
            r = rng() % int(totals[row])
            # interval membership: start_k <= r <= start_k + width_k
            k = int(np.searchsorted(starts[row], r, side="right")) - 1
            out[h] = alphabet[k]
            prefix = (prefix * a_count + k) % mod if n > 1 else 0
    return "".join(out)
