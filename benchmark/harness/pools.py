"""Sequence pools for the benchmark's jobs, made from a seed.

A pool is `n_seqs` DNA sequences drawn from `n_templates` random templates
(`n_seqs / n_templates` a template): each template's length is uniform in
[len_lo, len_hi), each sequence deletes a base with probability 0.3 r and
replaces one (by a uniform base, possibly the same) with probability 0.7 r,
r uniform in [rate_lo, rate_hi) a sequence.  The draws, their order and the
file's bytes are those of the repository's historical bench set (`bench.py:
ensure_dataset`, seed 424242): pool 0 of seed 424242 at 10,000 sequences is
that file byte for byte.

The template lengths and the mutation rates set how much work a pool is,
so every seed gets the same ones: those that seed 424242's draws give pool
j (read from its stream by skipping the bases' draws, `_historical_sizes`).
The seed draws everything else, its own lengths and rates drawn and set
aside, so seed 424242 is the historical generator itself.  Pool j of a run
comes from the seed sequence (seed, j), and pool 0 from the seed alone.
Only the writing is new: each record is laid out in one buffer.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

HISTORICAL_SEED = 424242
_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_NEWLINE = 10


def pool_rng(seed: int, pool: int) -> np.random.Generator:
    """The generator of pool `pool` of a run seeded `seed`."""
    entropy = seed % (1 << 64)
    return np.random.default_rng(entropy if pool == 0 else [entropy, pool])


def wrap(seq: np.ndarray, width: int) -> np.ndarray:
    """The bytes of `seq` in lines of `width`, each ended by a newline."""
    n = len(seq)
    lines = -(-n // width)
    out = np.full(n + lines, _NEWLINE, dtype=np.uint8)
    idx = np.arange(n)
    out[idx + idx // width] = seq
    return out


def _skip32(bg, has: int, cached: int, n: int) -> Tuple[int, int]:
    """Advance the PCG64 bit generator past n of numpy's 32-bit draws, each
    of which takes the half that a 64-bit draw left cached (has, cached),
    else a fresh 64-bit draw whose upper half it caches; returns the cache
    after them.  (The generator's own cache, which advance() clears, is
    kept by the caller.)"""
    if n and has:
        n, has, cached = n - 1, 0, 0
    if n:
        whole = (n + 1) // 2
        if n % 2:
            bg.advance(whole - 1)
            has, cached = 1, int(bg.random_raw()) >> 32
        else:
            bg.advance(whole)
            has, cached = 0, 0
    return has, cached


def _historical_sizes(pool: int, n_templates: int, per: int, len_lo: int,
                      len_hi: int, rate_lo: float, rate_hi: float
                      ) -> Tuple[List[int], List[List[float]]]:
    """The template lengths and mutation rates of seed 424242's pool: its
    draws replayed, the bases' skipped (64-bit ones for r, 32-bit ones for
    the bases)."""
    rng = pool_rng(HISTORICAL_SEED, pool)
    bg = rng.bit_generator
    lengths, rates = [], []
    for _ in range(n_templates):
        tl = int(rng.integers(len_lo, len_hi))
        st = bg.state
        has, cached = _skip32(bg, st["has_uint32"], st["uinteger"], tl)
        row = []
        for _ in range(per):
            row.append(rng.uniform(rate_lo, rate_hi))
            bg.advance(tl)
            has, cached = _skip32(bg, has, cached, tl)
        st = bg.state
        st["has_uint32"], st["uinteger"] = has, cached
        bg.state = st
        lengths.append(tl)
        rates.append(row)
    return lengths, rates


def pool_bytes(seed: int, pool: int, n_seqs: int, n_templates: int,
               len_lo: int, len_hi: int, rate_lo: float, rate_hi: float,
               line: int = 70) -> bytes:
    """The FASTA text of one pool."""
    per = n_seqs // n_templates
    lengths, rates = _historical_sizes(pool, n_templates, per, len_lo, len_hi,
                                       rate_lo, rate_hi)
    rng = pool_rng(seed, pool)
    parts = []
    for t in range(n_templates):
        rng.integers(len_lo, len_hi)        # the seed's own length, set aside
        tl = lengths[t]
        tmpl = rng.integers(0, 4, tl)
        for j in range(per):
            rng.uniform(rate_lo, rate_hi)   # and its own rate
            rate = rates[t][j]
            r = rng.random(tl)
            keep = r >= rate * 0.3
            sub = r < rate * 0.7
            seq = np.where(sub, rng.integers(0, 4, tl), tmpl)[keep]
            parts.append(f">seq{t}_{j} template_{t}\n".encode())
            parts.append(wrap(_BASES[seq], line).tobytes())
    return b"".join(parts)


def write_pool(path: str, seed: int, pool: int, traffic: dict) -> int:
    """Write pool `pool` of the traffic mix to `path`; returns its
    sequence count."""
    data = pool_bytes(seed, pool, traffic["n_seqs"], traffic["n_templates"],
                      traffic["len_lo"], traffic["len_hi"],
                      traffic["rate_lo"], traffic["rate_hi"])
    with open(path, "wb") as f:
        f.write(data)
    return (traffic["n_seqs"] // traffic["n_templates"]) * traffic["n_templates"]
