"""Seeded synthetic genomes for Red: random sequence at a chosen GC share,
with planted copies of repeat families at up to a chosen divergence (half
of them reverse-complemented), runs of N and soft-masked (lowercase)
stretches, written as multi-record FASTA files.

    write_genome(directory, seed=7, total_bp=200_000, n_records=6, n_files=2)

Used by tests/test_torch_red.py at ~200 kbp and by chip_smoke.py's phase
(r) at a yeast-sized ~12.1 Mbp.  numpy only, so the card's machine (no
jax) can import it.
"""
from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

LINE = 60


def genome_records(seed: int, total_bp: int, n_records: int, gc: float = 0.38,
                   repeat_share: float = 0.06, n_families: int = 24,
                   max_divergence: float = 0.15, n_runs: int = 3,
                   soft_masked: int = 2) -> List[Tuple[str, str]]:
    """(header, sequence) records of `total_bp` bases in all."""
    rng = np.random.default_rng(seed)
    p = np.array([1 - gc, gc, gc, 1 - gc]) / 2           # A C G T
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    w = rng.uniform(0.5, 1.5, n_records)
    lens = (w / w.sum() * total_bp).astype(np.int64)
    lens[-1] += total_bp - lens.sum()
    fam_lens = np.exp(rng.uniform(np.log(150), np.log(6000), n_families))
    families = [rng.choice(4, size=int(n), p=p).astype(np.int8) for n in fam_lens]
    records = []
    for r, n in enumerate(lens):
        codes = rng.choice(4, size=int(n), p=p).astype(np.int8)
        covered = 0
        while covered < repeat_share * n:
            fam = families[rng.integers(n_families)]
            a = int(rng.integers(0, max(1, len(fam) - 100)))
            b = int(rng.integers(min(a + 100, len(fam)), len(fam) + 1))
            copy = fam[a:b].copy()
            if len(copy) >= n:
                continue
            mut = rng.random(len(copy)) < rng.uniform(0, max_divergence)
            copy[mut] = (copy[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
            if rng.random() < 0.5:
                copy = (3 - copy)[::-1]
            at = int(rng.integers(0, n - len(copy)))
            codes[at:at + len(copy)] = copy
            covered += len(copy)
        seq = letters[codes]
        for _ in range(n_runs):
            size = int(np.exp(rng.uniform(0, np.log(5000))))
            at = int(rng.integers(0, max(1, n - size)))
            seq[at:at + size] = ord("N")
        for _ in range(soft_masked):
            size = int(rng.integers(50, 2000))
            at = int(rng.integers(0, max(1, n - size)))
            seq[at:at + size] |= 0x20
        records.append((f"chr{r + 1} synthetic seed={seed}",
                        seq.tobytes().decode("ascii")))
    return records


def write_genome(directory: str, seed: int = 7, total_bp: int = 200_000,
                 n_records: int = 6, n_files: int = 2, **kw) -> List[str]:
    """Write the records over `n_files` .fa files in `directory`, the
    records dealt out in turn; returns the paths."""
    os.makedirs(directory, exist_ok=True)
    records = genome_records(seed, total_bp, n_records, **kw)
    paths = []
    for i in range(n_files):
        path = os.path.join(directory, f"part{i + 1}.fa")
        with open(path, "w") as f:
            for header, seq in records[i::n_files]:
                f.write(f">{header}\n")
                for j in range(0, len(seq), LINE):
                    f.write(seq[j:j + LINE] + "\n")
        paths.append(path)
    return paths
