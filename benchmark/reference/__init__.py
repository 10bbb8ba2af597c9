"""The benchmark's plain reference: what a clustering or search job should
produce from the same FASTA and weights, in NumPy and PyTorch, with
nothing of the program imported or taken from its state."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from . import model as M
from .histograms import histograms, read_fasta, reference_order
from .meanshift import MeanShift
from .search import Found, search


@dataclass
class Clustering:
    headers: List[str]          # in the reference's row order
    counts: np.ndarray          # [N, D] histograms in that order
    keys: Dict[str, tuple]      # header -> (members, marked centers)
    steps: int                  # accumulate steps
    pool: M.Pool
    head: M.Head

    def rows(self, headers: List[str]) -> np.ndarray:
        """The reference's row of each header (-1 for one it lacks)."""
        at = {h: i for i, h in enumerate(self.headers)}
        return np.array([at.get(h, -1) for h in headers], dtype=np.int64)

    def sums(self, a: np.ndarray, b: np.ndarray, dtype=np.float64) -> np.ndarray:
        """The classifier's GLM sums of the pairs (a[i], b[i]) of rows."""
        return M.glm(self.head, M.raw_singles(self.head, self.pool, a, b, dtype))[0]


def cluster(fasta: str, weights: str, device, delta: int = 5,
            iterations: int = 15, dtype=np.float64) -> Clustering:
    """The recover path's clustering of one FASTA file."""
    w = M.read_weights(weights)
    rec = read_fasta(fasta)
    order = reference_order(rec)
    counts = histograms(rec, w.k, w.datatype, device)[
        torch.as_tensor(order, device=device)]
    pool = M.Pool(counts, rec.lengths[order])
    ms = MeanShift(pool, w.classifier, w.id_cutoff, delta, iterations, dtype)
    headers = [rec.headers[i] for i in order.tolist()]
    keys = {}
    for cl in ms.run():
        names = frozenset(headers[r] for r in cl.members)
        key = (names, (headers[cl.center],) if cl.center in cl.members else ())
        for r in cl.members:
            keys[headers[r]] = key
    return Clustering(headers, counts.cpu().numpy(), keys, ms.steps, pool,
                      w.classifier)


def search_all(db: str, queries: str, weights: str, device,
               chunk: int = 10000, dtype=np.float64) -> Found:
    """fastcar's recover search of `queries` against `db`, in blocks of up
    to `chunk` records of each."""
    return search(read_fasta(db), read_fasta(queries), M.read_weights(weights),
                  device, chunk=chunk, dtype=dtype)
