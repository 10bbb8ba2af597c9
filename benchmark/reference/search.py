"""fastcar's all-vs-query search (FC_Runner.cpp:426-471), in plain form.

Each block of up to `chunk` database records against up to `chunk` query
records: the database rows sorted by length, every query paired with the
rows whose lengths lie in [int(len sim), int(len / sim)] (the start found by
the upstream binary search with its quirks, the end by the first longer
row), each pair kept where the classifier says positive, and a kept pair's
similarity the regression head's sum clipped to [0, 1].  A kept pair with a
similarity above 0 gives the line `query<TAB>db<TAB>100 sim` (printf's %g),
the headers cut after their first blank.  Which of two equal-length rows
comes first does not change which pairs a window holds, so a stable sort
serves.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from . import model as M
from .histograms import Records, histograms

# a pair whose classifier sum lies this near the decision's edge may go
# either way between two float64 evaluations of the same formulas in
# different orders (the program's and this one's differ in the last bits)
EDGE_BAND = 1e-9


@dataclass
class Found:
    """The search's result: every query's and db record's printed header,
    the count of kept pairs, and the pairs that are kept or lie within
    EDGE_BAND of the decision's edge: their query and db indices, the
    printed similarity as a number (100 sim), kept, near the edge."""
    query_names: List[str]
    db_names: List[str]
    positives: int
    query: np.ndarray
    db: np.ndarray
    value: np.ndarray
    kept: np.ndarray
    near_edge: np.ndarray


def format_header(h: str) -> str:
    """Without the '>', cut after the first blank, which stays."""
    b = 1 if h.startswith(">") else 0
    for i in range(b, len(h)):
        if h[i] in " \t":
            return h[b:i + 1]
    return h[b:]


def bin_search(lengths: np.ndarray, length: int) -> int:
    """The window's first row (FC_Runner.cpp:390-408), quirks and all."""
    begin, last = 0, len(lengths) - 1
    while True:
        if last < begin:
            return 0
        idx = begin + (last - begin) // 2
        v = int(lengths[idx])
        if v == length:
            while idx > 0 and int(lengths[idx - 1]) == length:
                idx -= 1
            return idx
        if v > length:
            if begin == idx:
                return idx
            last = idx - 1
        else:
            begin = idx + 1


def _subset(rec: Records, lo: int, hi: int) -> Records:
    return Records(rec.headers[lo:hi], rec.codes[rec.offsets[lo]:rec.offsets[hi]],
                   rec.offsets[lo:hi + 1] - rec.offsets[lo])


def search(db: Records, queries: Records, w: M.Weights, device,
           chunk: int = 10000, dtype=np.float64) -> Found:
    dt = np.dtype(dtype)
    sim = w.id_cutoff
    parts = []
    positives = 0
    for q0 in range(0, len(queries.headers), chunk):
        q = _subset(queries, q0, min(len(queries.headers), q0 + chunk))
        for d0 in range(0, len(db.headers), chunk):
            d = _subset(db, d0, min(len(db.headers), d0 + chunk))
            order = np.argsort(d.lengths, kind="stable")
            dlen = d.lengths[order]
            starts = np.array([bin_search(dlen, int(l * sim)) for l in q.lengths],
                              dtype=np.int64)
            ends = np.maximum(starts, np.searchsorted(
                dlen, (q.lengths / sim).astype(np.int64), side="right"))
            per = ends - starts
            total = int(per.sum())
            q_arr = np.repeat(np.arange(len(q.headers)), per)
            a_arr = order[np.repeat(starts, per)
                          + (np.arange(total) - np.repeat(np.cumsum(per) - per, per))]
            counts = torch.cat([histograms(d, w.k, w.datatype, device),
                                histograms(q, w.k, w.datatype, device)])
            pool = M.Pool(counts, np.concatenate([d.lengths, q.lengths]))
            kept, value, near = _score(pool, w, a_arr, q_arr + len(d.headers), dt)
            positives += int(kept.sum())
            sel = np.nonzero(kept | near)[0]
            parts.append((q_arr[sel] + q0, a_arr[sel] + d0, value[sel], kept[sel],
                          near[sel]))
            del pool, counts
    cols = [np.concatenate([p[i] for p in parts]) if parts else np.zeros(0)
            for i in range(5)]
    return Found([format_header(h) for h in queries.headers],
                 [format_header(h) for h in db.headers], positives, *cols)


def _score(pool: M.Pool, w: M.Weights, a: np.ndarray, b: np.ndarray, dt):
    """(kept, 100 sim, near the edge) of the pairs, in blocks."""
    p = len(a)
    kept = np.ones(p, dtype=bool)
    near = np.zeros(p, dtype=bool)
    value = np.full(p, 100, dtype=dt)
    step = 1 << 22
    for s in range(0, p, step):
        sl = slice(s, min(p, s + step))
        if w.classifier is not None:
            sc, _ = M.glm(w.classifier, M.raw_singles(w.classifier, pool, a[sl], b[sl], dt))
            kept[sl] = M.positive(M.prob(sc))
            near[sl] = np.abs(sc) <= EDGE_BAND
        if w.regressor is not None:
            ks = np.nonzero(kept[sl])[0] + s
            value[sl] = 0
            if len(ks):
                sr, _ = M.glm(w.regressor, M.raw_singles(w.regressor, pool, a[ks], b[ks], dt))
                value[ks] = dt.type(100) * np.clip(sr, 0, 1).astype(dt)
    return kept, value, near
