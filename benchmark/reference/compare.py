"""What a job produced, held against the reference: counts of
disagreements (each held to 0) and the widest gap of the sampled GLM sums.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from .search import Found

# 100 sim is printed with %g, six significant digits; besides the half unit
# of the last printed digit, a printed value may sit this far from the
# reference's, which covers the two float64 evaluations' last bits and no
# more (the float32 control lies ~1e-5 off at 100)
VALUE_SLACK = 1e-7


def read_clstr(path: str) -> List[List[Tuple[str, bool]]]:
    """A CLSTR file's clusters, each a list of (header, marked center)."""
    clusters: List[List[Tuple[str, bool]]] = []
    with open(path) as f:
        for line in f:
            if line.startswith(">Cluster"):
                clusters.append([])
            elif line.strip():
                rest = line.rstrip("\n").split("\t", 1)[1].split("nt, ", 1)[1]
                clusters[-1].append((rest[:rest.rfind("... ")],
                                     rest.rstrip().endswith("*")))
    return clusters


def cluster_keys(clusters: Iterable[Sequence[Tuple[str, bool]]]) -> Dict[str, tuple]:
    """Each header's cluster as (its members, its marked centers)."""
    out = {}
    for cl in clusters:
        key = (frozenset(h for h, _ in cl), tuple(sorted(h for h, c in cl if c)))
        for h, _ in cl:
            out[h] = key
    return out


def clstr_off(reference: Dict[str, tuple], path: str) -> int:
    """Sequences whose cluster, or whose cluster's center, differs from the
    reference's, or that only one side has."""
    got = cluster_keys(read_clstr(path))
    return sum(reference.get(h) != got.get(h) for h in set(reference) | set(got))


def hist_off(ref_headers: List[str], ref_counts: np.ndarray,
             headers: List[str], counts: np.ndarray) -> int:
    """Sequences whose histogram differs from the reference's, or that only
    one side has."""
    at = {h: i for i, h in enumerate(headers)}
    rows = np.array([at.get(h, -1) for h in ref_headers], dtype=np.int64)
    have = rows >= 0
    same = np.zeros(len(ref_headers), dtype=bool)
    if counts.shape[1:] == ref_counts.shape[1:]:
        same[have] = (counts[rows[have]] == ref_counts[have]).all(axis=1)
    extra = len(set(headers) - set(ref_headers))
    return int((~same).sum()) + extra


def sum_gap(program: np.ndarray, reference: np.ndarray) -> float:
    """The widest gap between the program's GLM sums and the reference's,
    each over max(1, |the reference's|); inf where the program's is not
    finite."""
    if not len(program):
        return 0.0
    gap = np.abs(program - reference) / np.maximum(1.0, np.abs(reference))
    return float(np.where(np.isfinite(program), gap, np.inf).max())


def _half_unit(y: float) -> float:
    """Half a unit of the sixth significant digit of y."""
    return 0.5 * 10.0 ** (math.floor(math.log10(y)) - 5) if y > 0 else 0.0


def lines_off(found: Found, path: str) -> int:
    """Output lines that the reference does not give: a pair it does not
    keep, or a printed similarity more than half a printed unit (plus
    VALUE_SLACK) from its own; and the lines it gives that are missing.
    A pair within the decision's edge band may be there or not."""
    qi = {n: i for i, n in enumerate(found.query_names)}
    di = {n: i for i, n in enumerate(found.db_names)}
    nd = len(found.db_names)
    ref = {int(q) * nd + int(d): j for j, (q, d) in
           enumerate(zip(found.query.tolist(), found.db.tolist()))}
    seen = set()
    off = 0
    with open(path) as f:
        for line in f:
            q, d, v = line.rstrip("\n").split("\t")
            key = qi.get(q, -1) * nd + di.get(d, -1) if q in qi and d in di else -1
            j = ref.get(key)
            if j is None:
                off += 1
                continue
            seen.add(j)
            if found.near_edge[j] and not found.kept[j]:
                continue
            y, p = float(found.value[j]), float(v)
            if abs(p - y) > max(_half_unit(y), _half_unit(p)) + VALUE_SLACK:
                off += 1
    for j in np.nonzero(found.kept & ~found.near_edge
                        & (found.value > VALUE_SLACK))[0].tolist():
        if j not in seen:
            off += 1
    return off


def positives_off(found: Found, positives: int) -> int:
    """How far the program's count of kept pairs lies from the reference's,
    beyond the pairs within the decision's edge band."""
    return max(0, abs(positives - found.positives) - int(found.near_edge.sum()))
