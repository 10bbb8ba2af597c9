"""Feature-set selection over cached single-feature tables.

Rebuild of the reference's selector layer (FeatureSelector.cpp,
BestFirstSelector.cpp, GreedySelector.cpp) re-expressed over dense numpy
matrices: all candidate feature sets share one [n_pairs, n_singles]
normalized singles table (the reference's ltable pair cache,
BestFirstSelector.cpp:112-128), so evaluating a set is just column products
plus a tiny closed-form GLM solve.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..features import flags as F
from .. import glm as G

# std::set<pair<uint64_t, Combo>> orders by (flags, enum value); the enum
# declaration order is xy, x2y2, xy2, x2y (Feature.h:66-71).
_COMBO_ENUM_ORDER = {F.COMBO_XY: 0, F.COMBO_X2Y2: 1, F.COMBO_XY2: 2, F.COMBO_X2Y: 3}

FeatPair = Tuple[int, str]  # (or'd single flags, combo kind)


def enumerate_feat_pairs(feat_flags: int) -> List[FeatPair]:
    """The candidate (pair, combo) enumeration (Predictor.cpp:199-218)."""
    singles = F.split_flags(feat_flags)
    out: List[FeatPair] = []
    for i in singles:
        for j in singles:
            if j > i:
                break
            out.append((i | j, F.COMBO_XY))
            out.append((i | j, F.COMBO_X2Y2))
            if i != j:
                out.append((i | j, F.COMBO_X2Y))
                out.append((i | j, F.COMBO_XY2))
    return out


@dataclass
class SinglesTable:
    """Normalized singles for one pair population."""

    singles: List[int]              # flags in lookup order
    raw: np.ndarray                 # [P, S] float64 raw values
    normalized: np.ndarray          # [P, S]
    labels: np.ndarray              # [P] (+/-1 for classification, value for regr)
    values: np.ndarray              # [P] identity values


def normalize_bounds(raw: np.ndarray, singles: List[int]) -> Tuple[np.ndarray, np.ndarray]:
    """min/max per single over the pair population (Feature.cpp:215-268)."""
    mins = raw.min(axis=0)
    maxs = raw.max(axis=0)
    for j, s in enumerate(singles):
        if s == F.FEAT_ALIGN:
            mins[j], maxs[j] = 0.0, 1.0
        if abs(maxs[j] - mins[j]) <= 1e-9:
            raise ValueError(
                f"feature {F.FEAT_NAMES.get(s, s)}: maximum distance cannot be zero"
            )
    return mins, maxs


def apply_normalization(raw: np.ndarray, singles: List[int], mins, maxs) -> np.ndarray:
    v = (raw - mins[None, :]) / (maxs - mins)[None, :]
    is_sim = np.array([F.FEAT_IS_SIM[s] for s in singles])
    return np.where(is_sim[None, :], v, 1.0 - v)


def combo_column(tbl_norm: np.ndarray, singles: List[int], fp: FeatPair) -> np.ndarray:
    flags_, kind = fp
    idxs = [singles.index(s) for s in F.split_flags(flags_)]
    if kind == F.COMBO_XY:
        return np.prod(tbl_norm[:, idxs], axis=1)
    if kind == F.COMBO_X2Y2:
        return np.prod(tbl_norm[:, idxs] ** 2, axis=1)
    if kind == F.COMBO_XY2:
        i0, i1 = idxs
        return tbl_norm[:, i0] * tbl_norm[:, i1] ** 2
    if kind == F.COMBO_X2Y:
        i0, i1 = idxs
        return tbl_norm[:, i0] ** 2 * tbl_norm[:, i1]
    raise ValueError(kind)


def design_matrix(tbl: SinglesTable, feat_set: Sequence[FeatPair]) -> np.ndarray:
    cols = [np.ones(len(tbl.labels))]
    for fp in feat_set:
        cols.append(combo_column(tbl.normalized, tbl.singles, fp))
    return np.stack(cols, axis=1)


def class_eval(train: SinglesTable, test: SinglesTable, feat_set: Sequence[FeatPair]):
    """class_train + class_test (FeatureSelector.cpp:57-103): returns
    (test_accuracy, weights, train_metrics, test_metrics).  The solve
    replicates the reference's Gauss-Jordan pseudo-inverse chain bit-for-bit
    (glm/exact.py); label predictions use fast matmuls (rounding decisions
    only flip at measure-zero boundaries)."""
    from ..glm.exact import train_glm_exact

    Xtr = design_matrix(train, feat_set)
    w = train_glm_exact(Xtr, train.labels)
    Xte = design_matrix(test, feat_set)

    def metrics(X, y):
        p = G.predict_labels(X, w)
        p = np.where(p == 0, -1.0, p)
        return G.accuracy(y, p)

    tr = metrics(Xtr, train.labels)
    te = metrics(Xte, test.labels)
    return te[0], w, tr, te


def sorted_feat_set(feat_set) -> List[FeatPair]:
    return sorted(feat_set, key=lambda fp: (fp[0], _COMBO_ENUM_ORDER[fp[1]]))


def feat_pair_name(fp: FeatPair) -> str:
    """Human-readable combo name, matching Feature::feat_names
    (Feature.cpp:271-299): single names in ascending flag order with ^2
    per the combo kind."""
    flags_, kind = fp
    names = [F.FEAT_NAMES[s] for s in F.split_flags(flags_)]
    if kind == F.COMBO_XY:
        return " * ".join(names)
    if kind == F.COMBO_X2Y2:
        return " * ".join(n + "^2" for n in names)
    if kind == F.COMBO_XY2 and len(names) == 2:
        return f"{names[0]} * {names[1]}^2"
    if kind == F.COMBO_X2Y and len(names) == 2:
        return f"{names[0]}^2 * {names[1]}"
    return " * ".join(names)


class CxxMaxHeap:
    """Exact libstdc++ std::priority_queue semantics (bits/stl_heap.h
    __push_heap / __pop_heap / __adjust_heap) with the reference's comparator
    `a.second < b.second` (BestFirstSelector.cpp:22-28), i.e. keyed on
    accuracy ONLY.  Tie order therefore matches the single-threaded
    reference's push order, which is what makes the best-first search
    terminate quickly when many candidate sets tie: the binary-heap sift
    pops recently pushed (larger) sets among ties, marching depth-first to
    the max_feat+1 frontier, where a Python heapq FIFO tie-break degrades
    into an exhaustive breadth-first sweep of all feature subsets."""

    def __init__(self):
        self.v: List[Tuple[float, frozenset]] = []

    def __len__(self) -> int:
        return len(self.v)

    def push(self, acc: float, fs) -> None:
        v = self.v
        v.append((acc, fs))
        hole = len(v) - 1
        value = v[hole]
        while hole > 0:  # __push_heap: sift up while comp(parent, value)
            parent = (hole - 1) // 2
            if v[parent][0] < value[0]:
                v[hole] = v[parent]
                hole = parent
            else:
                break
        v[hole] = value

    def pop(self) -> Tuple[float, frozenset]:
        v = self.v
        result = v[0]
        value = v.pop()  # old last element
        n = len(v)       # __len after shrink
        if n == 0:
            return result
        # __adjust_heap(first, holeIndex=0, len=n, value)
        hole = 0
        second = 0
        while second < (n - 1) // 2:
            second = 2 * (second + 1)
            if v[second][0] < v[second - 1][0]:
                second -= 1
            v[hole] = v[second]
            hole = second
        if (n & 1) == 0 and second == (n - 2) // 2:
            second = 2 * (second + 1)
            v[hole] = v[second - 1]
            hole = second - 1
        # __push_heap(first, hole, top=0, value)
        while hole > 0:
            parent = (hole - 1) // 2
            if v[parent][0] < value[0]:
                v[hole] = v[parent]
                hole = parent
            else:
                break
        v[hole] = value
        return result


def best_first_select(
    train: SinglesTable,
    test: SinglesTable,
    possible: List[FeatPair],
    min_feat: int,
    max_feat: int,
    verbose: bool = True,
) -> Tuple[List[FeatPair], np.ndarray, Tuple, Tuple]:
    """Best-first search over feature-pair sets
    (BestFirstSelector.cpp:186-250)."""
    if verbose:
        print("Calculating all features")  # BestFirstSelector.cpp:197
    open_set: set = set()
    closed: set = set()
    heap = CxxMaxHeap()

    def children_of(fs: frozenset) -> List[frozenset]:
        out = []
        for fp in possible:
            child = fs ^ {fp}
            if child and child not in closed and child not in open_set:
                out.append(child)
        return out

    def evaluate(children: List[frozenset]):
        from ..utils.progress import Progress

        mx = max((len(s) for s in open_set), default=1)
        # BestFirstSelector.cpp:165-168
        prog = Progress(len(children), f"Evaluating features {mx}/{max_feat}")
        for child in children:
            acc, _, _, _ = class_eval(train, test, sorted_feat_set(child))
            open_set.add(child)
            heap.push(acc, child)
            prog.step()
        prog.end()

    best_set: Optional[frozenset] = None
    best_acc = -100.0
    last_best_changed = 0
    evaluate(children_of(frozenset()))
    iteration = 0
    while open_set:
        sizes = [len(s) for s in open_set]
        mx = max(sizes)
        if mx > max_feat or (iteration - last_best_changed >= 3 and mx > min_feat):
            break
        acc, fs = heap.pop()
        open_set.discard(fs)
        closed.add(fs)
        if acc > best_acc and min_feat <= len(fs) <= max_feat:
            best_set = fs
            best_acc = acc
            last_best_changed = iteration
        evaluate(children_of(fs))
        iteration += 1

    assert best_set is not None, "best-first selection found no feature set"
    final = sorted_feat_set(best_set)
    te_acc, w, tr_m, te_m = class_eval(train, test, final)
    if verbose:
        print(f"Training ACC: {tr_m[0]:g} {tr_m[1]:g} {tr_m[2]:g}")
        print(f"Testing ACC: {te_m[0]:g} {te_m[1]:g} {te_m[2]:g}")
        print("Features: ")  # BestFirstSelector.cpp:245-248
        for fp in final:
            print(f"\t{feat_pair_name(fp)}")
    return final, w, tr_m, te_m


def greedy_select_regression(
    train: SinglesTable,
    test: SinglesTable,
    possible: List[FeatPair],
    max_feat: int,
    verbose: bool = True,
) -> Tuple[List[FeatPair], np.ndarray]:
    """Forward greedy selection minimizing mean |error|
    (GreedySelector.cpp:10-76)."""

    from ..glm.exact import train_glm_exact

    def regr_eval(feat_set):
        X = design_matrix(train, feat_set)
        w = train_glm_exact(X, train.values)
        Xte = design_matrix(test, feat_set)
        # mean |err| accumulated like FeatureSelector.cpp:76-88
        err = np.abs(Xte @ w - test.values).sum() / len(test.values)
        tr_err = np.abs(X @ w - train.values).sum() / len(train.values)
        return err, w, tr_err

    selected: List[FeatPair] = []
    used: set = set()
    abs_best = 1e6
    for _ in range(max_feat):
        best_err = abs_best
        best_fp = None
        for fp in possible:
            if fp in used:
                continue
            err, _, _ = regr_eval(selected + [fp])
            if err < best_err:
                best_err = err
                best_fp = fp
        if best_fp is not None and best_err < abs_best:
            selected.append(best_fp)
            used.add(best_fp)
            abs_best = best_err
    err, w, tr_err = regr_eval(selected)
    if verbose:
        # GreedySelector.cpp:59-73
        print(f"Training Mean Error: {tr_err:g}")
        print(f"Testing Mean Error: {err:g}")
        print("Features: ")
        for fp in selected:
            print(f"\t{feat_pair_name(fp)}")
        for wv in np.asarray(w).ravel():
            print(f"weight: {wv:g} ")
    return selected, w


def greedy_select_class(
    train: SinglesTable,
    test: SinglesTable,
    possible: List[FeatPair],
    min_feat: int,
    max_feat: int,
) -> Tuple[List[FeatPair], np.ndarray]:
    """Forward greedy classification selection (GreedySelector.cpp:78-147).

    Inventory-parity component: like the reference's train_class, it has no
    live caller (BestFirst is the classification path)."""
    selected: List[FeatPair] = []
    used: set = set()
    abs_best = 0.0
    for num_feat in range(1, max_feat + 1):
        best_acc = abs_best
        best_fp = None
        for fp in possible:
            if fp in used:
                continue
            acc, _, _, _ = class_eval(train, test, selected + [fp])
            if acc > best_acc:
                best_acc = acc
                best_fp = fp
        if best_fp is not None and (best_acc > abs_best or num_feat <= min_feat):
            selected.append(best_fp)
            used.add(best_fp)
            abs_best = best_acc
    _, w, _, _ = class_eval(train, test, selected)
    return selected, w
