"""weights.txt serialization — the train/cluster decoupling seam.

Reads and writes the reference's exact text format (Predictor.cpp:27-121 for
writing, Predictor.cpp:46-185 for reading):

    k: <k>
    mode: <uint>
    max_features: <n>
    ID: <id>
    Datatype: <uint8_t|...>
    feature_set: <uint64>

    n_combos: <n>
    <bias weight w0>
    <combo_code> <or'd single flags> <weight>      (xN)

    n_singles: <n>
    <single flag> <min> <max>                      (xN)

with one block per trained model (classification first, then regression when
mode includes PRED_MODE_REGR).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..features import flags as F

PRED_MODE_CLASS = 1
PRED_MODE_REGR = 2


@dataclass
class ModelBlock:
    """One trained GLM head: combos over singles with normalization bounds."""

    combos: List[Tuple[str, int]]       # (combo kind, or'd flags) per combo
    weights: np.ndarray                 # [n_combos + 1] float64, w[0] = bias
    singles: List[int]                  # single flags in lookup order
    mins: np.ndarray                    # [n_singles]
    maxs: np.ndarray                    # [n_singles]

    def combo_indices(self) -> List[Tuple[str, List[int]]]:
        """Resolve each combo's or'd flags to indices into `singles`
        (add_feature, Feature.cpp:102-127)."""
        out = []
        for kind, fl in self.combos:
            idxs = [self.singles.index(s) for s in F.split_flags(fl)]
            out.append((kind, idxs))
        return out


@dataclass
class PredictorModel:
    k: int
    mode: int
    max_features: int
    id_cutoff: float
    datatype: str
    feature_set: int
    classifier: Optional[ModelBlock] = None
    regressor: Optional[ModelBlock] = None


def _fmt(x: float) -> str:
    """17-significant-digit default-format float, matching
    std::setprecision(digits10=15)... the reference uses digits10 == 15."""
    return f"{x:.15g}"


def save_weights(path: str, model: PredictorModel) -> None:
    lines = [
        f"k: {model.k}",
        f"mode: {model.mode}",
        f"max_features: {model.max_features}",
        f"ID: {_fmt(model.id_cutoff)}",
        f"Datatype: {model.datatype}",
        f"feature_set: {model.feature_set}",
    ]
    for block in (model.classifier, model.regressor):
        if block is None:
            continue
        lines.append("")
        lines.append(f"n_combos: {len(block.combos)}")
        lines.append(_fmt(float(block.weights[0])))
        for j, (kind, fl) in enumerate(block.combos):
            lines.append(f"{F.COMBO_TO_CODE[kind]} {fl} {_fmt(float(block.weights[j + 1]))}")
        lines.append("")
        lines.append(f"n_singles: {len(block.singles)}")
        for j, s in enumerate(block.singles):
            lines.append(f"{s} {_fmt(float(block.mins[j]))} {_fmt(float(block.maxs[j]))}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _read_block(tokens: List[str], pos: int) -> Tuple[ModelBlock, int]:
    if tokens[pos] != "n_combos:":
        raise ValueError(f"bad weights file at {tokens[pos]!r} (expected n_combos:)")
    n_combos = int(tokens[pos + 1])
    pos += 2
    weights = [float(tokens[pos])]
    pos += 1
    combos: List[Tuple[str, int]] = []
    singles: List[int] = []
    for _ in range(n_combos):
        code = int(tokens[pos]); flags_ = int(tokens[pos + 1]); w = float(tokens[pos + 2])
        pos += 3
        combos.append((F.CODE_TO_COMBO[code], flags_))
        weights.append(w)
        for s in F.split_flags(flags_):
            if s not in singles:
                singles.append(s)
    if tokens[pos] != "n_singles:":
        raise ValueError(f"bad weights file at {tokens[pos]!r} (expected n_singles:)")
    n_singles = int(tokens[pos + 1])
    pos += 2
    mins = np.zeros(n_singles)
    maxs = np.zeros(n_singles)
    file_singles: List[int] = []
    for j in range(n_singles):
        s = int(tokens[pos]); mn = float(tokens[pos + 1]); mx = float(tokens[pos + 2])
        pos += 3
        file_singles.append(s)
        mins[j] = mn
        maxs[j] = mx
    # Singles order in the file is the lookup order (insertion order during
    # add_feature); it matches what split_flags reconstruction produced.
    if file_singles != singles:
        # Re-order bounds to our reconstructed lookup order.
        order = [file_singles.index(s) for s in singles]
        mins = mins[order]
        maxs = maxs[order]
    block = ModelBlock(combos=combos, weights=np.asarray(weights), singles=singles,
                       mins=mins, maxs=maxs)
    return block, pos


def load_weights(path: str) -> PredictorModel:
    try:
        return _load_weights_tokens(path)
    except IndexError:
        raise ValueError(f"truncated or malformed weights file: {path}") from None


def _load_weights_tokens(path: str) -> PredictorModel:
    with open(path) as f:
        text = f.read()
    tokens = text.split()
    # Header: "k:" v "mode:" v "max_features:" v "ID:" v "Datatype:" v
    # "feature_set:" v  — read positionally like operator>> does
    # (Predictor.cpp:46-79).
    vals = {}
    pos = 0
    for key in ("k:", "mode:", "max_features:", "ID:", "Datatype:", "feature_set:"):
        if tokens[pos] != key:
            raise ValueError(f"bad weights file: expected {key}, got {tokens[pos]!r}")
        vals[key] = tokens[pos + 1]
        pos += 2
    model = PredictorModel(
        k=int(vals["k:"]),
        mode=int(vals["mode:"]),
        max_features=int(vals["max_features:"]),
        id_cutoff=float(vals["ID:"]),
        datatype=vals["Datatype:"],
        feature_set=int(vals["feature_set:"]),
    )
    if model.mode & PRED_MODE_CLASS:
        model.classifier, pos = _read_block(tokens, pos)
    if model.mode & PRED_MODE_REGR:
        model.regressor, pos = _read_block(tokens, pos)
    return model
