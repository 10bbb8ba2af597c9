"""The classifier: the host CompiledModel and its float64 torch epilogue.

`CompiledModel` is the port's copy of meshclust2_tpu/model/classifier.py
(112 lines), the float64 host oracle of the reference decision path:
  - raw single features (Feature.cpp formulas)
  - min/max normalization, flipped for distance features
    (Feature.cpp:136-154: v = (raw-min)/(max-min); 1-v if not similarity)
  - combo products xy / xy2 / x2y / x2y2 (Feature.h:205-239)
  - sum = w0 + sum_j w_j * combo_j; prob = logistic(sum) + bias
    (Predictor.cpp:315-333)
  - positive when round(prob) > 0; merge-positive when round(prob) == 1
    (Trainer.cpp:52,101)

`decision_from_raw` below is the same epilogue in float64 torch on the
card: the parameters are CompiledModel's numpy ones, carried over as
tensors by `model_to_torch`, and the formulas keep CompiledModel's
operation order, with the GLM dot written out in index order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..features import flags as F
from ..features import host as H
from .weights import ModelBlock


@dataclass
class CompiledModel:
    block: ModelBlock
    bias: float = 0.0

    def __post_init__(self):
        self.singles = list(self.block.singles)
        self.is_sim = np.array([F.FEAT_IS_SIM[s] for s in self.singles])
        self.mins = np.asarray(self.block.mins, dtype=np.float64)
        self.maxs = np.asarray(self.block.maxs, dtype=np.float64)
        self.combos = self.block.combo_indices()
        self.weights = np.asarray(self.block.weights, dtype=np.float64)

    # -- feature plumbing ---------------------------------------------------

    def normalize(self, raw: np.ndarray) -> np.ndarray:
        """[P, S] raw -> normalized (Feature.cpp:136-154)."""
        v = (raw - self.mins[None, :]) / (self.maxs - self.mins)[None, :]
        return np.where(self.is_sim[None, :], v, 1.0 - v)

    def combo_matrix(self, normalized: np.ndarray) -> np.ndarray:
        """[P, S] normalized singles -> [P, C] combo values
        (Feature.h:205-239)."""
        cols = []
        for kind, idxs in self.combos:
            if kind == F.COMBO_XY:
                v = np.prod(normalized[:, idxs], axis=1)
            elif kind == F.COMBO_X2Y2:
                v = np.prod(normalized[:, idxs] ** 2, axis=1)
            elif kind == F.COMBO_XY2:
                i0, i1 = idxs
                v = normalized[:, i0] * normalized[:, i1] * normalized[:, i1]
            elif kind == F.COMBO_X2Y:
                i0, i1 = idxs
                v = normalized[:, i0] * normalized[:, i0] * normalized[:, i1]
            else:
                raise ValueError(kind)
            cols.append(v)
        return np.stack(cols, axis=1) if cols else np.zeros((normalized.shape[0], 0))

    # -- scoring ------------------------------------------------------------

    def raw_singles(self, a: H.PairSide, b: H.PairSide) -> np.ndarray:
        return H.compute_singles(self.singles, a, b)

    def decision_from_raw(self, raw: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(sum, prob, dist) where dist = first combo value
        (Trainer.cpp:50)."""
        normalized = self.normalize(raw)
        combo = self.combo_matrix(normalized)
        s = self.weights[0] + combo @ self.weights[1:]
        # clamp the logistic argument: exp(709+) overflows f64 with a
        # RuntimeWarning; the result saturates identically (exp(-709) ~
        # 1e-308 makes prob exactly 0.0/1.0 either way, so decisions are
        # unchanged)
        prob = 1.0 / (1.0 + np.exp(-np.clip(s, -709.0, 709.0))) + self.bias
        dist = combo[:, 0] if combo.shape[1] else np.zeros(len(raw))
        return s, prob, dist

    def score(self, a: H.PairSide, b: H.PairSide):
        """Full host scoring of a pair batch: returns (prob, dist)."""
        raw = self.raw_singles(a, b)
        _, prob, dist = self.decision_from_raw(raw)
        return prob, dist

    @staticmethod
    def positive(prob: np.ndarray) -> np.ndarray:
        """get_close/filter-style positivity: round(prob) > 0
        (Trainer.cpp:52,134).  floor(x+0.5), NOT np.round — numpy's
        banker's rounding flips the decision at prob == 0.5 exactly."""
        return np.floor(np.asarray(prob, dtype=np.float64) + 0.5) > 0

    @staticmethod
    def merge_positive(prob: np.ndarray) -> np.ndarray:
        """merge-style positivity: round(prob) == 1 (Trainer.cpp:101-103)."""
        return np.floor(np.asarray(prob, dtype=np.float64) + 0.5) == 1

    def regression_value(self, a: H.PairSide, b: H.PairSide) -> np.ndarray:
        """Regression head evaluation clamped to [0, 1]
        (Predictor.cpp:283-300)."""
        raw = self.raw_singles(a, b)
        normalized = self.normalize(raw)
        combo = self.combo_matrix(normalized)
        s = self.weights[0] + combo @ self.weights[1:]
        return np.clip(s, 0.0, 1.0)


@dataclass(frozen=True)
class TorchModel:
    mins: torch.Tensor        # float64 [S]
    maxs: torch.Tensor        # float64 [S]
    is_sim: torch.Tensor      # bool [S]
    combos: tuple             # ((kind, (single indices...)), ...)
    weights: torch.Tensor     # float64 [1 + C], [0] = intercept
    bias: float


def model_to_torch(model: CompiledModel, device) -> TorchModel:
    f64 = dict(dtype=torch.float64, device=device)
    return TorchModel(
        mins=torch.as_tensor(model.mins, **f64),
        maxs=torch.as_tensor(model.maxs, **f64),
        is_sim=torch.as_tensor(model.is_sim, dtype=torch.bool, device=device),
        combos=tuple((kind, tuple(idxs)) for kind, idxs in model.combos),
        weights=torch.as_tensor(model.weights, **f64),
        bias=float(model.bias),
    )


def _combo(normalized: torch.Tensor, kind: str, idxs) -> torch.Tensor:
    if kind == F.COMBO_XY:
        return torch.prod(normalized[:, list(idxs)], dim=1)
    if kind == F.COMBO_X2Y2:
        return torch.prod(normalized[:, list(idxs)] ** 2, dim=1)
    if kind == F.COMBO_XY2:
        i0, i1 = idxs
        return normalized[:, i0] * normalized[:, i1] * normalized[:, i1]
    if kind == F.COMBO_X2Y:
        i0, i1 = idxs
        return normalized[:, i0] * normalized[:, i0] * normalized[:, i1]
    raise ValueError(kind)


def decision_from_raw(m: TorchModel, raw: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[P, S] float64 raw singles -> (sum, prob, dist), each float64 [P]."""
    v = (raw - m.mins[None, :]) / (m.maxs - m.mins)[None, :]
    normalized = torch.where(m.is_sim[None, :], v, 1.0 - v)
    combo = [_combo(normalized, kind, idxs) for kind, idxs in m.combos]
    if combo:
        dot = combo[0] * m.weights[1]
        for j in range(1, len(combo)):
            dot = dot + combo[j] * m.weights[j + 1]
        s = m.weights[0] + dot
    else:
        s = m.weights[0].expand(raw.shape[0]).clone()
    # the +-709 clamp keeps exp finite; the result saturates identically
    prob = 1.0 / (1.0 + torch.exp(-torch.clamp(s, -709.0, 709.0))) + m.bias
    dist = combo[0] if combo else torch.zeros_like(s)
    return s, prob, dist
