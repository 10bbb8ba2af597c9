"""The classifier epilogue in float64 torch.

The port of meshclust2_tpu/model/classifier.py:CompiledModel.decision_from_raw
(line 73): min/max normalization flipped for distance features, the combo
products, the GLM sum, the clamped logistic plus bias, and dist = the first
combo.  The parameters are the JAX package's numpy ones, carried over as
tensors by `model_to_torch`; the formulas keep CompiledModel's operation
order, with the GLM dot written out in index order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from meshclust2_tpu.features import flags as F
from meshclust2_tpu.model.classifier import CompiledModel


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
