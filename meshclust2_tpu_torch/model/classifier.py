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
operation order, with the GLM dot written out in index order.  It is the
plain version of the epilogue that csrc/pair_stats.cu fuses behind the
pair statistics; `packed_params` lays the same parameters out for that
kernel, and `model_to_torch` uploads them once per model.
`decision_errors`, its error-propagating twin, turns the full-vector and
plane singles' absolute error bounds into bounds on the GLM sum and on
dist.
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


# the singles the fused kernel derives from the pair statistics and the
# per-row moments (meshclust2_tpu/cluster/device_loop.py:DD_DERIVABLE)
STATS_SINGLES = (
    F.FEAT_MANHATTAN, F.FEAT_EUCLIDEAN, F.FEAT_INTERSECTION,
    F.FEAT_KULCZYNSKI2, F.FEAT_SIMRATIO, F.FEAT_NORMALIZED_VECTORS,
    F.FEAT_PEARSON_COEFF, F.FEAT_D2z, F.FEAT_EUCLIDEAN_Z, F.FEAT_EMD,
    F.FEAT_LENGTHD)
# the singles it sums over the two full rows, each with an absolute error
# bound (ops/pair_stats.py:vector_singles_ref; the JAX package's
# LOG_DERIVABLE and BLOCK_DERIVABLE)
VECTOR_SINGLES = (
    F.FEAT_JEFFEREY_DIV, F.FEAT_JENSEN_SHANNON, F.FEAT_K_DIV, F.FEAT_KL_COND,
    F.FEAT_HELLINGER, F.FEAT_SQCHORD, F.FEAT_CHI_SQUARED, F.FEAT_CANBERRA,
    F.FEAT_KULCZYNSKI1, F.FEAT_HARMONIC_MEAN, F.FEAT_MISMATCH, F.FEAT_JACCARD)
# the plane singles: the JAX package's DeviceFeatureEngine planes
# (meshclust2_tpu/ops/device_features.py:86-132), which neither the
# statistics nor the full-vector pass give; ops/plane_singles.py computes
# them with absolute error bounds, and the fused kernel's PLANE epilogue
# reads them by code
PLANE_SINGLES = (
    F.FEAT_MARKOV, F.FEAT_SIM_MM, F.FEAT_RRE_K_R, F.FEAT_SPEARMAN, F.FEAT_D2s,
    F.FEAT_D2_star, F.FEAT_AFD, F.FEAT_N2R, F.FEAT_N2RC, F.FEAT_N2RRC)
# every single the kernels compute, by its code in the parameter buffer
# (csrc/pair_stats.cu and csrc/plane_singles.cu enum Single)
SINGLE_CODES = {flag: code for code, flag in
                enumerate(STATS_SINGLES + VECTOR_SINGLES + PLANE_SINGLES)}
# the parameter buffer: a head, then 4 float64 a single, then 4 a combo
PARAM_HEAD = 4
PARAM_STRIDE = 4


def packed_params(model: CompiledModel) -> np.ndarray:
    """The fused kernel's float64 parameter buffer: [S, C, bias, w0], then
    per single (code, min, max - min, is_sim), then per combo (kind code,
    i0, i1 or -1, weight).  A single the kernel cannot derive gets code -1,
    which its wrapper refuses."""
    singles, combos = model.singles, model.combos
    buf = np.zeros(PARAM_HEAD + PARAM_STRIDE * (len(singles) + len(combos)))
    buf[:PARAM_HEAD] = (len(singles), len(combos), model.bias, model.weights[0])
    rng = model.maxs - model.mins
    for k, flag in enumerate(singles):
        q = PARAM_HEAD + PARAM_STRIDE * k
        buf[q:q + PARAM_STRIDE] = (SINGLE_CODES.get(flag, -1), model.mins[k],
                                   rng[k], bool(model.is_sim[k]))
    for j, (kind, idxs) in enumerate(combos):
        if not 1 <= len(idxs) <= 2 or (kind in (F.COMBO_XY2, F.COMBO_X2Y)
                                       and len(idxs) != 2):
            raise ValueError(f"combo {kind} over singles {list(idxs)}")
        q = PARAM_HEAD + PARAM_STRIDE * (len(singles) + j)
        buf[q:q + PARAM_STRIDE] = (F.COMBO_TO_CODE[kind], idxs[0],
                                   idxs[1] if len(idxs) == 2 else -1,
                                   model.weights[j + 1])
    return buf


@dataclass(frozen=True)
class TorchModel:
    mins: torch.Tensor        # float64 [S]
    maxs: torch.Tensor        # float64 [S]
    is_sim: torch.Tensor      # bool [S]
    combos: tuple             # ((kind, (single indices...)), ...)
    weights: torch.Tensor     # float64 [1 + C], [0] = intercept
    bias: float
    singles: tuple            # the singles' flags, in model order
    packed: torch.Tensor      # float64, packed_params(model)


def model_to_torch(model: CompiledModel, device) -> TorchModel:
    f64 = dict(dtype=torch.float64, device=device)
    return TorchModel(
        mins=torch.as_tensor(model.mins, **f64),
        maxs=torch.as_tensor(model.maxs, **f64),
        is_sim=torch.as_tensor(model.is_sim, dtype=torch.bool, device=device),
        combos=tuple((kind, tuple(idxs)) for kind, idxs in model.combos),
        weights=torch.as_tensor(model.weights, **f64),
        bias=float(model.bias),
        singles=tuple(model.singles),
        packed=torch.as_tensor(packed_params(model), **f64),
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


def _mul_err(c, ce, z, ze):
    """The product c z and its first-order absolute error bound."""
    return c * z, ce * z.abs() + ze * c.abs()


def _combo_err(z, ze, kind: str, idxs) -> Tuple[torch.Tensor, torch.Tensor]:
    """A combo's value and error bound from its singles' normalized values
    and bounds, product by product (meshclust2_tpu/cluster/device_loop.py:
    epilogue_dd)."""
    i0, i1 = idxs[0], (idxs[1] if len(idxs) == 2 else None)
    if kind == F.COMBO_XY:
        c, ce = z[:, i0], ze[:, i0]
        if i1 is not None:
            c, ce = _mul_err(c, ce, z[:, i1], ze[:, i1])
    elif kind == F.COMBO_X2Y2:
        c, ce = _mul_err(z[:, i0], ze[:, i0], z[:, i0], ze[:, i0])
        if i1 is not None:
            c, ce = _mul_err(c, ce, z[:, i1], ze[:, i1])
            c, ce = _mul_err(c, ce, z[:, i1], ze[:, i1])
    elif kind == F.COMBO_XY2:
        c, ce = _mul_err(z[:, i0], ze[:, i0], z[:, i1], ze[:, i1])
        c, ce = _mul_err(c, ce, z[:, i1], ze[:, i1])
    elif kind == F.COMBO_X2Y:
        c, ce = _mul_err(z[:, i0], ze[:, i0], z[:, i0], ze[:, i0])
        c, ce = _mul_err(c, ce, z[:, i1], ze[:, i1])
    else:
        raise ValueError(kind)
    return c, ce


_U = 2.0 ** -53   # unit roundoff of float64


def decision_errors(m: TorchModel, raw: torch.Tensor, err: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[P, S] float64 raw singles and their absolute error bounds (those
    of the full-vector and the plane singles; 0 for the statistics-derived
    ones) -> the first-order bounds (s_err, dist_err) of the GLM sum and of
    dist, in the order of meshclust2_tpu/cluster/device_loop.py:
    epilogue_dd: each bound over |max - min| (the flip keeps it), each
    combo's products, then the GLM sum, |w_j| times combo j's bound in
    combo order.  Where the singles differ, so may the two sides' own
    roundings of the epilogue, and the bounds cover them too: 6 u (|z| + 1)
    a normalized single (three roundings a side), 8 u |c_j| a combo (up to
    three products a side), and 2 (C + 2) u (|w_0| + sum_j |w_j c_j|) the
    GLM sum (C products and w_0 summed on each side in its own order)."""
    v = (raw - m.mins[None, :]) / (m.maxs - m.mins)[None, :]
    z = torch.where(m.is_sim[None, :], v, 1.0 - v)
    ze = err / (m.maxs - m.mins).abs()[None, :] + 6 * _U * (z.abs() + 1)
    if not m.combos:
        zero = torch.zeros(raw.shape[0], dtype=torch.float64, device=raw.device)
        return zero, zero.clone()
    cerr, mag = [], m.weights[0].abs().expand(raw.shape[0])
    for j, (kind, idxs) in enumerate(m.combos):
        c, ce = _combo_err(z, ze, kind, idxs)
        cerr.append(ce + 8 * _U * c.abs())
        mag = mag + (c * m.weights[j + 1]).abs()
    s_err = cerr[0] * m.weights[1].abs()
    for j in range(1, len(cerr)):
        s_err = s_err + cerr[j] * m.weights[j + 1].abs()
    return s_err + 2 * (len(cerr) + 2) * _U * mag, cerr[0]
