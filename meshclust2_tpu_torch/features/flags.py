"""Feature flags, names, similarity-direction table, and preset sets.

Mirrors the bit-flag registry in Feature.h:31-64, the is-similarity table in
Feature.cpp:548-663, and the preset feature sets in Predictor.h:23-25.
"""
from __future__ import annotations

FEAT_ALIGN = 1 << 0
FEAT_HELLINGER = 1 << 1
FEAT_MANHATTAN = 1 << 2
FEAT_EUCLIDEAN = 1 << 3
FEAT_CHI_SQUARED = 1 << 4
FEAT_NORMALIZED_VECTORS = 1 << 5
FEAT_HARMONIC_MEAN = 1 << 6
FEAT_JEFFEREY_DIV = 1 << 7
FEAT_K_DIV = 1 << 8
FEAT_PEARSON_COEFF = 1 << 9
FEAT_SQCHORD = 1 << 10
FEAT_KL_COND = 1 << 11
FEAT_MARKOV = 1 << 12
FEAT_INTERSECTION = 1 << 13
FEAT_RRE_K_R = 1 << 14
FEAT_D2z = 1 << 15
FEAT_SIM_MM = 1 << 16
FEAT_EUCLIDEAN_Z = 1 << 17
FEAT_EMD = 1 << 18
FEAT_SPEARMAN = 1 << 19
FEAT_JACCARD = 1 << 20
FEAT_LENGTHD = 1 << 21
FEAT_D2s = 1 << 22
FEAT_AFD = 1 << 23
FEAT_MISMATCH = 1 << 24
FEAT_CANBERRA = 1 << 25
FEAT_KULCZYNSKI1 = 1 << 26
FEAT_KULCZYNSKI2 = 1 << 27
FEAT_SIMRATIO = 1 << 28
FEAT_JENSEN_SHANNON = 1 << 29
FEAT_D2_star = 1 << 30
FEAT_N2R = 1 << 31
FEAT_N2RC = 1 << 32
FEAT_N2RRC = 1 << 33

FEAT_NAMES = {
    FEAT_ALIGN: "align",
    FEAT_HELLINGER: "hellinger",
    FEAT_MANHATTAN: "manhattan",
    FEAT_EUCLIDEAN: "euclidean",
    FEAT_CHI_SQUARED: "chi_squared",
    FEAT_NORMALIZED_VECTORS: "normalized_vectors",
    FEAT_HARMONIC_MEAN: "harmonic_mean",
    FEAT_JEFFEREY_DIV: "jefferey_divergence",
    FEAT_K_DIV: "k_divergence",
    FEAT_PEARSON_COEFF: "pearson",
    FEAT_SQCHORD: "squared_chord",
    FEAT_KL_COND: "kl_conditional",
    FEAT_MARKOV: "markov",
    FEAT_INTERSECTION: "intersection",
    FEAT_RRE_K_R: "rre_k_r",
    FEAT_D2z: "d2z",
    FEAT_SIM_MM: "sim_mm",
    FEAT_EUCLIDEAN_Z: "euclidean_z",
    FEAT_EMD: "emd",
    FEAT_SPEARMAN: "spearman",
    FEAT_JACCARD: "jaccard",
    FEAT_LENGTHD: "length_difference",
    FEAT_D2s: "d2s",
    FEAT_AFD: "afd",
    FEAT_MISMATCH: "mismatch",
    FEAT_CANBERRA: "canberra",
    FEAT_KULCZYNSKI1: "kulczynski1",
    FEAT_KULCZYNSKI2: "kulczynski2",
    FEAT_SIMRATIO: "simratio",
    FEAT_JENSEN_SHANNON: "jensen_shannon",
    FEAT_D2_star: "d2_star",
    FEAT_N2R: "n2r",
    FEAT_N2RC: "n2rc",
    FEAT_N2RRC: "n2rrc",
}

# True if larger raw value means more similar (Feature.cpp:548-663); features
# with False get flipped to 1-v after min/max normalization.
FEAT_IS_SIM = {
    FEAT_ALIGN: True,
    FEAT_HELLINGER: False,
    FEAT_MANHATTAN: False,
    FEAT_EUCLIDEAN: False,
    FEAT_CHI_SQUARED: False,
    FEAT_NORMALIZED_VECTORS: True,
    FEAT_HARMONIC_MEAN: True,
    FEAT_JEFFEREY_DIV: False,
    FEAT_K_DIV: False,
    FEAT_PEARSON_COEFF: True,
    FEAT_SQCHORD: False,
    FEAT_KL_COND: False,
    FEAT_MARKOV: True,
    FEAT_INTERSECTION: True,
    FEAT_RRE_K_R: False,
    FEAT_D2z: True,
    FEAT_SIM_MM: True,
    FEAT_EUCLIDEAN_Z: False,
    FEAT_EMD: False,
    FEAT_SPEARMAN: False,
    FEAT_JACCARD: True,
    FEAT_LENGTHD: False,
    FEAT_D2s: True,
    FEAT_AFD: False,
    FEAT_MISMATCH: False,
    FEAT_CANBERRA: False,
    FEAT_KULCZYNSKI1: False,
    FEAT_KULCZYNSKI2: True,
    FEAT_SIMRATIO: True,
    FEAT_JENSEN_SHANNON: False,
    FEAT_D2_star: True,
    FEAT_N2R: True,
    FEAT_N2RC: True,
    FEAT_N2RRC: True,
}

# Preset selectable sets (Predictor.h:23-25).
PRED_FEAT_FAST = (
    FEAT_EUCLIDEAN | FEAT_MANHATTAN | FEAT_INTERSECTION | FEAT_KULCZYNSKI2
    | FEAT_SIMRATIO | FEAT_NORMALIZED_VECTORS | FEAT_PEARSON_COEFF | FEAT_EMD
    | FEAT_LENGTHD
)
PRED_FEAT_DIV = FEAT_JEFFEREY_DIV | FEAT_JENSEN_SHANNON
PRED_FEAT_ALL = (
    FEAT_HELLINGER | FEAT_MANHATTAN | FEAT_EUCLIDEAN | FEAT_CHI_SQUARED
    | FEAT_NORMALIZED_VECTORS | FEAT_HARMONIC_MEAN | FEAT_JEFFEREY_DIV
    | FEAT_K_DIV | FEAT_PEARSON_COEFF | FEAT_SQCHORD | FEAT_KL_COND
    | FEAT_MARKOV | FEAT_INTERSECTION | FEAT_RRE_K_R | FEAT_D2z | FEAT_SIM_MM
    | FEAT_EUCLIDEAN_Z | FEAT_EMD | FEAT_SPEARMAN | FEAT_JACCARD | FEAT_LENGTHD
    | FEAT_D2s | FEAT_AFD | FEAT_MISMATCH | FEAT_CANBERRA | FEAT_KULCZYNSKI1
    | FEAT_KULCZYNSKI2 | FEAT_SIMRATIO | FEAT_JENSEN_SHANNON | FEAT_D2_star
    | FEAT_N2R | FEAT_N2RC | FEAT_N2RRC
)

# Combo encodings used by the weights file (Predictor.cpp:96-110).
COMBO_XY = "xy"
COMBO_XY2 = "xy2"
COMBO_X2Y = "x2y"
COMBO_X2Y2 = "x2y2"
COMBO_TO_CODE = {COMBO_XY: 0, COMBO_XY2: 1, COMBO_X2Y: 2, COMBO_X2Y2: 3}
CODE_TO_COMBO = {v: k for k, v in COMBO_TO_CODE.items()}


def split_flags(flags: int):
    """Individual single-feature bits in ascending order (add_feature loop
    order, Feature.cpp:110-127)."""
    out = []
    f = 1
    while f <= flags:
        if flags & f:
            out.append(f)
        f <<= 1
    return out


def feat_log2(flag: int) -> int:
    return flag.bit_length() - 1
