"""Affine-gap global alignment with identity tracking.

Behavioral equivalent of the reference's GlobAlignE (GlobAlignE.cpp:123-305):
three-lane DP (match / upper gap / lower gap) in O(len1) memory, propagating
alignment length and match counts along the optimal path, with the
reference's tie-breaking priorities (fresh gap open preferred; on the match
lane: diagonal > lower > upper).  Vectorized over the row dimension; the
within-row lower-gap recurrence is solved as a prefix max.

Scoring defaults are the FEAT_ALIGN parameters (Feature.cpp:708-710):
match=1, mismatch=-1, gap open=2, gap continue=1.  Identity =
total_matches / alignment_length.
"""
from __future__ import annotations

import numpy as np


def global_align_identity(
    s1: str,
    s2: str,
    match: int = 1,
    mismatch: int = -1,
    gap_open: int = 2,
    gap_continue: int = 1,
):
    """Returns (score, alignment_length, total_matches, identity)."""
    a = np.frombuffer(s1.encode(), dtype=np.uint8)
    b = np.frombuffer(s2.encode(), dtype=np.uint8)
    # the reference treats len as strlen+1 (DP over 0..len-1 with 0 the
    # boundary): len1 = |s1|+1 rows dimension
    n1 = len(a) + 1
    n2 = len(b) + 1
    shorter = min(n1, n2) - 1
    len_diff = abs(n2 - n1)
    max_diff = 0
    if len_diff >= 1:
        max_diff += -gap_open - len_diff * gap_continue
    max_diff += mismatch * shorter - 1
    ninf = max_diff  # "negativeInf"

    I = np.arange(n1, dtype=np.int64)
    m = np.full(n1, ninf, dtype=np.int64)
    m[0] = 0
    ug = np.full(n1, ninf, dtype=np.int64)
    lg = np.where(I >= 1, -gap_open - I * gap_continue, ninf).astype(np.int64)
    lg[0] = ninf
    m_len = I.copy(); u_len = I.copy(); l_len = I.copy()
    m_id = np.zeros(n1, dtype=np.int64)
    u_id = np.zeros(n1, dtype=np.int64)
    l_id = np.zeros(n1, dtype=np.int64)

    for j in range(1, n2):
        # ---- upper-gap lane (vectorized over i>=1) ----
        yb = m[1:] - (gap_open + gap_continue)
        yc = ug[1:] - gap_continue
        new_ug = np.maximum(yb, yc)
        open_wins = new_ug == yb  # fresh open preferred on tie
        new_u_len = np.where(open_wins, m_len[1:] + 1, u_len[1:] + 1)
        new_u_id = np.where(open_wins, m_id[1:], u_id[1:])

        # ---- match lane ----
        score = np.where(a == b[j - 1], match, mismatch).astype(np.int64)
        diag_m = m[:-1]
        diag_len = m_len[:-1]
        diag_id = m_id[:-1]
        low_shift = lg[:-1]
        low_len_shift = l_len[:-1]
        low_id_shift = l_id[:-1]
        ug_shift = np.empty(n1 - 1, dtype=np.int64)
        ug_shift[0] = -gap_open - (j - 1) * gap_continue
        ug_shift[1:] = ug[1:-1]
        ug_len_shift = np.empty(n1 - 1, dtype=np.int64)
        ug_len_shift[0] = j - 1
        ug_len_shift[1:] = u_len[1:-1]
        ug_id_shift = np.empty(n1 - 1, dtype=np.int64)
        ug_id_shift[0] = 0
        ug_id_shift[1:] = u_id[1:-1]

        matched = diag_m + score
        xend = low_shift + score
        yend = ug_shift + score
        new_m = np.maximum(np.maximum(matched, xend), yend)
        is_match = score == match
        # branch priority: matched, then xend, then yend (GlobAlignE.cpp:215-241)
        pick_m = new_m == matched
        pick_x = (~pick_m) & (new_m == xend)
        new_m_len = np.where(pick_m, diag_len + 1,
                             np.where(pick_x, low_len_shift + 1, ug_len_shift + 1))
        new_m_id = np.where(pick_m, diag_id,
                            np.where(pick_x, low_id_shift, ug_id_shift)) + is_match

        # commit upper + match lanes
        ug[1:] = new_ug
        u_len[1:] = new_u_len
        u_id[1:] = new_u_id
        m[1:] = new_m
        m_len[1:] = new_m_len
        m_id[1:] = new_m_id
        m[0] = ninf
        m_len[0] = j
        m_id[0] = 0

        # ---- lower-gap lane: prefix max over the current row ----
        # lg[i] = max(m[i-1] - (go+gc), lg[i-1] - gc); fresh open (later
        # source) wins ties (GlobAlignE.cpp:258-273).
        lg[0] = ninf
        l_len[0] = j
        l_id[0] = 0
        # lg[i] = max over open source t<=i of adj[t] - gc*i, where
        #   adj[0] = lg[0] (the never-opened chain),
        #   adj[t] = m[t-1] - go + gc*(t-1)   (fresh open at position t)
        # with later-t-wins tie-breaking (fresh open preferred at equality).
        adj = np.empty(n1, dtype=np.int64)
        adj[0] = lg[0]
        adj[1:] = m[:-1] - gap_open + gap_continue * I[:-1]
        key = adj * np.int64(n1 + 1) + I  # lexicographic (value, index) max
        run_key = np.maximum.accumulate(key)
        src = run_key % (n1 + 1)
        run_val = (run_key - src) // (n1 + 1)
        lg[1:] = (run_val - gap_continue * I)[1:]
        # opened at t>=1: len = m_len[t-1] + (i - t + 1), id = m_id[t-1];
        # never opened (t=0): len = l_len[0] + i, id = 0.
        src_len = np.where(src > 0, m_len[np.maximum(src - 1, 0)], l_len[0])
        src_id = np.where(src > 0, m_id[np.maximum(src - 1, 0)], 0)
        steps = np.where(src > 0, I - src + 1, I)
        l_len[1:] = (src_len + steps)[1:]
        l_id[1:] = src_id[1:]

    score_final = max(int(m[n1 - 1]), int(lg[n1 - 1]), int(ug[n1 - 1]))
    if score_final == int(m[n1 - 1]):
        align_len, matches_ = int(m_len[n1 - 1]), int(m_id[n1 - 1])
    elif score_final == int(lg[n1 - 1]):
        align_len, matches_ = int(l_len[n1 - 1]), int(l_id[n1 - 1])
    else:
        align_len, matches_ = int(u_len[n1 - 1]), int(u_id[n1 - 1])
    identity = matches_ / align_len if align_len else 0.0
    return score_final, align_len, matches_, identity
