"""Red's two-track HMM (HMM.cpp).

States 0..P-1 are "repeat" states, P..2P-1 their non-repeat mirrors; the
state *identity* at a position is fixed by that position's log score
(HMM.h:58-66), so training is pure transition/prior counting over the
candidate partition of each segment, and Viterbi decoding reduces to a
two-track (positive/negative) recurrence with per-position state pairs.

Training is vectorized with numpy scatter-adds; decoding runs through the
native C++ scan (latency-friendly) with a numpy fallback.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np


class HMM:
    def __init__(self, base: float, state_number: int):
        if state_number % 2 != 0 or state_number == 0:
            raise ValueError("The number of states must be even and > zero.")
        self.base = base
        self.log_base = math.log(base)
        self.state_number = state_number
        self.positive_state_number = state_number // 2
        # counts initialized to 1 (HMM.cpp:156-161)
        self.p_counts = np.ones(state_number, dtype=np.float64)
        self.t_counts = np.ones((state_number, state_number), dtype=np.float64)
        self.p_log: Optional[np.ndarray] = None
        self.t_log: Optional[np.ndarray] = None

    # -- training -----------------------------------------------------------

    def train(self, scores: np.ndarray, segments: Sequence[Tuple[int, int]],
              candidates: Sequence[Tuple[int, int]]) -> None:
        """(HMM.cpp:184-316): partition each segment into alternating
        negative/positive runs around its candidates and count priors and
        transitions."""
        if not len(candidates):
            return
        cand = list(candidates)
        n_cand = len(cand)
        first = 0
        for seg_start, seg_end in segments:
            if first >= n_cand:
                break
            c = cand[first]
            if not _overlap(seg_start, seg_end, c[0], c[1]):
                continue
            last = first
            while last + 1 < n_cand and _overlap(seg_start, seg_end,
                                                 cand[last + 1][0], cand[last + 1][1]):
                last += 1
            self._train_segment(scores, seg_start, seg_end, cand[first:last + 1])
            first = last + 1

    def _train_segment(self, scores, seg_start, seg_end, cands) -> None:
        P = self.positive_state_number
        f_start = cands[0][0]
        if f_start > seg_start:
            self._train_run(scores, seg_start, f_start - 1, P)
            self._move(scores[f_start - 1] + P, scores[f_start])
        for i in range(len(cands) - 1):
            c_start, c_end = cands[i]
            self._train_run(scores, c_start, c_end, 0)
            self._move(scores[c_end], scores[c_end + 1] + P)
            next_start = cands[i + 1][0]
            self._train_run(scores, c_end + 1, next_start - 1, P)
            self._move(scores[next_start - 1] + P, scores[next_start])
        l_start, l_end = cands[-1]
        self._train_run(scores, l_start, l_end, 0)
        if seg_end > l_end:
            self._move(scores[l_end], scores[l_end + 1] + P)
            self._train_run(scores, l_end + 1, seg_end, P)

    def _train_run(self, scores, s, e, offset) -> None:
        """trainPositive/trainNegative (HMM.cpp:285-311): prior of the run's
        first state, and a transition per consecutive pair within the run.
        (For s > e only the prior increments, matching the reference loops.)"""
        self.p_counts[scores[s] + offset] += 1
        if e < s:
            return
        run = scores[s : e + 1] + offset
        if len(run) > 1:
            np.add.at(self.t_counts, (run[:-1], run[1:]), 1)

    def _move(self, s1, s2) -> None:
        self.t_counts[s1, s2] += 1

    def normalize(self) -> None:
        """(HMM.cpp:318-345)"""
        self.p_log = np.log(self.p_counts / self.p_counts.sum())
        self.t_log = np.log(self.t_counts / self.t_counts.sum(axis=1, keepdims=True))

    # -- decoding -----------------------------------------------------------

    def decode_segment(self, scores: np.ndarray, r_start: int, r_end: int) -> List[Tuple[int, int]]:
        """Viterbi over [r_start, r_end]; returns positive (repeat) regions
        (HMM.cpp:453-619).  Two-track formulation: at position i only states
        (score[i], score[i]+P) are reachable."""
        P = self.positive_state_number
        seg = np.asarray(scores[r_start : r_end + 1], dtype=np.int64)
        n = len(seg)
        t = self.t_log
        # try native scan first
        from ..native import viterbi_two_track

        states = viterbi_two_track(seg, self.p_log, t, P)
        if states is None:
            states = self._decode_numpy(seg, P, t)
        # positive runs -> regions (HMM.cpp:579-619)
        pos = states == 0
        if not pos.any():
            return []
        d = np.diff(pos.astype(np.int8))
        starts = np.nonzero(d == 1)[0] + 1
        ends = np.nonzero(d == -1)[0]
        if pos[0]:
            starts = np.concatenate([[0], starts])
        if pos[-1]:
            ends = np.concatenate([ends, [n - 1]])
        return [(int(a) + r_start, int(b) + r_start)
                for a, b in zip(starts, ends)]

    def _decode_numpy(self, seg: np.ndarray, P: int, t: np.ndarray) -> np.ndarray:
        n = len(seg)
        vp = self.p_log[seg[0]]
        vn = self.p_log[seg[0] + P]
        back = np.zeros((n, 2), dtype=np.int8)
        for i in range(1, n):
            pp, pn = seg[i - 1], seg[i - 1] + P
            cp, cn = seg[i], seg[i] + P
            a = vp + t[pp, cp]
            b = vn + t[pn, cp]
            c = vp + t[pp, cn]
            d = vn + t[pn, cn]
            if a > b:
                vp_new, back[i, 0] = a, 0
            else:
                vp_new, back[i, 0] = b, 1
            if c > d:
                vn_new, back[i, 1] = c, 0
            else:
                vn_new, back[i, 1] = d, 1
            vp, vn = vp_new, vn_new
        states = np.zeros(n, dtype=np.int8)
        # final state: first strict max over state indices wins, and the
        # positive state has the lower index (HMM.cpp:516-524)
        cur = 0 if vp >= vn else 1
        states[n - 1] = cur
        for i in range(n - 1, 0, -1):
            cur = back[i, cur]
            states[i - 1] = cur
        return states

    # -- serialization (-hmo, HMM.cpp:402-447) ------------------------------

    @classmethod
    def read(cls, path: str) -> "HMM":
        """Load a model written by write()/-hmo (the reference's
        HMM(string) ctor, HMM.cpp:86-150)."""
        with open(path) as f:
            lines = [l.rstrip("\n") for l in f]
        if lines[0] != "Base" or lines[2] != "States":
            raise ValueError(f"not an HMM file: {path}")
        base = float(lines[1])
        state_number = int(lines[3])
        hmm = cls(base, state_number)
        if lines[4] != "Priors":
            raise ValueError(f"not an HMM file (missing Priors): {path}")
        hmm.p_log = np.array([float(v) for v in lines[6].split()])
        if lines[7] != "Transition":
            raise ValueError(f"not an HMM file (missing Transition): {path}")
        rows = []
        for i in range(state_number):
            parts = lines[9 + i].split("\t")
            rows.append([float(v) for v in parts[1 : state_number + 1]])
        hmm.t_log = np.array(rows)
        return hmm

    def write(self, path: str) -> None:
        P = self.positive_state_number
        names = [str(j) for j in range(P)] + [f"-{j}" for j in range(P)]
        with open(path, "w") as f:
            f.write(f"Base\n{self.base:.16g}\n")
            f.write(f"States\n{self.state_number}\n")
            f.write("Priors\n")
            f.write("    ".join(names) + "    \n")
            f.write("    ".join(f"{v:.16g}" for v in self.p_log) + "    \n")
            f.write("Transition\n\t")
            f.write("\t".join(names) + "\t\n")
            for i in range(self.state_number):
                row = "\t".join(f"{v:.16g}" for v in self.t_log[i])
                f.write(f"{names[i]}\t{row}\t\n")
            f.write("\n\n")


def _overlap(s1, e1, s2, e2) -> bool:
    return not (e1 < s2 or e2 < s1)
