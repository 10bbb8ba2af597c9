"""A seeded sample of the classifier's decision values that the timed path
produces: for about one `pair_stats_decision` launch in `every`, up to
`pairs` of its pairs' rows and the GLM sums the kernel wrote for them.

The check holds those sums against the reference's float64 sums of the
same pairs.  A clustering's CLSTR changes only where a decision or a tie
changes, and on the benchmark's pools no decision lies within float32's
error of its edge, so the CLSTR alone cannot tell a float32 classifier
from the float64 one that the configuration states; the sums can.  The
sample costs a few small copies on the card in one launch of `every`.

It reads the launches through the Python wrapper `pair_stats_decision` in
every module of the port that holds it.  A program that stops calling that
wrapper a launch (a step loop captured in a CUDA graph, the wrapper renamed
or fused) leaves the sample empty: `glm_sum_gap` is then missing, and the
run is not correct rather than unchecked.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .trace import Patched


class DecisionSample:
    def __init__(self, seed: int, every: int, pairs: int):
        self.rng = np.random.default_rng([seed % (1 << 64), 2])
        self.every = every
        self.pairs = pairs
        self.job = None            # the index of the job running, or None
        self.taken: List[tuple] = []

    def _wrap(self, fn):
        def wrapper(store, params, a_idx, b_idx, plane=None):
            out = fn(store, params, a_idx, b_idx, plane)
            if self.job is not None and self.rng.integers(self.every) == 0:
                sel = slice(0, len(a_idx), max(1, len(a_idx) // self.pairs))
                b = b_idx if len(b_idx) == 1 else b_idx[sel]
                self.taken.append((self.job, a_idx[sel].clone(), b.clone(),
                                   out[1][0][sel].clone()))
            return out
        return wrapper

    def patched(self) -> Patched:
        return Patched({"pair_stats_decision": self._wrap})

    def by_job(self) -> Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Per job: the sampled pairs' program rows (a, b) and sums."""
        out: Dict[int, list] = {}
        for job, a, b, s in self.taken:
            a, s = a.cpu().numpy(), s.cpu().numpy()
            b = np.broadcast_to(b.cpu().numpy(), a.shape)
            out.setdefault(job, []).append((a, b, s))
        return {j: tuple(np.concatenate(x) for x in zip(*parts))
                for j, parts in out.items()}
