"""Whether the window's jobs produced what the reference produces.

For each pool the run used, the reference's answer is computed once
(after the window, on the same device) and every window job on that pool is
held against it: a clustering job's histograms, CLSTR and sampled GLM
sums, a search job's output lines and count of kept pairs.  Each number is
the largest over the jobs judged; a job over a limit is rejected.
"""
from __future__ import annotations

import time
from typing import Dict, List, Set, Tuple

import numpy as np
import torch

import reference as R
from reference import compare as C


def check(plan, run, paths: List[str], pools: List[int], device: str,
          samples: Dict[int, tuple]) -> Tuple[Dict[str, float], Set[int]]:
    config, limits = plan.config, plan.config["limits"]
    weights = plan.path(config["weights"])
    dev = torch.device(device)
    numbers: Dict[str, float] = {}
    rejected: Set[int] = set()
    for pool in pools:
        t = time.monotonic()
        if config["program"] == "cluster":
            ref = R.cluster(paths[pool], weights, dev, **config["options"])
        else:
            ref = R.search_all(paths[pool], paths[pool], weights, dev,
                               **config["options"])
        ref_s = time.monotonic() - t
        for j, job in enumerate(run.jobs + run.traced):
            if job.pool != pool or job.error is not None:
                continue
            if config["program"] == "cluster":
                got = {"hist_off": C.hist_off(ref.headers, ref.counts,
                                              job.headers, job.counts),
                       "clstr_off": C.clstr_off(ref.keys, job.output)}
                if j in samples:
                    got["glm_sum_gap"] = sum_gap(ref, job.headers, *samples[j])
            else:
                got = {"lines_off": C.lines_off(ref, job.output),
                       "positives_off": C.positives_off(
                           ref, int(job.counters["positives"]))}
            for k, v in got.items():
                numbers[k] = max(numbers.get(k, 0), v)
                if v > limits[k]:
                    rejected.add(j)
        print(f"reference for pool {pool}: {ref_s:.3f} s", flush=True)
        del ref
        if device == "cuda":
            torch.cuda.empty_cache()
    return numbers, rejected


def sum_gap(ref, headers: List[str], a, b, s) -> float:
    """The widest gap between the sampled sums of a job (its rows a, b in
    the program's order, `headers`) and the reference's float64 sums of the
    same pairs.  Indices outside the pool (which the kernel answers with
    NaN) are not pairs."""
    rows, ok = ref_rows(ref, headers, a, b)
    return C.sum_gap(s[ok], ref.sums(rows[a[ok]], rows[b[ok]]))


def ref_rows(ref, headers: List[str], a, b):
    """The reference's row of each program row, and which sampled pairs
    are pairs of the pool (both indices in range)."""
    rows = ref.rows(headers)
    n = len(headers)
    ok = (a >= 0) & (a < n) & (b >= 0) & (b < n)
    rows = np.append(rows, -1)          # an index out of range reads -1
    ok &= (rows[np.where(ok, a, n)] >= 0) & (rows[np.where(ok, b, n)] >= 0)
    return rows, ok
