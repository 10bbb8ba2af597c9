"""The device k-mer histogram build, the port's counterpart of the
histogram part of meshclust2_tpu/parallel/mesh.py (sharded_histogram_build,
pack_segment_codes, device_build_counts, lines 171-276).

The JAX package builds the counts with an XLA program sharded over a TPU
mesh, on records padded to the longest one with -1 separators between
segments.  The port builds them on one card with the hand-written kernel of
csrc/kmer_count.cu (ops/kmer_count.py), over the native counter's ragged
packing: `device_build_counts` is what kmer/counting.py:build_point_set
calls under MC2_DEVICE_COUNT.  The file's sharded scoring, means and GLM
solve (classify_kernel_factory, sharded_center_scores, sharded_mean_update,
sharded_glm_solve) and mesh_scorer.py / multihost.py wait for the port of
parallel/* over torch.distributed.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# int8 code bytes a chunk uploads; on the CPU, where the plain version's
# int64 temporaries take ~50 bytes a code, fewer
CHUNK_CODES = {"cuda": 1 << 28, "cpu": 1 << 22}
# bytes of counts a chunk holds on the device
CHUNK_COUNTS = 1 << 28


def pack_segment_codes(records, pad_to: Optional[int] = None) -> np.ndarray:
    """[n, L] int8 batch of the JAX program's input: per record, segment
    slices joined by one -1 separator, right-padded with -1
    (meshclust2_tpu/parallel/mesh.py:pack_segment_codes).  The port's build
    does not use it; the tests compare the packings."""
    rows = []
    for rec in records:
        chunks = []
        for s, e in rec.segments:
            if chunks:
                chunks.append(np.array([-1], dtype=np.int8))
            chunks.append(rec.codes[s:e + 1].astype(np.int8))
        rows.append(np.concatenate(chunks) if chunks else np.zeros(0, dtype=np.int8))
    L = max((len(r) for r in rows), default=1)
    if pad_to is not None:
        L = max(L, pad_to)
    out = np.full((len(rows), max(L, 1)), -1, dtype=np.int8)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


def device_build_counts(records, k: int, dtype_max: int, device=None):
    """records -> (counts [n, 4^k] at the datatype's natural width,
    min(1 + count, dtype_max); one_mers uint64 [n, 4]) as numpy, built on
    `device` (None: the card; raises without one; "cpu" runs the plain
    version), in chunks of records that bound the device memory."""
    from ..native import _pack_records, natural_count_dtype
    from ..ops.kmer_count import kmer_count, packed_on
    from ..runtime import resolve_device

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        resolve_device("cuda")   # raises without a card
    n, d = len(records), 4 ** k
    natural = natural_count_dtype(dtype_max)
    counts = np.empty((n, d), dtype=natural)
    ones = np.empty((n, 4), dtype=np.uint64)
    if n == 0:
        return counts, ones
    packing = _pack_records(records)
    offsets = packing[1]
    max_codes = CHUNK_CODES[dev.type]
    max_rows = max(1, CHUNK_COUNTS // (d * np.dtype(natural).itemsize))
    lo = 0
    while lo < n:
        # the records whose codes fit the chunk, at least one
        hi = int(np.searchsorted(offsets, offsets[lo] + max_codes, side="right")) - 1
        hi = min(max(hi, lo + 1), lo + max_rows, n)
        c, o = kmer_count(*packed_on(packing, dev, lo, hi), k, dtype_max)
        counts[lo:hi] = c.cpu().numpy()
        ones[lo:hi] = o.cpu().numpy()
        lo = hi
    return counts, ones
