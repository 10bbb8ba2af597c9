"""k-mer histogram construction.

Builds the dense [N, 4^k] pseudocounted count matrices that are the universal
data representation of the framework (the reference's DivergencePoint,
DivergencePoint.h:13-88, built by Loader::get_point, Loader.cpp:137-179, over
KmerHashTable's positional base-4 hash, KmerHashTable.cpp:33-160).

Counting itself is a bandwidth-trivial host operation (one pass over the
sequence bytes); the matrices it produces live on device for all pairwise
work.  The hash is big-endian base 4: index = sum_i codes[i] * 4^(k-1-i)
(KmerHashTable.cpp:49-51), computed here with a vectorized Horner sweep.

The port's copy of meshclust2_tpu/kmer/counting.py, without the JAX
package's sharded device build (its MC2_DEVICE_COUNT branch).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from ..io.fasta import SequenceRecord, _split_segments

DTYPE_MAX = {
    "uint8_t": 255,
    "uint16_t": 65535,
    "uint32_t": 4294967295,
    "uint64_t": 2**64 - 1,
}

_DTYPE_ORDER = ["uint8_t", "uint16_t", "uint32_t", "uint64_t"]


def select_datatype(largest_count: int) -> str:
    """Smallest unsigned type that holds the largest pseudocount
    (CRunner.cpp:108-126)."""
    for name in _DTYPE_ORDER:
        if largest_count <= DTYPE_MAX[name]:
            return name
    raise ValueError("count too large")


def kmer_indices(codes: np.ndarray, segments: np.ndarray, k: int) -> np.ndarray:
    """All k-mer hash indices over the record's segments, concatenated.

    Only windows fully inside one segment are counted; segments shorter than k
    contribute nothing (Loader.cpp:53).
    """
    chunks = []
    for s, e in segments:
        n = e - s + 2 - k
        if n <= 0:
            continue
        v = np.zeros(n, dtype=np.int64)
        for j in range(k):
            v *= 4
            v += codes[s + j : s + j + n]
        chunks.append(v)
    if not chunks:
        return np.zeros(0, dtype=np.int64)
    return np.concatenate(chunks)


def count_histogram(record: SequenceRecord, k: int, dtype_max: Optional[int] = None) -> np.ndarray:
    """Pseudocounted histogram: 1 + count, saturated at dtype_max
    (KmerHashTable ctor init value 1, Loader.cpp:141; saturation per
    KmerHashTable.cpp:235-256: min(1+count, max))."""
    d = 4**k
    idx = kmer_indices(record.codes, record.segments, k)
    counts = np.bincount(idx, minlength=d).astype(np.uint64) + 1
    if dtype_max is not None and dtype_max < 2**63:
        counts = np.minimum(counts, np.uint64(dtype_max))
    return counts


def count_1mers(record: SequenceRecord) -> np.ndarray:
    """Pseudocounted 1-mer table over segments (Loader.cpp:144,150)."""
    chunks = [record.codes[s : e + 1] for s, e in record.segments]
    if chunks:
        allc = np.concatenate(chunks)
        counts = np.bincount(allc, minlength=4).astype(np.uint64) + 1
    else:
        counts = np.ones(4, dtype=np.uint64)
    return counts


@dataclass
class PointSet:
    """Columnar equivalent of a vector<DivergencePoint*>: every per-sequence
    quantity the engine needs, as dense arrays (device-transferable).

    Fields mirror DivergencePoint: counts (points vector), mag
    (pseudo-magnitude, DivergencePoint.cpp:99-110), one_mers, stddev
    (Loader.cpp:162-171), length (= effective size, Loader.cpp:156)."""

    k: int
    headers: List[str]
    counts: np.ndarray       # [N, 4^k] pseudocounted, saturated, at the
                             # datatype's natural width (u8/u16/u32)
    one_mers: np.ndarray     # uint64 [N, 4]
    lengths: np.ndarray      # int64 [N] effective sizes
    mags: np.ndarray         # int64 [N] pseudo-magnitudes (sum of counts)
    stddevs: np.ndarray      # float64 [N]
    ids: np.ndarray          # int64 [N]
    seqs: Optional[List[Optional[np.ndarray]]] = None  # raw codes (for training)

    @property
    def n(self) -> int:
        return len(self.headers)

    @property
    def dim(self) -> int:
        return self.counts.shape[1]

    def real_mags(self) -> np.ndarray:
        return self.mags - self.dim

    def subset(self, idx: np.ndarray) -> "PointSet":
        idx = np.asarray(idx)
        return PointSet(
            k=self.k,
            headers=[self.headers[i] for i in idx],
            counts=self.counts[idx],
            one_mers=self.one_mers[idx],
            lengths=self.lengths[idx],
            mags=self.mags[idx],
            stddevs=self.stddevs[idx],
            ids=self.ids[idx],
            seqs=[self.seqs[i] for i in idx] if self.seqs is not None else None,
        )


def build_point_set(
    records: Sequence[SequenceRecord],
    k: int,
    datatype: str = "uint32_t",
    keep_seqs: bool = False,
    start_id: int = 0,
) -> PointSet:
    """Vectorized Loader<T>::get_point over a batch of records
    (Loader.cpp:137-179)."""
    n = len(records)
    d = 4**k
    dtype_max = DTYPE_MAX[datatype]
    lengths = np.zeros(n, dtype=np.int64)
    seqs: Optional[List[Optional[np.ndarray]]] = [] if keep_seqs else None
    headers = []
    from ..native import count_kmers_batch, natural_count_dtype

    native = count_kmers_batch(records, k, dtype_max) if n else None
    if native is not None:
        counts, one_mers = native
    else:
        counts = np.zeros((n, d), dtype=natural_count_dtype(dtype_max))
        one_mers = np.zeros((n, 4), dtype=np.uint64)
    for i, rec in enumerate(records):
        if native is None:
            # saturate at the storage width too ("uint64_t" histograms are
            # stored u32; a per-sequence k-mer count above 2^32-1 would need
            # a >4 Gbp run of one k-mer, but saturating beats wrapping)
            counts[i] = np.minimum(
                count_histogram(rec, k, dtype_max), np.iinfo(counts.dtype).max
            )
            one_mers[i] = count_1mers(rec)
        lengths[i] = rec.effective_size
        headers.append(rec.header)
        if keep_seqs:
            seqs.append(rec.codes)
    mags = counts.sum(axis=1, dtype=np.int64)
    # stddev of the pseudocounted histogram (population), Loader.cpp:162-171,
    # via the exact integer identity sum((c-m)^2) = sum(c^2) - mag^2/d
    # (both terms exact in float64 for realistic counts).
    sq = np.einsum("ij,ij->i", counts, counts, dtype=np.float64)
    means = mags / d
    stddevs = np.sqrt(np.maximum(sq / d - means * means, 0.0))
    ids = np.arange(start_id, start_id + n, dtype=np.int64)
    return PointSet(
        k=k,
        headers=headers,
        counts=counts,
        one_mers=one_mers,
        lengths=lengths,
        mags=mags,
        stddevs=stddevs,
        ids=ids,
        seqs=seqs,
    )


def point_from_codes(header: str, codes: np.ndarray, k: int, datatype: str) -> PointSet:
    """Single-sequence PointSet from raw 0..3 codes (the training path's
    Loader::get_point(header, seq, ...), Loader.cpp:111-134: non-ACGT stripped
    upstream, so the record is one unbroken segment unless shorter than 20)."""
    rec = _record_from_codes(header, codes)
    return build_point_set([rec], k, datatype, keep_seqs=True)


def _record_from_codes(header: str, codes: np.ndarray) -> SequenceRecord:
    n = len(codes)
    # Pure-ACGT string: removeAmbiguous yields [0, n-1] (empty when n==1 due
    # to the last-position quirk, Chromosome.cpp:267-284); mergeSegments only
    # runs when n > 20 and then keeps the single >=20bp segment.
    segs: List = [(0, n - 1)] if n > 1 else []
    segs = _split_segments(segs)
    seg_arr = np.asarray(segs, dtype=np.int64).reshape(-1, 2)
    eff = int((seg_arr[:, 1] - seg_arr[:, 0] + 1).sum()) if len(seg_arr) else 0
    return SequenceRecord(header=header, codes=codes.astype(np.int8), segments=seg_arr,
                          effective_size=eff, total_size=n)


def concat_point_sets(sets: Sequence[PointSet]) -> PointSet:
    assert len(sets) > 0
    if len(sets) == 1:
        return sets[0]
    k = sets[0].k
    return PointSet(
        k=k,
        headers=[h for s in sets for h in s.headers],
        counts=np.concatenate([s.counts for s in sets], axis=0),
        one_mers=np.concatenate([s.one_mers for s in sets], axis=0),
        lengths=np.concatenate([s.lengths for s in sets]),
        mags=np.concatenate([s.mags for s in sets]),
        stddevs=np.concatenate([s.stddevs for s in sets]),
        ids=np.concatenate([s.ids for s in sets]),
        seqs=(
            [q for s in sets for q in (s.seqs if s.seqs is not None else [None] * s.n)]
            if any(s.seqs is not None for s in sets)
            else None
        ),
    )


def largest_pseudocount(records: Sequence[SequenceRecord], k: int) -> int:
    """Datatype-scan pass: max over sequences of max histogram value with
    uint64 pseudocounts (CRunner.cpp:57-94)."""
    if records:
        from ..native import largest_pseudocount_batch

        best = largest_pseudocount_batch(records, k)
        if best is not None:
            return best
    best = 0
    for rec in records:
        h = count_histogram(rec, k, None)
        if len(h):
            best = max(best, int(h.max()))
    return best


def find_k(per_file_records: Sequence[Sequence[SequenceRecord]], n_train_files: int) -> int:
    """Auto k selection (CRunner.cpp:479-502): per file, the *integer* mean of
    effective sizes; integer-mean those over files; k = ceil(log4 L) - 1.

    Two reference quirks preserved: the total divides by the number of
    *train* files while summing over all files, and the effective sizes come
    from makeChromList, whose space-preallocation bug roughly doubles them
    (see SequenceRecord.ref_list_effective_size)."""
    total = 0
    for recs in per_file_records:
        if len(recs) == 0:
            continue
        l = sum(r.ref_list_effective_size for r in recs) // len(recs)
        total += l
    length = total // max(1, n_train_files)
    if length <= 1:
        raise ValueError(
            "cannot auto-select k: no usable sequences in the input "
            "(pass --kmer explicitly or check the FASTA files)"
        )
    import math

    return int(math.ceil(math.log(length) / math.log(4.0))) - 1
