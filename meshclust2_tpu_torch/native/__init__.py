"""Native (C++) runtime helpers, bound via ctypes.

The port's copy of meshclust2_tpu/native/__init__.py with the C++ sources
beside it, Red's helpers and its two-track Viterbi (viterbi.cpp) included.
Compiled on first use with g++ into `build/native/` at the repository
root; falls back to numpy argsort (stable) when no compiler is available,
which loses exact tie-order parity with the reference but keeps everything
functional.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import tempfile
from typing import List, Optional

import numpy as np

_SRCS = [
    os.path.join(os.path.dirname(__file__), "sortperm.cpp"),
    os.path.join(os.path.dirname(__file__), "score.cpp"),
    os.path.join(os.path.dirname(__file__), "accumulate.cpp"),
    os.path.join(os.path.dirname(__file__), "update.cpp"),
    os.path.join(os.path.dirname(__file__), "count.cpp"),
    os.path.join(os.path.dirname(__file__), "encode.cpp"),
    os.path.join(os.path.dirname(__file__), "glm.cpp"),
    os.path.join(os.path.dirname(__file__), "fasta.cpp"),
    os.path.join(os.path.dirname(__file__), "viterbi.cpp"),
]
# score_impl.h is #included by score.cpp/accumulate.cpp; hash it too so the
# cached .so rebuilds when the shared machinery changes
_HDRS = [os.path.join(os.path.dirname(__file__), "score_impl.h")]
_lib: Optional[ctypes.CDLL] = None
_lib_tried = False

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_f64p = ctypes.POINTER(ctypes.c_double)
_PROGRESS_CB = ctypes.CFUNCTYPE(None, ctypes.c_int64)
# per-iteration state export from the native update driver:
# (iteration_completed, n_clusters, centers, member_offsets, members, total)
# -> nonzero aborts the remaining iterations
_STATE_CB = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_int64, ctypes.c_int64, _i64p, _i64p, _i64p,
    ctypes.c_int64,
)


def _build_lib() -> Optional[ctypes.CDLL]:
    h = hashlib.sha256()
    for src in _SRCS + _HDRS:
        with open(src, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    cache = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "build", "native")
    os.makedirs(cache, exist_ok=True)
    so = os.path.join(cache, f"native_{digest}.so")
    if not os.path.exists(so):
        tmp = so + f".tmp{os.getpid()}"
        try:
            subprocess.run(
                ["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
                 "-std=c++17", *_SRCS, "-o", tmp],
                check=True,
                capture_output=True,
            )
            os.replace(tmp, so)
        except Exception as e:
            print(f"meshclust2_tpu_torch: native build failed ({e}); "
                  "falling back to numpy paths", file=sys.stderr)
            return None
    lib = ctypes.CDLL(so)
    i64p = _i64p
    lib.mc2_set_num_threads.argtypes = [ctypes.c_int32]
    lib.sort_perm_u64.argtypes = [ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64, i64p]
    lib.sort_perm_f64.argtypes = [_f64p, ctypes.c_int64, i64p]
    lib.sort_perm_bytes.argtypes = [_u8p, i64p, ctypes.c_int64, i64p]
    lib.supports_features.argtypes = [_i32p, ctypes.c_int32]
    lib.supports_features.restype = ctypes.c_int
    lib.score_block.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, i64p, i64p, _f64p, _f64p,
        ctypes.c_int64,                                  # points view
        i64p, i64p, ctypes.c_int64,                      # pairs
        _i32p, _f64p, _f64p, _u8p, ctypes.c_int32,       # singles
        _i32p, _i32p, _i32p, ctypes.c_int32,             # combos
        _f64p, ctypes.c_double, ctypes.c_int32,          # weights, bias, raw_sum
        _f64p, _f64p,                                    # outputs
    ]
    lib.score_block.restype = ctypes.c_int
    lib.mean_shift_argmin.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, i64p, ctypes.c_int64,
        i64p, i64p, ctypes.c_int64, i64p,
    ]
    lib.mean_shift_argmin.restype = ctypes.c_int
    lib.accumulate_run.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, i64p, i64p, _f64p, _f64p,
        ctypes.c_int64, ctypes.c_int64,                  # points view
        _i32p, _f64p, _f64p, _u8p, ctypes.c_int32,       # singles
        _i32p, _i32p, _i32p, ctypes.c_int32,             # combos
        _f64p, ctypes.c_double,                          # weights, bias
        ctypes.c_double,                                 # similarity
        i64p, i64p, i64p, ctypes.c_int64,                # bvec bins
        _PROGRESS_CB,                                    # progress callback
        i64p, i64p, i64p, i64p, i64p, i64p,              # outputs
    ]
    lib.accumulate_run.restype = ctypes.c_int
    lib.accumulate_resume.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, i64p, i64p, _f64p, _f64p,
        ctypes.c_int64, ctypes.c_int64,                  # points view
        _i32p, _f64p, _f64p, _u8p, ctypes.c_int32,       # singles
        _i32p, _i32p, _i32p, ctypes.c_int32,             # combos
        _f64p, ctypes.c_double,                          # weights, bias
        ctypes.c_double,                                 # similarity
        i64p, i64p, i64p, ctypes.c_int64,                # bvec bins
        i64p, ctypes.c_int64, ctypes.c_int64,            # open cluster, last
        ctypes.c_int32, ctypes.c_int64,                  # pending_mean, steps
        i64p, i64p, i64p, i64p,                          # cluster outputs
        i64p, i64p, i64p,                                # cur, n_cur, last
        i64p, i64p,                                      # pool state out
        i64p, i64p,                                      # windows, pairs
    ]
    lib.accumulate_resume.restype = ctypes.c_int
    lib.update_run.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, i64p, i64p, _f64p, _f64p,
        ctypes.c_int64, ctypes.c_int64,                  # points view
        _i32p, _f64p, _f64p, _u8p, ctypes.c_int32,       # singles
        _i32p, _i32p, _i32p, ctypes.c_int32,             # combos
        _f64p, ctypes.c_double,                          # weights, bias
        ctypes.c_double, ctypes.c_int64, ctypes.c_int64,  # sim, delta, iters
        ctypes.c_int64, i64p, ctypes.c_int64,            # start_it, prior counts
        i64p, i64p, i64p, ctypes.c_int64,                # input clusters
        _PROGRESS_CB,                                    # progress callback
        _STATE_CB,                                       # per-iteration state
        i64p, i64p, i64p, i64p, i64p, i64p,              # outputs
    ]
    lib.update_run.restype = ctypes.c_int
    lib.raw_singles.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, i64p, i64p, _f64p, ctypes.c_int64,
        i64p, i64p, ctypes.c_int64, _i32p, ctypes.c_int32, _f64p,
    ]
    lib.raw_singles.restype = ctypes.c_int
    lib.glm_train_ref.argtypes = [_f64p, ctypes.c_int64, ctypes.c_int64, _f64p, _f64p]
    lib.glm_train_ref.restype = ctypes.c_int
    _i8p = ctypes.POINTER(ctypes.c_int8)
    lib.count_kmers_batch.argtypes = [
        _i8p, _i64p, _i64p, _i64p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_uint64, ctypes.c_int32, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.largest_pseudocount_batch.argtypes = [
        _i8p, _i64p, _i64p, _i64p, ctypes.c_int64, ctypes.c_int32,
    ]
    lib.largest_pseudocount_batch.restype = ctypes.c_uint64
    lib.encode_batch_meta.argtypes = [_u8p, _i64p, ctypes.c_int64, _i64p]
    lib.encode_batch_meta.restype = ctypes.c_int
    lib.encode_batch_fill.argtypes = [
        _u8p, _i64p, ctypes.c_int64, _i8p, _i64p, _i64p, _i64p,
    ]
    lib.encode_batch_fill.restype = ctypes.c_int
    lib.fasta_scan_fill.argtypes = [
        _u8p, ctypes.c_int64, ctypes.c_int64, i64p, _u8p, i64p, i64p, i64p,
    ]
    lib.fasta_scan_fill.restype = ctypes.c_int
    lib.red_chain_scores.argtypes = [
        _i64p, _f64p, _i64p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_double, ctypes.c_int64, _i64p,
    ]
    _i8p = ctypes.POINTER(ctypes.c_int8)
    lib.count_words_raw.argtypes = [
        _i8p, _i64p, ctypes.c_int64, ctypes.c_int32, _i64p,
    ]
    lib.red_score_bases.argtypes = [
        _i8p, _i64p, ctypes.c_int64, ctypes.c_int32, _i64p, _i64p,
    ]
    lib.red_derivatives.argtypes = [
        _f64p, ctypes.c_int64, ctypes.c_int64, _f64p, _f64p, _f64p,
    ]
    _i8p = ctypes.POINTER(ctypes.c_int8)
    lib.viterbi_two_track.argtypes = [
        _i64p, ctypes.c_int64, _f64p, _f64p, ctypes.c_int64, _i8p, _i8p,
    ]
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    if os.environ.get("MC2_NO_NATIVE"):  # force the numpy fallback paths
        return None
    if not _lib_tried:
        _lib = _build_lib()
        _lib_tried = True
    return _lib


def red_chain_scores(observed: np.ndarray, probs_list, k: int, order: int,
                     l: float, min_obs: int):
    """Fused Red expectation chain + adjusted scores (bitwise-identical to
    red/table.py's numpy path).  Returns int64 [4^k] or None when the
    native library is unavailable."""
    lib = _get_lib()
    if lib is None:
        return None
    obs = np.ascontiguousarray(observed, dtype=np.int64)
    flat = np.ascontiguousarray(np.concatenate(probs_list), dtype=np.float64)
    offsets = np.zeros(len(probs_list) + 1, dtype=np.int64)
    np.cumsum([len(p) for p in probs_list], out=offsets[1:])
    out = np.empty(4**k, dtype=np.int64)
    lib.red_chain_scores(
        obs.ctypes.data_as(_i64p), flat.ctypes.data_as(_f64p),
        offsets.ctypes.data_as(_i64p), k, order,
        ctypes.c_double(float(l)), int(min_obs),
        out.ctypes.data_as(_i64p),
    )
    return out


def count_words_raw(codes: np.ndarray, segments: np.ndarray, k: int,
                    out: np.ndarray) -> bool:
    """Accumulate raw k-mer counts of one record into `out` ([4^k] int64).
    Returns False when the native library is unavailable."""
    lib = _get_lib()
    if lib is None:
        return False
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    segs = np.ascontiguousarray(segments, dtype=np.int64)
    lib.count_words_raw(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        segs.ctypes.data_as(_i64p), len(segments), int(k),
        out.ctypes.data_as(_i64p),
    )
    return True


def red_score_bases(codes: np.ndarray, segments: np.ndarray, k: int,
                    table: np.ndarray):
    """Per-base adjusted scores for one record (int64 [len(codes)]), or
    None when the native library is unavailable."""
    lib = _get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    segs = np.ascontiguousarray(segments, dtype=np.int64)
    table = np.ascontiguousarray(table, dtype=np.int64)
    out = np.zeros(len(codes), dtype=np.int64)
    lib.red_score_bases(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        segs.ctypes.data_as(_i64p), len(segments), int(k),
        table.ctypes.data_as(_i64p), out.ctypes.data_as(_i64p),
    )
    return out


def red_derivatives(scores: np.ndarray, w: int):
    """(first, second) rounded boxcar differences, or None when the native
    library is unavailable."""
    lib = _get_lib()
    n = len(scores)
    if lib is None or n < 2 * w + 1:
        return None
    scores = np.ascontiguousarray(scores, dtype=np.float64)
    buf = np.empty(n + 1, dtype=np.float64)
    m = n - 2 * w
    first = np.empty(m, dtype=np.float64)
    second = np.empty(m, dtype=np.float64)
    lib.red_derivatives(
        scores.ctypes.data_as(_f64p), n, int(w),
        buf.ctypes.data_as(_f64p), first.ctypes.data_as(_f64p),
        second.ctypes.data_as(_f64p),
    )
    return first, second


def set_num_threads(n: int) -> None:
    """Cap the native library's OpenMP parallelism (the --threads flag;
    CRunner.cpp:407-422).  No-op when the native library is unavailable."""
    lib = _get_lib()
    if lib is not None and n > 0:
        lib.mc2_set_num_threads(int(n))


def sort_perm(keys: np.ndarray) -> np.ndarray:
    """std::sort-equivalent permutation for numeric keys (unstable tie
    order matching libstdc++)."""
    keys = np.ascontiguousarray(keys)
    n = len(keys)
    perm = np.empty(n, dtype=np.int64)
    lib = _get_lib()
    if lib is None:
        return np.argsort(keys, kind="stable")
    if keys.dtype == np.uint64 or keys.dtype == np.int64:
        if keys.dtype == np.int64 and len(keys) and int(keys.min()) < 0:
            raise ValueError(
                "sort_perm: negative int64 keys would reinterpret as uint64"
            )
        k = keys.astype(np.uint64)
        lib.sort_perm_u64(
            k.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            n,
            perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
    else:
        k = keys.astype(np.float64)
        lib.sort_perm_f64(
            k.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            n,
            perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
    return perm


def sort_perm_strings(strings: List[str]) -> np.ndarray:
    """std::sort-equivalent permutation for byte strings."""
    lib = _get_lib()
    n = len(strings)
    if lib is None:
        return np.argsort(np.array(strings, dtype=object), kind="stable").astype(np.int64)
    bufs = [s.encode("utf-8", "surrogateescape") for s in strings]
    offsets = np.zeros(n + 1, dtype=np.int64)
    for i, b in enumerate(bufs):
        offsets[i + 1] = offsets[i] + len(b)
    blob = np.frombuffer(b"".join(bufs), dtype=np.uint8) if bufs else np.zeros(0, np.uint8)
    blob = np.ascontiguousarray(blob)
    if len(blob) == 0:
        blob = np.zeros(1, dtype=np.uint8)
    perm = np.empty(n, dtype=np.int64)
    lib.sort_perm_bytes(
        blob.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n,
        perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return perm


def _pack_records(records):
    # encode_records returns its records as views into one encoded batch
    # blob and hands the blob along (io/fasta.py:RecordList); reuse it
    # instead of re-concatenating 100k per-record views.  The alias check
    # must NOT use `.base is batch[0]`: when the encoder works in place,
    # batch[0] is itself a view of the raw blob and numpy collapses the
    # records' view chains straight to that underlying blob, so `.base`
    # skips past batch[0] (this silently disabled the fast path and cost
    # ~11s re-packing at 1M records).
    batch = getattr(records, "batch", None)
    if batch is not None and len(batch[1]) == len(records) + 1:
        if len(records) == 0 or np.may_share_memory(records[0].codes, batch[0]):
            return batch
    offsets = np.zeros(len(records) + 1, dtype=np.int64)
    seg_offsets = np.zeros(len(records) + 1, dtype=np.int64)
    for i, r in enumerate(records):
        offsets[i + 1] = offsets[i] + len(r.codes)
        seg_offsets[i + 1] = seg_offsets[i] + len(r.segments)
    codes = (
        np.concatenate([r.codes for r in records])
        if records
        else np.zeros(0, np.int8)
    ).astype(np.int8)
    segs = (
        np.concatenate([r.segments.reshape(-1) for r in records])
        if records
        else np.zeros(0, np.int64)
    ).astype(np.int64)
    if len(codes) == 0:
        codes = np.zeros(1, np.int8)
    if len(segs) == 0:
        segs = np.zeros(2, np.int64)
    return (
        np.ascontiguousarray(codes),
        np.ascontiguousarray(offsets),
        np.ascontiguousarray(segs),
        np.ascontiguousarray(seg_offsets),
    )


def natural_count_dtype(dtype_max: int):
    """Narrowest numpy dtype holding the saturated histogram values."""
    if dtype_max <= 0xFF:
        return np.uint8
    if dtype_max <= 0xFFFF:
        return np.uint16
    return np.uint32


def count_kmers_batch(records, k: int, dtype_max: int):
    """Native batched histogram build; returns (counts [n, 4^k] at the
    datatype's natural width, one_mers u64 [n, 4]) or None when the native
    library is unavailable."""
    lib = _get_lib()
    if lib is None:
        return None
    n = len(records)
    d = 4**k
    codes, offsets, segs, seg_offsets = _pack_records(records)
    counts = np.empty((n, d), dtype=natural_count_dtype(dtype_max))
    ones = np.empty((n, 4), dtype=np.uint64)
    lib.count_kmers_batch(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        offsets.ctypes.data_as(_i64p),
        segs.ctypes.data_as(_i64p),
        seg_offsets.ctypes.data_as(_i64p),
        n, k, min(dtype_max, 2**64 - 1), counts.itemsize,
        counts.ctypes.data_as(ctypes.c_void_p),
        ones.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    return counts, ones


def largest_pseudocount_batch(records, k: int):
    lib = _get_lib()
    if lib is None:
        return None
    codes, offsets, segs, seg_offsets = _pack_records(records)
    return int(
        lib.largest_pseudocount_batch(
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            offsets.ctypes.data_as(_i64p),
            segs.ctypes.data_as(_i64p),
            seg_offsets.ctypes.data_as(_i64p),
            len(records), k,
        )
    )


def glm_train_native(X: np.ndarray, y: np.ndarray):
    """Reference-bitwise GLM solve (native, same FMA contraction as the
    reference binary); returns weights [m] or None when unavailable."""
    lib = _get_lib()
    if lib is None:
        return None
    X = np.ascontiguousarray(X, dtype=np.float64)
    y = np.ascontiguousarray(y, dtype=np.float64)
    n, m = X.shape
    w = np.empty(m, dtype=np.float64)
    lib.glm_train_ref(
        X.ctypes.data_as(_f64p), n, m,
        y.ctypes.data_as(_f64p), w.ctypes.data_as(_f64p),
    )
    return w


def raw_singles_batch(ps, a_rows: np.ndarray, b_rows: np.ndarray,
                      flags_list):
    """Raw single-feature values with the reference's accumulation order
    ([P, S] float64), or None when the native library is unavailable or a
    feature has no native implementation (caller falls back to the numpy
    oracle)."""
    from ..features.flags import feat_log2

    lib = _get_lib()
    if lib is None:
        return None
    ids = np.array([feat_log2(f) for f in flags_list], dtype=np.int32)
    if lib.supports_features(ids.ctypes.data_as(_i32p), len(ids)) != 0:
        return None
    counts = np.ascontiguousarray(ps.counts)
    if counts.dtype not in (np.uint8, np.uint16, np.uint32):
        counts = counts.astype(np.uint32)
    mags = np.ascontiguousarray(ps.mags, dtype=np.int64)
    lengths = np.ascontiguousarray(ps.lengths, dtype=np.int64)
    stddevs = np.ascontiguousarray(ps.stddevs, dtype=np.float64)
    a_rows = np.ascontiguousarray(a_rows, dtype=np.int64)
    b_rows = np.ascontiguousarray(b_rows, dtype=np.int64)
    out = np.empty((len(a_rows), len(ids)), dtype=np.float64)
    rc = lib.raw_singles(
        counts.ctypes.data_as(ctypes.c_void_p), counts.itemsize,
        mags.ctypes.data_as(_i64p), lengths.ctypes.data_as(_i64p),
        stddevs.ctypes.data_as(_f64p), counts.shape[1],
        a_rows.ctypes.data_as(_i64p), b_rows.ctypes.data_as(_i64p),
        len(a_rows),
        ids.ctypes.data_as(_i32p), len(ids),
        out.ctypes.data_as(_f64p),
    )
    if rc != 0:
        return None
    return out


def mean_shift_argmin_batch(counts: np.ndarray, mags: np.ndarray,
                            member_rows: np.ndarray, seg_offsets: np.ndarray):
    """Per-segment closest-to-mean member rows (exact distance_d semantics);
    returns int64 [n_segs] with -1 for empty segments, or None when the
    native library is unavailable."""
    lib = _get_lib()
    if lib is None:
        return None
    counts = np.ascontiguousarray(counts)
    if counts.dtype not in (np.uint8, np.uint16, np.uint32):
        counts = counts.astype(np.uint32)
    mags = np.ascontiguousarray(mags, dtype=np.int64)
    member_rows = np.ascontiguousarray(member_rows, dtype=np.int64)
    seg_offsets = np.ascontiguousarray(seg_offsets, dtype=np.int64)
    n_segs = len(seg_offsets) - 1
    out = np.empty(n_segs, dtype=np.int64)
    lib.mean_shift_argmin(
        counts.ctypes.data_as(ctypes.c_void_p),
        counts.itemsize,
        mags.ctypes.data_as(_i64p),
        counts.shape[1],
        member_rows.ctypes.data_as(_i64p),
        seg_offsets.ctypes.data_as(_i64p),
        n_segs,
        out.ctypes.data_as(_i64p),
    )
    return out


def fasta_scan(data: bytes):
    """Single-pass native FASTA scan: (hdr_ranges int64 [m, 2], blob uint8,
    rec_offsets int64 [m+1]) with newlines/CRs stripped from the blob and
    CR stripped from header ranges, or None when the native library is
    unavailable or the input needs the per-line parser (space/tab line
    starts, non-CRLF carriage returns)."""
    lib = _get_lib()
    if lib is None or not data:
        return None
    max_hdrs = data.count(b">")
    if max_hdrs == 0:
        return (
            np.zeros((0, 2), np.int64),
            np.zeros(0, np.uint8),
            np.zeros(1, np.int64),
        )
    buf = np.frombuffer(data, dtype=np.uint8)
    hdr_ranges = np.empty(2 * max_hdrs, dtype=np.int64)
    blob = np.empty(len(data), dtype=np.uint8)
    rec_offsets = np.empty(max_hdrs + 1, dtype=np.int64)
    nrec = np.zeros(1, dtype=np.int64)
    blob_len = np.zeros(1, dtype=np.int64)
    rc = lib.fasta_scan_fill(
        buf.ctypes.data_as(_u8p), len(data), max_hdrs,
        hdr_ranges.ctypes.data_as(_i64p),
        blob.ctypes.data_as(_u8p),
        rec_offsets.ctypes.data_as(_i64p),
        nrec.ctypes.data_as(_i64p),
        blob_len.ctypes.data_as(_i64p),
    )
    if rc != 0:
        return None
    m = int(nrec[0])
    return (
        hdr_ranges[: 2 * m].reshape(m, 2),
        blob[: int(blob_len[0])],
        rec_offsets[: m + 1],
    )


def encode_batch(raw_seqs):
    """Native batched sequence encoding: list of raw byte strings ->
    (codes int8 blob, code_offsets, segments int64 [S,2] blob, seg_offsets,
    effective, ref_list_effective, gc) or None when unavailable or when an
    invalid letter is present (caller falls back per record)."""
    n = len(raw_seqs)
    offsets = np.zeros(n + 1, dtype=np.int64)
    for i, s in enumerate(raw_seqs):
        offsets[i + 1] = offsets[i] + len(s)
    blob = np.frombuffer(b"".join(raw_seqs), dtype=np.uint8) if n else np.zeros(0, np.uint8)
    return encode_batch_arrays(blob, offsets)


def encode_batch_arrays(blob: np.ndarray, offsets: np.ndarray):
    """encode_batch over a pre-joined uint8 sequence blob with int64 record
    offsets [n+1] (the shape the vectorized FASTA parser produces).

    DESTRUCTIVE: when `blob` is writable and contiguous it is encoded IN
    PLACE (its letter bytes become codes 0-3/-1), including on the
    invalid-letter error path, where the function returns None with the
    blob partially overwritten.  Callers that still need the raw bytes
    must pass a copy (read-only views are copied internally)."""
    lib = _get_lib()
    if lib is None:
        return None
    n = len(offsets) - 1
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    blob = np.ascontiguousarray(blob, dtype=np.uint8)
    if not blob.flags.writeable:
        # the fill pass encodes in place (frombuffer(bytes) views are
        # read-only and must not be written through)
        blob = blob.copy()
    if len(blob) == 0:
        blob = np.zeros(1, dtype=np.uint8)
    meta = np.zeros(5 * n, dtype=np.int64)
    lib.encode_batch_meta(
        blob.ctypes.data_as(_u8p), offsets.ctypes.data_as(_i64p), n,
        meta.ctypes.data_as(_i64p),
    )
    meta = meta.reshape(n, 5)
    seg_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(meta[:, 0], out=seg_offsets[1:])
    # encode in place over the sequence blob (the fill pass is single-sweep
    # aliasing-safe) — a fresh GB-scale codes buffer would pay this VM's
    # slow first-touch fault path all over again
    codes = blob[: int(offsets[-1])].view(np.int8)
    segs = np.empty(2 * int(seg_offsets[-1]), dtype=np.int64)
    if len(codes) == 0:
        codes = np.zeros(1, dtype=np.int8)
    if len(segs) == 0:
        segs = np.zeros(2, dtype=np.int64)
    err = np.zeros(1, dtype=np.int64)
    lib.encode_batch_fill(
        blob.ctypes.data_as(_u8p), offsets.ctypes.data_as(_i64p), n,
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        seg_offsets.ctypes.data_as(_i64p),
        segs.ctypes.data_as(_i64p),
        err.ctypes.data_as(_i64p),
    )
    if err[0] != 0:
        return None
    return codes, offsets, segs, seg_offsets, meta


def viterbi_two_track(seg: np.ndarray, p_log: np.ndarray, t_log: np.ndarray,
                      P: int):
    """Native two-track Viterbi; returns int8 states [n] (0=positive track)
    or None when the library is unavailable."""
    lib = _get_lib()
    if lib is None:
        return None
    seg = np.ascontiguousarray(seg, dtype=np.int64)
    p_log = np.ascontiguousarray(p_log, dtype=np.float64)
    t_log = np.ascontiguousarray(t_log, dtype=np.float64)
    n = len(seg)
    back = np.zeros((n, 2), dtype=np.int8)
    states = np.zeros(n, dtype=np.int8)
    lib.viterbi_two_track(
        seg.ctypes.data_as(_i64p), n,
        p_log.ctypes.data_as(_f64p),
        t_log.ctypes.data_as(_f64p),
        P,
        back.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        states.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
    )
    return states


class NativeScorer:
    """Exact float64 classifier scoring through the native score_block —
    the latency-optimized path for the sequential accumulate phase.

    Falls back to None from `create` when the model uses a feature with no
    native implementation or the library is unavailable.
    """

    def __init__(self, ps, model, lib):
        from ..features.flags import feat_log2

        self.ps = ps
        self.model = model
        self._lib = lib
        # store counts at the narrowest width that holds them: uint8
        # histograms stream 4x less memory through the fused kernel
        cmax = int(ps.counts.max()) if ps.counts.size else 0
        if cmax <= 0xFF:
            self._counts = np.ascontiguousarray(ps.counts, dtype=np.uint8)
        elif cmax <= 0xFFFF:
            self._counts = np.ascontiguousarray(ps.counts, dtype=np.uint16)
        else:
            self._counts = np.ascontiguousarray(ps.counts, dtype=np.uint32)
        self._elem_width = self._counts.itemsize
        # exact integer sums of squares (< 2^53), accumulated by einsum
        # without materializing a float64 copy of the whole count matrix
        self._self_dots = np.ascontiguousarray(
            np.einsum("ij,ij->i", self._counts, self._counts,
                      dtype=np.float64)
        )
        self._mags = np.ascontiguousarray(ps.mags, dtype=np.int64)
        self._lengths = np.ascontiguousarray(ps.lengths, dtype=np.int64)
        self._stddevs = np.ascontiguousarray(ps.stddevs, dtype=np.float64)
        self._single_ids = np.array(
            [feat_log2(s) for s in model.singles], dtype=np.int32
        )
        self._mins = np.ascontiguousarray(model.mins, dtype=np.float64)
        self._maxs = np.ascontiguousarray(model.maxs, dtype=np.float64)
        self._is_sim = np.ascontiguousarray(model.is_sim, dtype=np.uint8)
        kinds = {"xy": 0, "xy2": 1, "x2y": 2, "x2y2": 3}
        ck, c0, c1 = [], [], []
        for kind, idxs in model.combos:
            ck.append(kinds[kind])
            c0.append(idxs[0])
            c1.append(idxs[1] if len(idxs) > 1 else -1)
        self._ck = np.array(ck, dtype=np.int32)
        self._c0 = np.array(c0, dtype=np.int32)
        self._c1 = np.array(c1, dtype=np.int32)
        self._weights = np.ascontiguousarray(model.weights, dtype=np.float64)
        self._bias = float(model.bias)

    @classmethod
    def supports(cls, model) -> bool:
        """True when the native library is available and implements every
        single feature the model uses (cheap; no point-set state built)."""
        from ..features.flags import feat_log2

        lib = _get_lib()
        if lib is None:
            return False
        ids = np.array([feat_log2(s) for s in model.singles], dtype=np.int32)
        return lib.supports_features(ids.ctypes.data_as(_i32p), len(ids)) == 0

    @classmethod
    def create(cls, ps, model):
        lib = _get_lib()
        if lib is None or not cls.supports(model):
            return None
        return cls(ps, model, lib)

    def score(self, a_rows, b_rows, raw_sum: bool = False):
        a_rows = np.atleast_1d(np.asarray(a_rows, dtype=np.int64))
        b_rows = np.atleast_1d(np.asarray(b_rows, dtype=np.int64))
        if len(b_rows) == 1 and len(a_rows) > 1:
            b_rows = np.broadcast_to(b_rows, a_rows.shape)
        if len(a_rows) == 1 and len(b_rows) > 1:
            a_rows = np.broadcast_to(a_rows, b_rows.shape)
        a_rows = np.ascontiguousarray(a_rows, dtype=np.int64)
        b_rows = np.ascontiguousarray(b_rows, dtype=np.int64)
        if len(a_rows) != len(b_rows):
            raise ValueError(
                f"score: length mismatch {len(a_rows)} vs {len(b_rows)}"
            )
        n = len(a_rows)
        prob = np.empty(n, dtype=np.float64)
        dist = np.empty(n, dtype=np.float64)
        rc = self._lib.score_block(
            self._counts.ctypes.data_as(ctypes.c_void_p),
            self._elem_width,
            self._mags.ctypes.data_as(_i64p),
            self._lengths.ctypes.data_as(_i64p),
            self._stddevs.ctypes.data_as(_f64p),
            self._self_dots.ctypes.data_as(_f64p),
            self._counts.shape[1],
            a_rows.ctypes.data_as(_i64p),
            b_rows.ctypes.data_as(_i64p),
            n,
            self._single_ids.ctypes.data_as(_i32p),
            self._mins.ctypes.data_as(_f64p),
            self._maxs.ctypes.data_as(_f64p),
            self._is_sim.ctypes.data_as(_u8p),
            len(self._single_ids),
            self._ck.ctypes.data_as(_i32p),
            self._c0.ctypes.data_as(_i32p),
            self._c1.ctypes.data_as(_i32p),
            len(self._ck),
            self._weights.ctypes.data_as(_f64p),
            self._bias,
            1 if raw_sum else 0,
            prob.ctypes.data_as(_f64p),
            dist.ctypes.data_as(_f64p),
        )
        if rc != 0:
            raise RuntimeError("native score_block failed")
        return prob, dist

    def accumulate(self, bv, sim: float, progress_step=None):
        """Run the whole accumulate phase natively over a freshly-finalized
        BVec (cluster/bvec.py).  Returns (centers, member_offsets, members,
        windows_scored, pairs_scored) — flat int64 arrays with cluster i's
        members at members[member_offsets[i]:member_offsets[i+1]] — or None
        when the native driver declines (unsupported feature)."""
        n = len(self._lengths)
        bin_rows = (
            np.concatenate(bv.bins) if bv.bins else np.zeros(0, np.int64)
        )
        bin_rows = np.ascontiguousarray(bin_rows, dtype=np.int64)
        bin_offsets = np.zeros(len(bv.bins) + 1, dtype=np.int64)
        np.cumsum([len(b) for b in bv.bins], out=bin_offsets[1:])
        bounds = np.ascontiguousarray(bv._bounds_arr, dtype=np.int64)
        centers = np.empty(n, dtype=np.int64)
        offsets = np.empty(n + 1, dtype=np.int64)
        members = np.empty(n, dtype=np.int64)
        stats = np.zeros(3, dtype=np.int64)  # n_clusters, windows, pairs
        if progress_step is not None:
            cb = _PROGRESS_CB(lambda k: progress_step(k))
        else:
            cb = _PROGRESS_CB(0)
        rc = self._lib.accumulate_run(
            self._counts.ctypes.data_as(ctypes.c_void_p),
            self._elem_width,
            self._mags.ctypes.data_as(_i64p),
            self._lengths.ctypes.data_as(_i64p),
            self._stddevs.ctypes.data_as(_f64p),
            self._self_dots.ctypes.data_as(_f64p),
            self._counts.shape[1], n,
            self._single_ids.ctypes.data_as(_i32p),
            self._mins.ctypes.data_as(_f64p),
            self._maxs.ctypes.data_as(_f64p),
            self._is_sim.ctypes.data_as(_u8p),
            len(self._single_ids),
            self._ck.ctypes.data_as(_i32p),
            self._c0.ctypes.data_as(_i32p),
            self._c1.ctypes.data_as(_i32p),
            len(self._ck),
            self._weights.ctypes.data_as(_f64p),
            self._bias,
            float(sim),
            bin_rows.ctypes.data_as(_i64p),
            bin_offsets.ctypes.data_as(_i64p),
            bounds.ctypes.data_as(_i64p),
            len(bv.bins),
            cb,
            centers.ctypes.data_as(_i64p),
            offsets.ctypes.data_as(_i64p),
            members.ctypes.data_as(_i64p),
            stats[0:].ctypes.data_as(_i64p),
            stats[1:].ctypes.data_as(_i64p),
            stats[2:].ctypes.data_as(_i64p),
        )
        if rc != 0:
            return None
        nc = int(stats[0])
        return (
            centers[:nc],
            offsets[: nc + 1],
            members,
            int(stats[1]),
            int(stats[2]),
        )

    def resume(self, bv, sim: float, cur_members, last: int,
               pending_mean: bool, max_steps: int):
        """Run up to `max_steps` accumulate steps natively from an
        arbitrary mid-phase state (engine._resolve_steps semantics: one
        step = one pending-mean resolution or one window scan).  Returns
        (clusters_raw, cur_members, last, bv_state, windows, pairs) where
        clusters_raw is [(center, members_array)], last is None when the
        pool emptied (run complete), and bv_state is (bin_rows_per_bin
        list) to rebuild the pool — or None when the driver declines."""
        n = len(self._lengths)
        bin_rows = (
            np.concatenate(bv.bins) if bv.bins else np.zeros(0, np.int64)
        )
        bin_rows = np.ascontiguousarray(bin_rows, dtype=np.int64)
        nb = len(bv.bins)
        bin_offsets = np.zeros(nb + 1, dtype=np.int64)
        np.cumsum([len(b) for b in bv.bins], out=bin_offsets[1:])
        bounds = np.ascontiguousarray(bv._bounds_arr, dtype=np.int64)
        cur = np.ascontiguousarray(
            np.asarray(cur_members, dtype=np.int64))
        centers = np.empty(n, dtype=np.int64)
        offsets = np.empty(n + 1, dtype=np.int64)
        members = np.empty(n, dtype=np.int64)
        out_cur = np.empty(n, dtype=np.int64)
        out_rows = np.empty(max(n, 1), dtype=np.int64)
        out_boff = np.empty(nb + 1, dtype=np.int64)
        scal = np.zeros(5, dtype=np.int64)  # n_clusters, n_cur, last, w, p
        rc = self._lib.accumulate_resume(
            self._counts.ctypes.data_as(ctypes.c_void_p),
            self._elem_width,
            self._mags.ctypes.data_as(_i64p),
            self._lengths.ctypes.data_as(_i64p),
            self._stddevs.ctypes.data_as(_f64p),
            self._self_dots.ctypes.data_as(_f64p),
            self._counts.shape[1], n,
            self._single_ids.ctypes.data_as(_i32p),
            self._mins.ctypes.data_as(_f64p),
            self._maxs.ctypes.data_as(_f64p),
            self._is_sim.ctypes.data_as(_u8p),
            len(self._single_ids),
            self._ck.ctypes.data_as(_i32p),
            self._c0.ctypes.data_as(_i32p),
            self._c1.ctypes.data_as(_i32p),
            len(self._ck),
            self._weights.ctypes.data_as(_f64p),
            self._bias,
            float(sim),
            bin_rows.ctypes.data_as(_i64p),
            bin_offsets.ctypes.data_as(_i64p),
            bounds.ctypes.data_as(_i64p),
            nb,
            cur.ctypes.data_as(_i64p),
            len(cur),
            int(last),
            1 if pending_mean else 0,
            int(max_steps),
            centers.ctypes.data_as(_i64p),
            offsets.ctypes.data_as(_i64p),
            members.ctypes.data_as(_i64p),
            scal[0:].ctypes.data_as(_i64p),
            out_cur.ctypes.data_as(_i64p),
            scal[1:].ctypes.data_as(_i64p),
            scal[2:].ctypes.data_as(_i64p),
            out_rows.ctypes.data_as(_i64p),
            out_boff.ctypes.data_as(_i64p),
            scal[3:].ctypes.data_as(_i64p),
            scal[4:].ctypes.data_as(_i64p),
        )
        if rc != 0:
            return None
        n_cl = int(scal[0])
        clusters_raw = [
            (int(centers[i]), members[offsets[i]:offsets[i + 1]].copy())
            for i in range(n_cl)
        ]
        out_last = int(scal[2])
        if out_last < 0:
            return (clusters_raw, None, None, None,
                    int(scal[3]), int(scal[4]))
        bins = [out_rows[out_boff[b]:out_boff[b + 1]].copy()
                for b in range(nb)]
        return (clusters_raw, out_cur[:int(scal[1])].copy(), out_last,
                bins, int(scal[3]), int(scal[4]))

    def update(self, clusters, sim: float, delta: int, iterations: int,
               progress_step=None, start_it: int = 0,
               prior_counts=None, state_cb=None):
        """Run the whole update/merge phase natively (native/update.cpp)
        over (center_row, members) clusters.  Returns (centers,
        member_offsets, members, iterations_run, pairs_scored) flat int64
        arrays, or None when the native driver declines.

        Resume support: ``start_it`` and ``prior_counts`` (the cluster-count
        history of the already-executed iterations, len == start_it) make the
        3-iterations-ago early stop see the same history as an unbroken run.
        ``state_cb(it, centers, offsets, members)`` (numpy views, valid only
        during the call) is invoked after every completed iteration; a
        truthy return aborts the remaining iterations."""
        in_centers = np.array([c.center_row for c in clusters],
                              dtype=np.int64)
        nc_in = len(clusters)
        in_offsets = np.zeros(nc_in + 1, dtype=np.int64)
        np.cumsum([len(c.members) for c in clusters], out=in_offsets[1:])
        total = int(in_offsets[-1])
        in_members = np.empty(total, dtype=np.int64)
        for i, c in enumerate(clusters):
            in_members[in_offsets[i]:in_offsets[i + 1]] = c.members
        out_centers = np.empty(max(nc_in, 1), dtype=np.int64)
        out_offsets = np.empty(nc_in + 1, dtype=np.int64)
        out_members = np.empty(max(total, 1), dtype=np.int64)
        stats = np.zeros(3, dtype=np.int64)  # n_clusters, iterations, pairs
        if progress_step is not None:
            cb = _PROGRESS_CB(lambda k: progress_step(k))
        else:
            cb = _PROGRESS_CB(0)
        prior = np.asarray(
            prior_counts if prior_counts is not None else [], dtype=np.int64
        )
        if len(prior) != start_it:
            raise ValueError(
                f"prior_counts must have start_it={start_it} entries, "
                f"got {len(prior)}"
            )
        if state_cb is not None:
            def _state_thunk(it, nc, cen_p, off_p, mem_p, tot):
                cen = np.ctypeslib.as_array(cen_p, shape=(nc,))
                off = np.ctypeslib.as_array(off_p, shape=(nc + 1,))
                mem = np.ctypeslib.as_array(mem_p, shape=(tot,))
                return int(bool(state_cb(int(it), cen, off, mem)))

            scb = _STATE_CB(_state_thunk)
        else:
            scb = _STATE_CB(0)
        rc = self._lib.update_run(
            self._counts.ctypes.data_as(ctypes.c_void_p),
            self._elem_width,
            self._mags.ctypes.data_as(_i64p),
            self._lengths.ctypes.data_as(_i64p),
            self._stddevs.ctypes.data_as(_f64p),
            self._self_dots.ctypes.data_as(_f64p),
            self._counts.shape[1], len(self._lengths),
            self._single_ids.ctypes.data_as(_i32p),
            self._mins.ctypes.data_as(_f64p),
            self._maxs.ctypes.data_as(_f64p),
            self._is_sim.ctypes.data_as(_u8p),
            len(self._single_ids),
            self._ck.ctypes.data_as(_i32p),
            self._c0.ctypes.data_as(_i32p),
            self._c1.ctypes.data_as(_i32p),
            len(self._ck),
            self._weights.ctypes.data_as(_f64p),
            self._bias,
            float(sim), int(delta), int(iterations),
            int(start_it), prior.ctypes.data_as(_i64p), len(prior),
            in_centers.ctypes.data_as(_i64p),
            in_offsets.ctypes.data_as(_i64p),
            in_members.ctypes.data_as(_i64p),
            nc_in,
            cb,
            scb,
            out_centers.ctypes.data_as(_i64p),
            out_offsets.ctypes.data_as(_i64p),
            out_members.ctypes.data_as(_i64p),
            stats[0:].ctypes.data_as(_i64p),
            stats[1:].ctypes.data_as(_i64p),
            stats[2:].ctypes.data_as(_i64p),
        )
        if rc != 0:
            return None
        nc = int(stats[0])
        return (
            out_centers[:nc],
            out_offsets[: nc + 1],
            out_members,
            int(stats[1]),
            int(stats[2]),
        )
