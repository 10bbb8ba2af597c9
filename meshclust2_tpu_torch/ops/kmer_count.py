"""The k-mer histogram build: per record, its pseudocounted saturating 4^k
k-mer counts and its pseudocounted 1-mer counts.

The port of meshclust2_tpu/parallel/mesh.py:sharded_histogram_build
(one_seq, lines 200-218), an XLA program sharded over a TPU mesh.  On CUDA
tensors `kmer_count` launches the hand-written kernel in
csrc/kmer_count.cu (a warp a piece of a record of `launch_plan`'s length:
short records several to a block, long ones spread over the SMs and summed
in a zeroed scratch); on CPU tensors it runs `kmer_count_ref`, the plain
PyTorch version (bincount over the windows' flat indices), which the CPU
tests hold against the JAX program and the native counter.  In a
multi-process run each rank counts its own block of records with it
(parallel/multihost.py:build_global_points).

The input is the native counter's ragged packing (native/__init__.py:
_pack_records): the records' codes concatenated as int8 with offsets [n + 1],
and their segments as (start, end inclusive) pairs relative to each
record, with segment offsets [n + 1].  A window counts when its k codes lie
wholly inside one segment; a record's 1-mers count its segment positions.
Codes inside the segments are 0..3.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

# the positions of a work item (a warp) at the least, and at the most where
# the warps' histograms hold 16-bit counters (k <= SHARED_K, the kernel's
# kSharedK; above it the kernel's global instantiation)
PIECE = 8192
MAX_SHARED_PIECE = 65535
SHARED_K = 7
# the scratch bytes the split records' rows may take before pieces grow
SCRATCH_BYTES = 1 << 26


def natural_dtype(dtype_max: int) -> torch.dtype:
    """The torch dtype of native.natural_count_dtype: the narrowest
    unsigned type holding the saturated counts."""
    from ..native import natural_count_dtype

    return {np.uint8: torch.uint8, np.uint16: torch.uint16,
            np.uint32: torch.uint32}[natural_count_dtype(dtype_max)]


def saturation(dtype_max: int) -> int:
    """The largest count written: min(dtype_max, the natural width's max)."""
    from ..native import natural_count_dtype

    return min(int(dtype_max), int(np.iinfo(natural_count_dtype(dtype_max)).max))


def _check(codes, offsets, segs, seg_offsets, k: int, dtype_max: int) -> int:
    for name, t, dtype in (("codes", codes, torch.int8), ("offsets", offsets, torch.int64),
                           ("segs", segs, torch.int64),
                           ("seg_offsets", seg_offsets, torch.int64)):
        if t.dtype != dtype:
            raise TypeError(f"kmer_count: {name} must be {dtype}, got {t.dtype}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"kmer_count: {name} must be 1-D and contiguous")
        if t.device != codes.device:
            raise ValueError(f"kmer_count: {name} is on {t.device}, codes on "
                             f"{codes.device}")
    if codes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"kmer_count: unsupported device {codes.device}")
    if len(offsets) < 1 or len(seg_offsets) != len(offsets):
        raise ValueError("kmer_count: offsets and seg_offsets must both be [n + 1]")
    if not 1 <= k <= 15:
        raise ValueError(f"kmer_count: k must be in 1..15, got {k}")
    if dtype_max < 1:
        raise ValueError(f"kmer_count: dtype_max must be >= 1, got {dtype_max}")
    return len(offsets) - 1


def _spans(start: torch.Tensor, length: torch.Tensor, owner: torch.Tensor):
    """The positions start[i] .. start[i] + length[i] - 1 of every span in
    order, and each one's owner."""
    before = torch.cumsum(length, 0) - length
    pos = torch.arange(int(length.sum()), dtype=torch.int64, device=start.device)
    pos += torch.repeat_interleave(start - before, length)
    return pos, torch.repeat_interleave(owner, length)


def kmer_windows(codes, offsets, segs, seg_offsets, k: int):
    """(flat index row 4^k + x of every counted window, each record's
    segment positions' flat 1-mer index row 4 + base) of the plain
    version: the inputs of its two bincounts."""
    n = len(offsets) - 1
    dev = codes.device
    g0, g1 = int(seg_offsets[0]), int(seg_offsets[-1])
    sg = segs[2 * g0:2 * g1].view(-1, 2)
    rec = torch.repeat_interleave(torch.arange(n, device=dev), torch.diff(seg_offsets))
    start = sg[:, 0] + offsets[:-1][rec]
    length = sg[:, 1] - sg[:, 0] + 1
    pos, prec = _spans(start, length, rec)
    one_idx = prec * 4 + codes[pos].to(torch.int64)
    wpos, wrec = _spans(start, (length - k + 1).clamp(min=0), rec)
    x = torch.zeros_like(wpos)
    for j in range(k):
        x = x * 4 + codes[wpos + j].to(torch.int64)
    return wrec * 4 ** k + x, one_idx


def kmer_count_ref(codes: torch.Tensor, offsets: torch.Tensor, segs: torch.Tensor,
                   seg_offsets: torch.Tensor, k: int, dtype_max: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch `kmer_count`: the windows' flat indices by a Horner
    sweep, two bincounts, the pseudocount and the saturation."""
    n = _check(codes, offsets, segs, seg_offsets, k, dtype_max)
    d = 4 ** k
    flat, one_idx = kmer_windows(codes, offsets, segs, seg_offsets, k)
    hist = torch.bincount(flat, minlength=n * d).view(n, d)
    counts = torch.clamp(hist + 1, max=saturation(dtype_max)).to(natural_dtype(dtype_max))
    ones = torch.bincount(one_idx, minlength=4 * n).view(n, 4) + 1
    return counts, ones


def launch_plan(n_codes: int, k: int) -> Tuple[int, int]:
    """(piece, rows) of a launch over n_codes codes: the positions of one
    work item (PIECE at least, larger where the split records' scratch
    rows, n_codes // piece + 1 of 4 (4^k + 10) bytes, would pass
    SCRATCH_BYTES; at most MAX_SHARED_PIECE for k <= SHARED_K, whose
    counters are 16-bit) and the scratch rows (0 when no record can be
    split: piece > n_codes)."""
    row_bytes = 4 * (4 ** k + 10)
    piece = max(PIECE, -(-n_codes * row_bytes // SCRATCH_BYTES))
    if k <= SHARED_K:
        piece = min(piece, MAX_SHARED_PIECE)
    elif SCRATCH_BYTES < row_bytes:
        piece = n_codes + 1
    return piece, (0 if piece > n_codes else n_codes // piece + 1)


# the split records' scratch of each device: uint64 1-mer sums, uint32
# counts and int32 arrival counters, zero between launches (the kernel
# zeroes what it used), grown as needed; one stream at a time
_SCRATCH = {}


def _scratch(device: torch.device, rows: int, d: int):
    """(acc_ones [rows, 4] uint64 as int64, acc [rows, d] uint32 as int32,
    arrive [rows] int32), views of the device's zeroed scratch."""
    need = rows * (32 + 4 * d + 4)
    buf = _SCRATCH.get(device)
    if buf is None or buf.numel() < need:
        buf = _SCRATCH[device] = torch.zeros(need, dtype=torch.uint8, device=device)
    acc_ones = buf[:32 * rows].view(torch.int64).view(rows, 4)
    acc = buf[32 * rows:(32 + 4 * d) * rows].view(torch.int32).view(rows, d)
    arrive = buf[(32 + 4 * d) * rows:need].view(torch.int32)
    return acc_ones, acc, arrive


def _lib():
    from ._build import load

    lib = load("kmer_count").lib
    if lib.mc2_kmer_count.argtypes is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.mc2_kmer_count.argtypes = [p, i64, p, p, p, i64, i64, ctypes.c_int,
                                       ctypes.c_uint64, ctypes.c_int, p, p, p, p, p, p]
        lib.mc2_kmer_count.restype = ctypes.c_int
    return lib


def kmer_count(codes: torch.Tensor, offsets: torch.Tensor, segs: torch.Tensor,
               seg_offsets: torch.Tensor, k: int, dtype_max: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Records in the native packing -> (counts [n, 4^k] at the natural
    width (uint8/uint16/uint32): min(1 + the window count, saturation),
    ones int64 [n, 4]: 1 + the base counts).

    On CUDA one launch on the current stream, without syncing: a warp a
    piece of `launch_plan`'s length, records longer than a piece through
    the device's zeroed scratch (`_scratch`, one stream at a time).  The
    segments must lie inside their records."""
    n = _check(codes, offsets, segs, seg_offsets, k, dtype_max)
    if codes.device.type == "cpu":
        return kmer_count_ref(codes, offsets, segs, seg_offsets, k, dtype_max)
    dev = codes.device
    d = 4 ** k
    counts = torch.empty((n, d), dtype=natural_dtype(dtype_max), device=dev)
    ones = torch.empty((n, 4), dtype=torch.int64, device=dev)
    if n == 0:
        return counts, ones
    piece, rows = launch_plan(codes.numel(), k)
    with torch.cuda.device(dev):
        scratch = [t.data_ptr() for t in _scratch(dev, rows, d)] if rows else [None] * 3
        rc = _lib().mc2_kmer_count(
            codes.data_ptr(), codes.numel(), offsets.data_ptr(), segs.data_ptr(),
            seg_offsets.data_ptr(), n, piece, int(k), saturation(dtype_max),
            counts.element_size(), counts.data_ptr(), ones.data_ptr(), *scratch,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"kmer_count kernel launch failed: cudaError {rc}")
    kmer_count.launches += 1
    if k > SHARED_K:
        kmer_count.global_launches += 1
    return counts, ones


kmer_count.launches = 0  # kernel launches since the last reset
kmer_count.global_launches = 0  # of them, the global instantiation's (k > SHARED_K)


def packed_on(packing, device, lo: int = 0, hi: int = None):
    """Records lo..hi of a native packing (codes, offsets, segs,
    seg_offsets as numpy) as tensors on `device`, rebased to the chunk: one
    int8 and one int64 host-to-device copy."""
    codes, offsets, segs, seg_offsets = packing
    hi = len(offsets) - 1 if hi is None else hi
    c0, c1 = int(offsets[lo]), int(offsets[hi])
    g0, g1 = int(seg_offsets[lo]), int(seg_offsets[hi])
    n = hi - lo
    idx = np.concatenate([offsets[lo:hi + 1] - c0, seg_offsets[lo:hi + 1] - g0,
                          segs[2 * g0:2 * g1]]).astype(np.int64)
    code_t = torch.from_numpy(np.ascontiguousarray(codes[c0:max(c1, c0 + 1)])).to(device)
    idx_t = torch.from_numpy(idx).to(device)
    off, seg_off, sg = torch.split(idx_t, [n + 1, n + 1, 2 * (g1 - g0)])
    return code_t, off, sg, seg_off
