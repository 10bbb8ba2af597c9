"""Segmented closest-to-mean: per segment, the kept row nearest the mean of
the segment's kept rows.

The port of meshclust2_tpu/cluster/device_update.py:DeviceUpdater._closest_core
(lines 290-364), an XLA program on the TPU.  On a CUDA tensor
`closest_mean` launches the hand-written kernel in csrc/closest_mean.cu
(one block per segment); on a CPU tensor it runs `closest_mean_ref`, the
plain PyTorch version, which the CPU tests hold against the JAX program
and the host `distance_d`.

For segment c (the positions p with seg[p] == c and keep[p]):
    first[c] = position p of the first minimum of distance_d(counts[rows[p]],
               mean), or P when the segment keeps no row;
    unc[c]   = True when the host's float64 mean could round differently in
               some bin, or when a row other than an exact copy of the
               first's integers lies within `tie_margin` of the minimum.
Where unc[c] is False, first[c] is the host engine's argmin
(cluster/engine.py:distance_d, first strict minimum).

`closest_mean_ref` also has a one-segment mode (the accumulate loop's
closest-to-mean, the port of device_loop.py:_build_program.closest_to_mean
/ _mc_heavy, lines 1223-1355): with `col_sum` (int64 [D], the kept rows'
column sums) and `count` (int64 [1], their number) given, C is 1 and `seg`
is not read (it may be None).  The plain accumulate step
(ops/window_absorb.py:window_step_ref) uses it; on the card the step kernel
computes the same inside its one launch.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

# rows of the plain version's int64 temporaries per step (bounds its memory
# at 16384 x D x 8 bytes per temporary)
_REF_CHUNK = 16384

_ENTRY = {torch.uint8: "mc2_closest_mean_u8", torch.uint16: "mc2_closest_mean_u16"}


def _lib():
    from ._build import load

    lib = load("closest_mean").lib
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = [p, ctypes.c_int, p, p, p, p, i64, i64, i64,
                           ctypes.c_double, p, i64, p, p, p]
            fn.restype = ctypes.c_int
    return lib


def _check(counts, mags, rows, seg, keep, n_segs: int, col_sum, count):
    one = col_sum is not None or count is not None
    if one:
        if col_sum is None or count is None:
            raise ValueError("col_sum and count go together")
        if n_segs != 1:
            raise ValueError(f"the one-segment mode takes C = 1, got {n_segs}")
        if col_sum.dtype != torch.int64 or tuple(col_sum.shape) != counts.shape[1:]:
            raise ValueError(f"col_sum must be int64 [{counts.shape[1]}], got "
                             f"{col_sum.dtype} {tuple(col_sum.shape)}")
        if count.dtype != torch.int64 or count.numel() != 1:
            raise ValueError(f"count must be one int64, got {count.dtype} "
                             f"{tuple(count.shape)}")
    elif seg is None:
        raise ValueError("seg is required without col_sum")
    if counts.dtype not in _ENTRY:
        raise TypeError(f"counts must be uint8 or uint16, got {counts.dtype}")
    if counts.dim() != 2:
        raise ValueError(f"counts must be [N, D], got shape {tuple(counts.shape)}")
    if mags.dtype != torch.float64 or mags.shape != counts.shape[:1]:
        raise ValueError(f"mags must be float64 [{counts.shape[0]}], got "
                         f"{mags.dtype} {tuple(mags.shape)}")
    vectors = (("rows", rows, torch.int64), ("keep", keep, torch.bool))
    if seg is not None:
        vectors += (("seg", seg, torch.int64),)
    for name, t, dtype in vectors:
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.shape != rows.shape or t.dim() != 1:
            raise ValueError(f"{name} must be [P] like rows, got {tuple(t.shape)}")
    extra = (("col_sum", col_sum), ("count", count)) if one else ()
    for name, t in (("counts", counts), ("mags", mags)) + tuple(
            (name, t) for name, t, _ in vectors) + extra:
        if t.device != counts.device:
            raise ValueError(f"{name} is on {t.device}, counts on {counts.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if n_segs < 0:
        raise ValueError(f"C must be >= 0, got {n_segs}")
    if counts.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {counts.device}")


def closest_mean_ref(counts: torch.Tensor, mags: torch.Tensor,
                     rows: torch.Tensor, seg: Optional[torch.Tensor],
                     keep: torch.Tensor, n_segs: int, *, maxc: int,
                     tie_margin: float, col_sum: Optional[torch.Tensor] = None,
                     count: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch closest-to-mean: int64 segment sums by `index_add_`
    (or the given col_sum and count), the same integer guards as the
    kernel, float64 v."""
    _check(counts, mags, rows, seg, keep, n_segs, col_sum, count)
    n_pairs, d = len(rows), counts.shape[1]
    dev = counts.device
    i64 = dict(dtype=torch.int64, device=dev)
    # CUDA has no uint16 gather: gather the same bits as int16 and mask
    src, mask = ((counts.view(torch.int16), 0xFFFF)
                 if counts.dtype == torch.uint16 else (counts, 0xFF))
    if col_sum is not None:
        seg = torch.zeros(n_pairs, **i64)
        cnt = count.reshape(1)
        num = col_sum.reshape(1, d)
    else:
        kept = keep.to(torch.int64)
        cnt = torch.zeros(n_segs, **i64).index_add_(0, seg, kept)
        num = torch.zeros((n_segs, d), **i64)
        for s in range(0, n_pairs, _REF_CHUNK):
            h = (src[rows[s:s + _REF_CHUNK]].to(torch.int64) & mask) \
                * kept[s:s + _REF_CHUNK, None]
            num.index_add_(0, seg[s:s + _REF_CHUNK], h)
    den = cnt.clamp(min=1)[:, None]
    q = torch.div(num, den, rounding_mode="floor")
    rem = num - q * den
    r = torch.div(2 * num + den, 2 * den, rounding_mode="floor")
    s_floor = q.sum(dim=1)
    # float64 rounding corners of the host's mean (device_update.py:319-331)
    half = (2 * rem - den).abs()
    g1 = (half != 0) & (half <= ((q + 2) * den) >> 51)
    g2 = (rem != 0) & (rem <= ((q + 2) * den) >> 52)
    g3 = (rem != 0) & ((den - rem) <= ((q + maxc + 2) * den) >> 52)
    seg_unc = (g1 | g2 | g3).any(dim=1)

    dist2 = torch.empty(n_pairs, **i64)
    for s in range(0, n_pairs, _REF_CHUNK):
        h = src[rows[s:s + _REF_CHUNK]].to(torch.int64) & mask
        dist2[s:s + len(h)] = 2 * torch.minimum(h, r[seg[s:s + _REF_CHUNK]]).sum(dim=1)
    mag = mags[rows].to(torch.int64) + s_floor[seg]
    frac = dist2.to(torch.float64) / mag.to(torch.float64)
    v = torch.where(keep, 10000.0 * (1.0 - frac * frac),
                    torch.full_like(frac, float("inf")))
    vmin = torch.full((n_segs,), float("inf"), dtype=torch.float64, device=dev)
    vmin = vmin.scatter_reduce(0, seg, v, "amin")
    pos = torch.arange(n_pairs, **i64)
    cand = keep & (v == vmin[seg])
    first = torch.full((n_segs,), n_pairs, **i64).scatter_reduce(
        0, seg, torch.where(cand, pos, n_pairs), "amin")
    # tie guard (device_update.py:354-363): near the minimum, not an exact
    # copy of the first row's integers
    f = first.clamp(max=max(n_pairs - 1, 0))[seg]
    same = (dist2 == dist2[f]) & (mag == mag[f])
    near = keep & ((v - vmin[seg]).abs()
                   <= tie_margin * vmin[seg].abs().clamp(min=1.0))
    tie = torch.zeros(n_segs, **i64).scatter_reduce(
        0, seg, (near & ~same).to(torch.int64), "amax") > 0
    return first, seg_unc | tie


def closest_mean(counts: torch.Tensor, mags: torch.Tensor, rows: torch.Tensor,
                 seg: torch.Tensor, keep: torch.Tensor, n_segs: int,
                 *, maxc: int, tie_margin: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N, D] uint8/uint16 store, float64 [N] mags (exact integers), int64
    [P] rows and nondecreasing segment ids in [0, C), bool [P] keep ->
    (first int64 [C], unc bool [C]).  `maxc` is the store's largest count.

    On CUDA the rows must lie in [0, N) and the mags below 2^24 (the
    store's envelope); one launch on the current stream, without syncing,
    into a scratch from PyTorch's caching allocator."""
    _check(counts, mags, rows, seg, keep, n_segs, None, None)
    if counts.device.type == "cpu":
        return closest_mean_ref(counts, mags, rows, seg, keep, n_segs,
                                maxc=maxc, tie_margin=tie_margin)
    dev = counts.device
    n_pairs, d = len(rows), counts.shape[1]
    first = torch.empty(n_segs, dtype=torch.int64, device=dev)
    unc = torch.empty(n_segs, dtype=torch.bool, device=dev)
    if n_segs == 0:
        return first, unc
    lib = _lib()
    # v, dist2 and mag per position
    scratch = torch.empty(3 * n_pairs, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = getattr(lib, _ENTRY[counts.dtype])(
            counts.data_ptr(), d, mags.data_ptr(), rows.data_ptr(),
            seg.data_ptr(), keep.data_ptr(), n_pairs, n_segs, int(maxc),
            float(tie_margin), scratch.data_ptr(), scratch.numel(),
            first.data_ptr(), unc.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"closest_mean kernel launch failed: cudaError {rc}")
    closest_mean.launches += 1
    return first, unc


closest_mean.launches = 0  # kernel launches since the last reset


# -- the block modes' shared parts ---------------------------------------------
#
# The step kernel and closest_candidates each have a block mode for a rank of
# a row-sharded store (csrc/window_absorb.cu, csrc/closest_mean.cu,
# parallel/multihost_session.py): each rank sums its own kept rows, the sums
# are all-reduced, each rank finds its first minimum over its own rows and
# the facts the tie guard needs (a partial, PART int64 values a segment), the
# partials are all-gathered, and every rank picks the same first minimum.


class RowBlock(NamedTuple):
    """A rank's rows of a row-sharded store: `counts` (uint8/uint16 [>= hi -
    lo, D]) holds store rows [lo, hi) at row - lo; the moments (float64
    [N]) are every store row's; maxc is the whole store's largest count."""
    counts: torch.Tensor
    mags: torch.Tensor
    selfdot: torch.Tensor
    lens: torch.Tensor
    stddevs: torch.Tensor
    maxc: int
    lo: int
    hi: int


# int64 values of a partial: the rank's first minimum's v (bits) and
# position (`none` for none), that row's dist2 and mag (-1 for none), the
# smallest v (bits) of its kept rows whose (dist2, mag) differ from the
# first's (+inf for none), and the mean's guard
PART = 6


def _rows_i64(counts: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """counts[idx] as int64 (CUDA has no uint16 gather: the same bits as
    int16, masked)."""
    src, mask = ((counts.view(torch.int16), 0xFFFF)
                 if counts.dtype == torch.uint16 else (counts, 0xFF))
    return src[idx].to(torch.int64) & mask


def block_sums_ref(blk: RowBlock, rows: torch.Tensor, seg: torch.Tensor,
                   keep: torch.Tensor, n_segs: int) -> torch.Tensor:
    """int64 [C, D]: per segment the column sums of the kept rows that the
    block holds (rows global, seg in [0, C))."""
    own = keep & (rows >= blk.lo) & (rows < blk.hi)
    idx = torch.nonzero(own).view(-1)
    num = torch.zeros((n_segs, blk.counts.shape[1]), dtype=torch.int64,
                      device=blk.counts.device)
    for s in range(0, len(idx), _REF_CHUNK):
        i = idx[s:s + _REF_CHUNK]
        num.index_add_(0, seg[i], _rows_i64(blk.counts, rows[i] - blk.lo))
    return num


def block_partials_ref(blk: RowBlock, rows: torch.Tensor, seg: torch.Tensor,
                       keep: torch.Tensor, n_segs: int, num: torch.Tensor,
                       cnt: torch.Tensor) -> torch.Tensor:
    """int64 [C, PART]: each segment's partial over the kept rows that the
    block holds, with the mean from the segment's whole column sums `num`
    ([C, D]) and kept count `cnt` ([C]); positions index rows (P for none)."""
    dev = blk.counts.device
    n_pairs = len(rows)
    i64 = dict(dtype=torch.int64, device=dev)
    den = cnt.clamp(min=1)[:, None]
    q = torch.div(num, den, rounding_mode="floor")
    rem = num - q * den
    r = torch.div(2 * num + den, 2 * den, rounding_mode="floor")
    s_floor = q.sum(dim=1)
    half = (2 * rem - den).abs()
    g1 = (half != 0) & (half <= ((q + 2) * den) >> 51)
    g2 = (rem != 0) & (rem <= ((q + 2) * den) >> 52)
    g3 = (rem != 0) & ((den - rem) <= ((q + blk.maxc + 2) * den) >> 52)
    guard = (g1 | g2 | g3).any(dim=1)

    own = keep & (rows >= blk.lo) & (rows < blk.hi)
    idx = torch.nonzero(own).view(-1)
    sg = seg[idx]
    dist2 = torch.empty(len(idx), **i64)
    for s in range(0, len(idx), _REF_CHUNK):
        i = idx[s:s + _REF_CHUNK]
        h = _rows_i64(blk.counts, rows[i] - blk.lo)
        dist2[s:s + len(i)] = 2 * torch.minimum(h, r[seg[i]]).sum(dim=1)
    mag = blk.mags[rows[idx]].to(torch.int64) + s_floor[sg]
    frac = dist2.to(torch.float64) / mag.to(torch.float64)
    v = 10000.0 * (1.0 - frac * frac)
    inf = float("inf")
    # the kernel's first strict minimum: NaN and +inf never become one
    vv = torch.where(torch.isnan(v), inf, v)
    vmin = torch.full((n_segs,), inf, dtype=torch.float64, device=dev)
    vmin = vmin.scatter_reduce(0, sg, vv, "amin")
    hit = (vv == vmin[sg]) & (vmin[sg] < inf)
    first = torch.full((n_segs,), n_pairs, **i64).scatter_reduce(
        0, sg, torch.where(hit, idx, n_pairs), "amin")
    # the first's integers: scatter by position, read at the first
    d2_at = torch.full((n_pairs + 1,), -1, **i64)
    mag_at = torch.full((n_pairs + 1,), -1, **i64)
    d2_at[idx] = dist2
    mag_at[idx] = mag
    fd2, fmg = d2_at[first], mag_at[first]
    differ = (dist2 != fd2[sg]) | (mag != fmg[sg])
    sv = torch.full((n_segs,), inf, dtype=torch.float64, device=dev)
    sv = sv.scatter_reduce(0, sg, torch.where(differ, vv, inf), "amin")
    vmin_bits = torch.where(first < n_pairs, vmin, inf).view(torch.int64)
    return torch.stack([vmin_bits, first, fd2, fmg, sv.view(torch.int64),
                        guard.to(torch.int64)], dim=1)


def pick_ref(parts: torch.Tensor, none: int, tie_margin: float
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(first int64 [C], unc bool [C]) from every rank's partials (int64
    [G, C, PART]): the first minimum over the ranks (the smallest v, then
    position; `none` for none), and unc = some rank's guard, or a kept row
    within tie_margin of the minimum whose (dist2, mag) differ from the
    first's.  That row exists exactly when the smallest v of such rows lies
    within tie_margin: per rank, its first's v where its first's integers
    differ from the global first's, its own smallest differing v
    otherwise."""
    v = parts[..., 0].view(torch.float64)
    pos, d2, mg = parts[..., 1], parts[..., 2], parts[..., 3]
    mv = v.min(dim=0).values
    first = torch.where(v == mv, pos, none).min(dim=0).values
    sel = (pos == first) & (first < none)
    fd2 = (d2 * sel).sum(dim=0)
    fmg = (mg * sel).sum(dim=0)
    differs = (pos < none) & ((d2 != fd2) | (mg != fmg))
    t = torch.where(differs, v, parts[..., 4].view(torch.float64)).min(dim=0).values
    thr = tie_margin * mv.abs().clamp(min=1.0)
    tie = (first < none) & ((t - mv).abs() <= thr)
    return first, (parts[..., 5] != 0).any(dim=0) | tie

