"""The update phase's per-iteration layout and merge replay on the card.

The port of meshclust2_tpu/cluster/device_phase.py:DevicePhaseUpdater's
row targeting (`ranks`, the per-offset targets of `filter_mean`, `closest`
and `merge_pass.q_body`, l. 218-226, 261-282, 326-352, 462-470) and its
absorb replay (`rp_body`, l. 519-547), XLA programs on the TPU.  On CUDA
tensors the wrappers launch the hand-written kernels of csrc/phase.cu; on
CPU tensors they run the plain PyTorch versions beside them
(`phase_layout_ref`, `phase_candidates_ref`, `merge_replay_ref`), which
the CPU tests hold against the JAX program and the host engine.  The
layout and the replay keep a state's slots in each block's shared memory
up to `smem_slots` of them; a larger state launches their wide
instantiations, counted also in `.wide_launches`.  The iteration's
closest-to-mean and its candidates step (the kept-empty rule, l. 551-555
and 611-622, and `merge_pass.q_body`, l. 462-517) are one launch,
`closest_candidates`, of csrc/closest_mean.cu's phase instantiation
(plain version `closest_candidates_ref`: closest_mean_ref, then
`phase_candidates_ref`).

The phase's state (`PhaseState`): per row its cluster slot and its position
in that cluster's member list, per slot its center row, alive flag and
member count.  Per iteration:
  - `phase_layout`: the alive ranks, the flat member table and every
    (center, member) pair of each center's +/-delta neighbourhood, cut by
    the length window, in the host engine's gather order (`Layout`;
    hdr = (C, P) on the card);
  - after the filter's decisions, `closest_candidates`: each center's
    closest-to-mean, then the new centers and the merge pass's candidate
    pairs at their bound delta C, `ok` their length cut;
  - after the merge decisions, `merge_replay`: the absorb events applied
    in ascending slot order (cluster/engine.py `_merge_pass`).

`closest_candidates_block` is closest_candidates on a rank of a row-sharded
store (the kernel's block mode, parallel/multihost_session.py): three
launches with the collectives between them (phase 1, the exchange from the
filter's bits of the rank's own pairs: the keep and uncertainty bits and the
column sums of its own kept rows, int32 where a segment's sums fit; the host
all-reduces it; phase 2, the rank's partial of each segment's
closest-to-mean; the host all-gathers them; phase 3, the pick and the
candidates step), the layout and the state every rank's alike.
`closest_candidates_blocks` runs G blocks in one process, the exchange
summed and the partials stacked as the collectives do it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from .closest_mean import _check as _check_closest
from .closest_mean import (PART, RowBlock, block_partials_ref, block_sums_ref,
                           closest_mean_ref, pick_ref)


class PhaseState(NamedTuple):
    assign: torch.Tensor   # int64 [n]: each row's cluster slot
    seq: torch.Tensor      # int64 [n]: its position in the member list
    cen: torch.Tensor      # int64 [S]: each slot's center row
    alive: torch.Tensor    # bool [S]
    clen: torch.Tensor     # int64 [S]: each slot's member count


class PhaseRows(NamedTuple):
    """Per row of the pool: its length and the truncated bounds
    trunc(L sim) and trunc(L / sim) of the length window it opens as a
    center (cluster/engine.py's uint64 truncations of float64)."""
    lens: torch.Tensor     # int64 [n]
    blen: torch.Tensor     # int64 [n]
    elen: torch.Tensor     # int64 [n]


class Layout(NamedTuple):
    rank: torch.Tensor     # int64 [S]: alive slots below each slot
    inv: torch.Tensor      # int64 [S]: the slot of each rank < C
    moff: torch.Tensor     # int64 [S + 1]: member offsets by rank, moff[C] = n
    flat: torch.Tensor     # int64 [n]: the members, by rank then position
    a_rows: torch.Tensor   # int64 [(2 delta + 1) n]: each pair's center row
    b_rows: torch.Tensor   # its member row
    seg: torch.Tensor      # its center's rank, nondecreasing
    hdr: torch.Tensor      # int64 [2]: C, P (pairs in [0, P))
    scratch: torch.Tensor  # int64 [S + 1 + layout_tiles(n, delta)]


class Candidates(NamedTuple):
    cen: torch.Tensor      # int64 [S]: the new centers
    a: torch.Tensor        # int64 [delta S]: candidate (rank i + q)'s center
    b: torch.Tensor        # rank i's center
    seg: torch.Tensor      # i
    ok: torch.Tensor       # bool: i + q < C and inside i's length window
    arrive: torch.Tensor   # int32 [delta S]: the kernel's arrival counters, 0


# pair positions in the smallest tile of the layout's sweep (csrc/phase.cu
# kTile; 4 TILE where those tiles outnumber the blocks that fit)
TILE = 1024


def layout_tiles(n: int, delta: int) -> int:
    """The most tiles of the layout's sweep: its (2 delta + 1) n positions
    at most, TILE a tile (a look-back descriptor each in the scratch)."""
    return -(-(2 * delta + 1) * n // TILE)


def new_state(n: int, n_slots: int, device) -> PhaseState:
    i64 = dict(dtype=torch.int64, device=device)
    return PhaseState(torch.empty(n, **i64), torch.empty(n, **i64),
                      torch.empty(n_slots, **i64),
                      torch.empty(n_slots, dtype=torch.bool, device=device),
                      torch.empty(n_slots, **i64))


def new_layout(n: int, n_slots: int, delta: int, device) -> Layout:
    i64 = dict(dtype=torch.int64, device=device)
    bound = (2 * delta + 1) * n
    pairs = torch.empty(3 * bound, **i64)
    return Layout(torch.empty(n_slots, **i64), torch.empty(n_slots, **i64),
                  torch.empty(n_slots + 1, **i64), torch.empty(n, **i64),
                  *torch.split(pairs, bound), torch.zeros(2, **i64),
                  torch.empty(n_slots + 1 + layout_tiles(n, delta), **i64))


def new_candidates(n_slots: int, delta: int, device) -> Candidates:
    i64 = dict(dtype=torch.int64, device=device)
    m = delta * n_slots
    return Candidates(torch.empty(n_slots, **i64), *torch.empty((3, m), **i64).unbind(0),
                      torch.empty(m, dtype=torch.bool, device=device),
                      torch.zeros(m, dtype=torch.int32, device=device))


def _lib():
    from ._build import load

    lib = load("phase").lib
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    sigs = {"mc2_phase_layout": ([i64, i64, i32] + [p] * 16 + [i64, p, p], ctypes.c_int),
            "mc2_merge_replay": ([i64, i64] + [p] * 10 + [i64, p], ctypes.c_int),
            "mc2_phase_smem_slots": ([i32], i64)}
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = restype
    return lib


@functools.cache
def _smem_slots(kernel: int, index: int) -> int:
    with torch.cuda.device(index):
        got = _lib().mc2_phase_smem_slots(kernel)
    if got < 0:
        raise RuntimeError("phase kernels: the card's shared-memory limit is unreadable")
    return got


def smem_slots(kernel: str, device) -> int:
    """The most slots that `kernel` ("phase_layout" or "merge_replay") keeps
    in a block's shared memory on the CUDA `device`; a state with more
    launches its wide instantiation."""
    dev = torch.device(device)
    return _smem_slots(("phase_layout", "merge_replay").index(kernel),
                       dev.index if dev.index is not None else torch.cuda.current_device())


def _check(what: str, tensors, device) -> None:
    for name, t, dtype, numel in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} must be {dtype}, got {t.dtype}")
        if t.numel() < numel or t.dim() != 1:
            raise ValueError(f"{what}: {name} must be 1-D with >= {numel} "
                             f"elements, got {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, not {device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {device}")


def _check_state(what: str, st: PhaseState, rows: PhaseRows):
    n, n_slots = len(st.assign), len(st.cen)
    i64, dev = torch.int64, st.assign.device
    _check(what, [("assign", st.assign, i64, n), ("seq", st.seq, i64, n),
                  ("cen", st.cen, i64, n_slots),
                  ("alive", st.alive, torch.bool, n_slots),
                  ("clen", st.clen, i64, n_slots),
                  ("lens", rows.lens, i64, n), ("blen", rows.blen, i64, n),
                  ("elen", rows.elen, i64, n)], dev)
    return n, n_slots, dev


def _ptrs(*ts):
    return [t.data_ptr() for t in ts]


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


# -- the layout ---------------------------------------------------------------


def phase_layout_ref(st: PhaseState, rows: PhaseRows, delta: int,
                     lay: Layout) -> None:
    """Plain PyTorch `phase_layout`: ranks by cumsum, the member table by a
    scatter, the neighbourhood pairs by repeat_interleave, the length cut
    by a mask."""
    n, n_slots, dev = _check_state("phase_layout_ref", st, rows)
    i64 = dict(dtype=torch.int64, device=dev)
    if n == 0 or n_slots == 0:
        lay.hdr.zero_()
        return
    alive = st.alive.to(torch.int64)
    crank = torch.cumsum(alive, 0)
    lay.rank.copy_(crank - alive)
    n_alive = int(crank[-1])
    slots = torch.nonzero(st.alive).view(-1)
    lay.inv[:n_alive] = slots
    lay.moff[0] = 0
    torch.cumsum(st.clen[slots], 0, out=lay.moff[1:n_alive + 1])
    lay.flat[lay.moff[lay.rank[st.assign]] + st.seq] = torch.arange(n, **i64)
    js = torch.arange(n_alive, **i64)
    starts = lay.moff[(js - delta).clamp(min=0)]
    ends = lay.moff[(js + delta).clamp(max=n_alive - 1) + 1]
    per = ends - starts
    seg = torch.repeat_interleave(js, per)
    pos = torch.arange(len(seg), **i64) + torch.repeat_interleave(
        starts - (torch.cumsum(per, 0) - per), per)
    b = lay.flat[pos]
    c = st.cen[lay.inv[seg]]
    ok = (rows.lens[b] >= rows.blen[c]) & (rows.lens[b] <= rows.elen[c])
    n_pairs = int(ok.sum())
    lay.a_rows[:n_pairs] = c[ok]
    lay.b_rows[:n_pairs] = b[ok]
    lay.seg[:n_pairs] = seg[ok]
    lay.hdr.copy_(torch.tensor([n_alive, n_pairs], **i64))


def _check_layout(what, lay: Layout, n: int, n_slots: int, delta: int, dev):
    bound = (2 * delta + 1) * n
    i64 = torch.int64
    _check(what, [("rank", lay.rank, i64, n_slots), ("inv", lay.inv, i64, n_slots),
                  ("moff", lay.moff, i64, n_slots + 1), ("flat", lay.flat, i64, n),
                  ("a_rows", lay.a_rows, i64, bound),
                  ("b_rows", lay.b_rows, i64, bound), ("seg", lay.seg, i64, bound),
                  ("hdr", lay.hdr, i64, 2),
                  ("scratch", lay.scratch, i64, n_slots + 1 + layout_tiles(n, delta))],
           dev)


def phase_layout(st: PhaseState, rows: PhaseRows, delta: int, lay: Layout) -> None:
    """The iteration's layout of state `st` into `lay` (its arrays sized by
    new_layout for at least n rows, S slots and this delta): ranks, the slot
    of each rank, member offsets, the flat member table and the P
    neighbourhood pairs, hdr = (C, P).  Every row must belong to an alive
    slot at its position (0 <= seq < clen).

    On CUDA one cooperative launch on the current stream, without syncing
    (the wide instantiation above smem_slots("phase_layout") slots); the
    host learns (C, P) by reading hdr.  The kernel takes (2 delta + 1) n <
    2^31."""
    n, n_slots, dev = _check_state("phase_layout", st, rows)
    if delta < 0:
        raise ValueError(f"phase_layout: delta must be >= 0, got {delta}")
    _check_layout("phase_layout", lay, n, n_slots, delta, dev)
    if dev.type == "cpu":
        return phase_layout_ref(st, rows, delta, lay)
    if n == 0 or n_slots == 0:
        lay.hdr.zero_()
        return None
    if (2 * delta + 1) * n >= 2 ** 31:
        raise ValueError(f"phase_layout: (2 delta + 1) n = {(2 * delta + 1) * n} "
                         f"is past the kernel's int32 positions")
    with torch.cuda.device(dev):
        rc = _lib().mc2_phase_layout(
            n, n_slots, int(delta),
            *_ptrs(st.assign, st.seq, st.alive, st.cen, st.clen, rows.lens,
                   rows.blen, rows.elen, lay.rank, lay.inv, lay.moff, lay.flat,
                   lay.a_rows, lay.b_rows, lay.seg, lay.scratch),
            lay.scratch.numel(), lay.hdr.data_ptr(), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"phase_layout kernel launch failed: cudaError {rc}")
    phase_layout.launches += 1
    if n_slots > smem_slots("phase_layout", dev):
        phase_layout.wide_launches += 1
    return None


phase_layout.launches = 0  # kernel launches since the last reset
phase_layout.wide_launches = 0  # of them, the wide instantiation's


# -- the candidates -----------------------------------------------------------


def phase_candidates_ref(st: PhaseState, rows: PhaseRows, delta: int,
                         lay: Layout, first: torch.Tensor, n_alive: int,
                         n_pairs: int, out: Candidates,
                         final: bool = False) -> None:
    """The candidates step after closest-to-mean over `lay`'s P = n_pairs
    pairs (first int64 [C], C = n_alive: a pair position, P for none): the
    new center of every alive slot into out.cen (others copied), and the
    merge candidates (a, b, seg, ok) at positions [0, delta C): a = the new
    center of rank i + q, b = rank i's, seg = i, for q = 1..delta.
    `final`: the delta = 0 pass's kept-empty rule (the cluster's first
    member).  Plain PyTorch, the second half of closest_candidates_ref."""
    dev = st.cen.device
    i64 = dict(dtype=torch.int64, device=dev)
    ks = torch.arange(n_alive, **i64)
    f = first[:n_alive]
    kept = f < n_pairs
    fallback = lay.flat[lay.moff[ks]] if final else st.cen[lay.inv[ks]]
    cen_k = torch.where(kept, lay.b_rows[f.clamp(max=max(n_pairs - 1, 0))], fallback)
    out.cen.copy_(st.cen)
    out.cen[lay.inv[:n_alive]] = cen_k
    m = delta * n_alive
    x = torch.arange(m, **i64)
    i = torch.div(x, max(delta, 1), rounding_mode="floor")
    j = i + x % max(delta, 1) + 1
    ok = j < n_alive
    ci = cen_k[i]
    cj = torch.where(ok, cen_k[j.clamp(max=max(n_alive - 1, 0))], ci)
    ok &= (rows.lens[cj] >= rows.blen[ci]) & (rows.lens[cj] <= rows.elen[ci])
    out.a[:m] = cj
    out.b[:m] = ci
    out.seg[:m] = i
    out.ok[:m] = ok


def _closest_lib():
    from ._build import load

    lib = load("closest_mean").lib
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    cand = [p, i32, p, p, p, p, i64, i64, i64, ctypes.c_double, p, i64, p, p, i64, i32,
            i32] + [p] * 14
    for names, extra in ((_CAND_ENTRY, []),
                         (_CAND_BLOCK_ENTRY, [i64, i64, i32, p, p, i32, p, i32, p, p, p])):
        for name in names.values():
            fn = getattr(lib, name)
            if fn.argtypes is None:
                fn.argtypes = cand + extra + [p]
                fn.restype = ctypes.c_int
    return lib


_CAND_ENTRY = {torch.uint8: "mc2_closest_candidates_u8",
               torch.uint16: "mc2_closest_candidates_u16"}
_CAND_BLOCK_ENTRY = {torch.uint8: "mc2_closest_candidates_block_u8",
                     torch.uint16: "mc2_closest_candidates_block_u16"}


def closest_candidates_ref(counts: torch.Tensor, mags: torch.Tensor,
                           keep: torch.Tensor, st: PhaseState, rows: PhaseRows,
                           delta: int, lay: Layout, n_alive: int, n_pairs: int,
                           out: Candidates, *, maxc: int, tie_margin: float,
                           final: bool = False):
    """Plain PyTorch `closest_candidates`: closest_mean_ref over the
    layout's pairs, then phase_candidates_ref."""
    first, unc = closest_mean_ref(counts, mags, lay.b_rows[:n_pairs],
                                  lay.seg[:n_pairs], keep, n_alive, maxc=maxc,
                                  tie_margin=tie_margin)
    phase_candidates_ref(st, rows, delta, lay, first, n_alive, n_pairs, out, final)
    return first, unc


def closest_candidates(counts: torch.Tensor, mags: torch.Tensor,
                       keep: torch.Tensor, st: PhaseState, rows: PhaseRows,
                       delta: int, lay: Layout, n_alive: int, n_pairs: int,
                       out: Candidates, *, maxc: int, tie_margin: float,
                       final: bool = False):
    """An iteration's closest-to-mean and candidates step over `lay`'s
    P = n_pairs pairs (C = n_alive centers) with the filter's `keep` [P]:
    (first int64 [C], unc bool [C]) as closest_mean gives them over the
    store (counts, mags, maxc) with rows = lay.b_rows[:P] and seg =
    lay.seg[:P], and into `out` what phase_candidates_ref writes: the new
    center of every slot (the others copied) and the candidates at [0,
    delta C).  `final`: the delta = 0 pass's kept-empty rule.

    On CUDA one launch of csrc/closest_mean.cu's phase instantiation on the
    current stream, without syncing (P = 0 too: every segment is empty, and
    at C = 0, which has no rows, one block copies the centers); scratch from
    PyTorch's caching allocator; out.arrive must be zero, as new_candidates
    makes it and the kernel leaves it."""
    n, n_slots, dev = _check_state("closest_candidates", st, rows)
    m = delta * n_alive
    if not 0 <= n_alive <= n_slots or not 0 <= n_pairs <= len(lay.b_rows) or delta < 0:
        raise ValueError(f"closest_candidates: bad C = {n_alive}, P = {n_pairs} or "
                         f"delta = {delta} for {n_slots} slots")
    _check("closest_candidates", [
        ("out.cen", out.cen, torch.int64, n_slots), ("out.a", out.a, torch.int64, m),
        ("out.b", out.b, torch.int64, m), ("out.seg", out.seg, torch.int64, m),
        ("out.ok", out.ok, torch.bool, m), ("out.arrive", out.arrive, torch.int32, m)],
        dev)
    _check_layout("closest_candidates", lay, n, n_slots, 0, dev)
    b, sg = lay.b_rows[:n_pairs], lay.seg[:n_pairs]
    _check_closest(counts, mags, b, sg, keep, n_alive, None, None)
    if counts.device != dev:
        raise ValueError(f"closest_candidates: the store is on {counts.device}, "
                         f"the state on {dev}")
    kw = dict(maxc=maxc, tie_margin=tie_margin, final=final)
    if dev.type == "cpu":
        return closest_candidates_ref(counts, mags, keep, st, rows, delta, lay,
                                      n_alive, n_pairs, out, **kw)
    first = torch.empty(n_alive, dtype=torch.int64, device=dev)
    unc = torch.empty(n_alive, dtype=torch.bool, device=dev)
    # v, dist2 and mag per position
    scratch = torch.empty(3 * n_pairs, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = getattr(_closest_lib(), _CAND_ENTRY[counts.dtype])(
            counts.data_ptr(), counts.shape[1], mags.data_ptr(), b.data_ptr(),
            sg.data_ptr(), keep.data_ptr(), n_pairs, n_alive, int(maxc),
            float(tie_margin), scratch.data_ptr(), scratch.numel(), first.data_ptr(),
            unc.data_ptr(), n_slots, int(delta), int(final),
            *_ptrs(st.alive, st.cen, lay.inv, lay.moff, lay.flat, rows.lens,
                   rows.blen, rows.elen, out.arrive, out.cen, out.a, out.b, out.seg,
                   out.ok), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"closest_candidates kernel launch failed: cudaError {rc}")
    closest_candidates.launches += 1
    return first, unc


closest_candidates.launches = 0  # kernel launches since the last reset


def exchange_words(n_pairs: int, n_alive: int, d: int) -> int:
    """Words of closest_candidates_block's exchange: the keep bits and the
    uncertainty bits of P = n_pairs positions (32 a word), then the column
    sums [C, D]."""
    return 2 * -(-n_pairs // 32) + n_alive * d


def exchange_dtype(n_pairs: int, maxc: int) -> torch.dtype:
    """The exchange's word: int32 where every segment's column sums fit it
    (a segment keeps at most P rows of counts <= maxc: P maxc < 2^31), else
    int64."""
    return torch.int32 if n_pairs * maxc < 2 ** 31 else torch.int64


def _bits_words(bits: torch.Tensor, dtype) -> torch.Tensor:
    """bool [P] -> the words of 32 positions each (bit p % 32 of word p // 32),
    as `dtype` (int32 keeps the 32 bits as its two's complement)."""
    nw = -(-len(bits) // 32)
    pad = torch.zeros(nw * 32, dtype=torch.int64, device=bits.device)
    pad[:len(bits)] = bits.to(torch.int64)
    w = (pad.view(nw, 32) << torch.arange(32, device=bits.device)).sum(dim=1)
    if dtype == torch.int32:
        w = w - ((w >> 31) << 32)
    return w.to(dtype)


def _words_bits(words: torch.Tensor, n_pairs: int) -> torch.Tensor:
    w = words.to(torch.int64) & 0xFFFFFFFF
    return ((w[:, None] >> torch.arange(32, device=w.device)) & 1).view(-1)[:n_pairs].bool()


def candidates_exchange_ref(blk: RowBlock, rows: torch.Tensor, seg: torch.Tensor,
                            n_alive: int, own_cs: torch.Tensor, own_keep: torch.Tensor,
                            own_unc: torch.Tensor, xbuf: torch.Tensor) -> None:
    """Phase 1 of the block mode in plain PyTorch: the exchange (the dtype of
    xbuf) over the P = len(rows) pairs: the keep and uncertainty bits of the
    rank's own pairs (member row in the block; bit i of the filter's
    own_keep / own_unc at own_cs[p] - 1), zeros elsewhere, then
    block_sums_ref of the own kept rows."""
    n_pairs, d = len(rows), blk.counts.shape[1]
    nw = -(-n_pairs // 32)
    idx = torch.nonzero((rows >= blk.lo) & (rows < blk.hi)).view(-1)
    keep_p = torch.zeros(n_pairs, dtype=torch.bool, device=rows.device)
    unc_p = torch.zeros_like(keep_p)
    keep_p[idx] = own_keep[own_cs[idx] - 1]
    unc_p[idx] = own_unc[own_cs[idx] - 1]
    x = xbuf[:exchange_words(n_pairs, n_alive, d)]
    x[:nw] = _bits_words(keep_p, x.dtype)
    x[nw:2 * nw] = _bits_words(unc_p, x.dtype)
    x[2 * nw:] = block_sums_ref(blk, rows, seg, keep_p, n_alive).view(-1).to(x.dtype)


def candidates_partials_ref(blk: RowBlock, rows: torch.Tensor, seg: torch.Tensor,
                            n_alive: int, xbuf: torch.Tensor) -> torch.Tensor:
    """Phase 2 of the block mode in plain PyTorch: block_partials_ref over
    the rank's kept rows, with the keep bits, counts and column sums of the
    all-reduced exchange; int64 [C, PART]."""
    n_pairs, d = len(rows), blk.counts.shape[1]
    nw = -(-n_pairs // 32)
    keep = _words_bits(xbuf[:nw], n_pairs)
    cnt = torch.zeros(n_alive, dtype=torch.int64, device=rows.device).index_add_(
        0, seg, keep.to(torch.int64))
    num = xbuf[2 * nw:2 * nw + n_alive * d].view(n_alive, d).to(torch.int64)
    return block_partials_ref(blk, rows, seg, keep, n_alive, num, cnt)


def closest_candidates_block(phase: int, blk: RowBlock, st: PhaseState, rows: PhaseRows,
                             delta: int, lay: Layout, n_alive: int, n_pairs: int,
                             out: Candidates, *, tie_margin: float, final: bool = False,
                             xbuf: Optional[torch.Tensor] = None,
                             own_cs: Optional[torch.Tensor] = None,
                             own_keep: Optional[torch.Tensor] = None,
                             own_unc: Optional[torch.Tensor] = None,
                             rank_part: Optional[torch.Tensor] = None,
                             parts: Optional[torch.Tensor] = None):
    """One phase (1, 2 or 3) of closest_candidates on a rank of a row-sharded
    store (module docstring): `blk` holds the rank's rows, the layout's
    member rows lay.b_rows are global.  Phase 1 writes the exchange `xbuf`
    (int32 or int64, its dtype the word, 1-D [>= exchange_words(P, C, D)];
    int32 only where exchange_dtype allows it) from the filter's bits of the
    rank's own pairs: own_keep and own_unc (bool [k]) of the pairs whose
    member row the block holds, in position order, own_cs (int64 [>= P]) the
    number of such pairs in [0, p]; the caller all-reduces xbuf (SUM), whose
    uncertainty bits are the filter's.  Phase 2 reads it and writes the
    rank's partials into rank_part[:C] (int64 [>= C, 6]), which the caller
    all-gathers into `parts` (int64 [G, C, 6]); phase 3 returns (first,
    unc) as closest_candidates and writes `out` as it does.  Phases 1 and 2
    return None.

    On CUDA one launch of csrc/closest_mean.cu's block mode a phase, on the
    current stream, without syncing (phases 1 and 2 launch nothing at C =
    0); on the CPU the plain versions (candidates_exchange_ref,
    candidates_partials_ref, pick_ref, then phase_candidates_ref)."""
    n, n_slots, dev = _check_state("closest_candidates_block", st, rows)
    m = delta * n_alive
    if phase not in (1, 2, 3):
        raise ValueError(f"closest_candidates_block: the phase is 1, 2 or 3, got {phase}")
    if not 0 <= n_alive <= n_slots or not 0 <= n_pairs <= len(lay.b_rows) or delta < 0:
        raise ValueError(f"closest_candidates_block: bad C = {n_alive}, P = {n_pairs} or "
                         f"delta = {delta} for {n_slots} slots")
    _check("closest_candidates_block", [
        ("out.cen", out.cen, torch.int64, n_slots), ("out.a", out.a, torch.int64, m),
        ("out.b", out.b, torch.int64, m), ("out.seg", out.seg, torch.int64, m),
        ("out.ok", out.ok, torch.bool, m), ("out.arrive", out.arrive, torch.int32, m)],
        dev)
    _check_layout("closest_candidates_block", lay, n, n_slots, 0, dev)
    counts, d = blk.counts, blk.counts.shape[1]
    if counts.dtype not in _CAND_BLOCK_ENTRY or counts.dim() != 2 or counts.device != dev:
        raise ValueError(f"closest_candidates_block: counts must be uint8/uint16 [rows, D] "
                         f"on {dev}")
    # the moments cover every store row, the state's n rows among them
    n_rows = len(blk.mags)
    if blk.mags.dtype != torch.float64 or n_rows < n or blk.mags.device != dev:
        raise ValueError(f"closest_candidates_block: mags must be float64 [>= {n}] on {dev}")
    if not 0 <= blk.lo <= blk.hi <= n_rows or counts.shape[0] < blk.hi - blk.lo:
        raise ValueError(f"closest_candidates_block: rows [{blk.lo}, {blk.hi}) do not fit")
    if phase in (1, 2):
        if (xbuf is None or xbuf.dtype not in (torch.int32, torch.int64) or xbuf.dim() != 1
                or xbuf.device != dev or not xbuf.is_contiguous()
                or len(xbuf) < exchange_words(n_pairs, n_alive, d)):
            raise ValueError(f"closest_candidates_block: xbuf must be contiguous int32/int64 "
                             f"[>= {exchange_words(n_pairs, n_alive, d)}] on {dev}")
        if xbuf.dtype == torch.int32 and exchange_dtype(n_pairs, blk.maxc) != torch.int32:
            raise ValueError(f"closest_candidates_block: P maxc = {n_pairs * blk.maxc} is "
                             f"past the int32 sums")
    if phase == 1:
        k = 0 if own_keep is None else len(own_keep)
        _check("closest_candidates_block", [
            ("own_cs", own_cs, torch.int64, n_pairs),
            ("own_keep", own_keep, torch.bool, k), ("own_unc", own_unc, torch.bool, k)], dev)
        if len(own_unc) != k:
            raise ValueError("closest_candidates_block: own_keep and own_unc differ in length")
    if phase == 2 and (rank_part is None or rank_part.dtype != torch.int64
                       or rank_part.device != dev or not rank_part.is_contiguous()
                       or rank_part.shape[0] < n_alive or rank_part.shape[1:] != (PART,)):
        raise ValueError(f"closest_candidates_block: rank_part must be contiguous int64 "
                         f"[>= {n_alive}, {PART}] on {dev}")
    if phase == 3 and (parts is None or parts.dtype != torch.int64 or parts.device != dev
                       or not parts.is_contiguous() or parts.dim() != 3
                       or parts.shape[1] != n_alive or parts.shape[2] != PART):
        raise ValueError(f"closest_candidates_block: parts must be contiguous int64 "
                         f"[G, {n_alive}, {PART}] on {dev}")
    b, sg = lay.b_rows[:n_pairs], lay.seg[:n_pairs]
    if dev.type == "cpu":
        if phase == 1:
            candidates_exchange_ref(blk, b, sg, n_alive, own_cs, own_keep, own_unc, xbuf)
        elif phase == 2:
            rank_part[:n_alive] = candidates_partials_ref(blk, b, sg, n_alive, xbuf)
        else:
            first, unc = pick_ref(parts, n_pairs, tie_margin)
            phase_candidates_ref(st, rows, delta, lay, first, n_alive, n_pairs, out, final)
            return first, unc
        return None
    first = torch.empty(n_alive, dtype=torch.int64, device=dev)
    unc = torch.empty(n_alive, dtype=torch.bool, device=dev)
    scratch = torch.empty(3 * n_pairs if phase == 2 else 0, dtype=torch.int64, device=dev)
    ptr = lambda t: t.data_ptr() if t is not None else None
    with torch.cuda.device(dev):
        rc = getattr(_closest_lib(), _CAND_BLOCK_ENTRY[counts.dtype])(
            counts.data_ptr(), d, blk.mags.data_ptr(), b.data_ptr(), sg.data_ptr(),
            None, n_pairs, n_alive, int(blk.maxc), float(tie_margin),
            scratch.data_ptr(), scratch.numel(), first.data_ptr(), unc.data_ptr(),
            n_slots, int(delta), int(final),
            *_ptrs(st.alive, st.cen, lay.inv, lay.moff, lay.flat, rows.lens,
                   rows.blen, rows.elen, out.arrive, out.cen, out.a, out.b, out.seg,
                   out.ok), int(blk.lo), int(blk.hi), int(phase), ptr(rank_part),
            ptr(parts), parts.shape[0] if parts is not None else 0, ptr(xbuf),
            int(xbuf is not None and xbuf.dtype == torch.int64), ptr(own_cs),
            ptr(own_keep), ptr(own_unc), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"closest_candidates block kernel launch failed (phase {phase}): "
                           f"cudaError {rc}")
    if phase == 3 or n_alive:
        closest_candidates_block.launches += 1
    return (first, unc) if phase == 3 else None


closest_candidates_block.launches = 0  # kernel launches since the last reset


def own_pairs(blk: RowBlock, rows: torch.Tensor, keep: torch.Tensor,
              unc: Optional[torch.Tensor] = None):
    """(own_cs, own_keep, own_unc) of the block's pairs (member row in the
    block) among rows [P], from the whole filter's keep (and uncertainty)
    bits: what the rank's filter gives for its own pairs."""
    own = (rows >= blk.lo) & (rows < blk.hi)
    unc = torch.zeros_like(keep) if unc is None else unc
    return torch.cumsum(own, 0, dtype=torch.int64), keep[own], unc[own]


def closest_candidates_blocks(blocks, keep, st, rows, delta, lay, n_alive, n_pairs,
                              outs, *, tie_margin: float, final: bool = False,
                              unc=None, dtype=None, exchanges=None):
    """closest_candidates over G row blocks in one process, as G ranks run
    it: each block's phase 1 from the filter's bits of its own pairs
    (`own_pairs` of keep and unc, bool [P]; unc zeros by default) into an
    exchange of `dtype` (exchange_dtype by default); the exchanges summed
    (the all-reduce); each block's phase 2; the partials stacked (the
    all-gather); each block's phase 3 into its own `outs[g]` (each with its
    own arrival counters).  Returns each block's (first, unc); the summed
    exchange is appended to the list `exchanges` where one is given."""
    dev = st.cen.device
    d = blocks[0].counts.shape[1]
    C = n_alive
    dtype = dtype or exchange_dtype(n_pairs, blocks[0].maxc)
    L = exchange_words(n_pairs, C, d)
    xbufs = [torch.zeros(L, dtype=dtype, device=dev) for _ in blocks]
    rank_parts = [torch.zeros((C, PART), dtype=torch.int64, device=dev) for _ in blocks]
    args = (st, rows, delta, lay, n_alive, n_pairs)
    kw = dict(tie_margin=tie_margin, final=final)
    b = lay.b_rows[:n_pairs]
    for g, blk in enumerate(blocks):
        cs, k, u = own_pairs(blk, b, keep, unc)
        closest_candidates_block(1, blk, *args, outs[g], xbuf=xbufs[g], own_cs=cs,
                                 own_keep=k, own_unc=u, **kw)
    total = torch.stack(xbufs).sum(dim=0, dtype=dtype)
    if exchanges is not None:
        exchanges.append(total)
    for g, blk in enumerate(blocks):
        closest_candidates_block(2, blk, *args, outs[g], xbuf=total, rank_part=rank_parts[g],
                                 **kw)
    gathered = torch.stack(rank_parts)
    return [closest_candidates_block(3, blk, *args, outs[g], parts=gathered, **kw)
            for g, blk in enumerate(blocks)]


# -- the merge replay ---------------------------------------------------------


def merge_replay_ref(st: PhaseState, t_dst: torch.Tensor, out: PhaseState) -> None:
    """Plain PyTorch `merge_replay`: the JAX program's event loop
    (device_phase.py:rp_body), one masked update of every row an event."""
    assign, seq = st.assign.clone(), st.seq.clone()
    clen, alive = st.clen.clone(), st.alive.clone()
    events = torch.nonzero(st.alive & (t_dst >= 0)).view(-1).tolist()
    for src in events:
        dst = int(t_dst[src])
        m = assign == src
        seq[m] += clen[dst]
        assign[m] = dst
        clen[dst] += clen[src]
        clen[src] = 0
        alive[src] = False
    out.assign.copy_(assign)
    out.seq.copy_(seq)
    out.clen.copy_(clen)
    out.alive.copy_(alive)


def merge_replay(st: PhaseState, t_dst: torch.Tensor, out: PhaseState) -> None:
    """The merge pass's absorb events t_dst (int64 [S]: the slot each alive
    slot merges into, above it, or -1) applied to `st` in ascending slot
    order into out.assign, out.seq, out.clen and out.alive (out.cen is not
    touched): the members of a source get seq += clen[dst] and assign =
    dst, clen[dst] grows by the source's, the source dies.

    On CUDA one launch on the current stream, without syncing; above
    smem_slots("merge_replay") slots the wide instantiation, a cooperative
    launch with an int32 [5 S] scratch from the caching
    allocator.  out.clen and out.alive must not be st's: every block reads
    st's slots."""
    n, n_slots = len(st.assign), len(st.cen)
    dev = st.assign.device
    i64 = torch.int64
    _check("merge_replay", [
        ("assign", st.assign, i64, n), ("seq", st.seq, i64, n),
        ("alive", st.alive, torch.bool, n_slots), ("clen", st.clen, i64, n_slots),
        ("t_dst", t_dst, i64, n_slots), ("out.assign", out.assign, i64, n),
        ("out.seq", out.seq, i64, n), ("out.alive", out.alive, torch.bool, n_slots),
        ("out.clen", out.clen, i64, n_slots)], dev)
    if dev.type == "cpu":
        return merge_replay_ref(st, t_dst, out)
    if n == 0 or n_slots == 0:
        return None
    if n >= 2 ** 31:
        raise ValueError(f"merge_replay: {n} rows is past the kernel's int32 rows")
    if (out.clen.data_ptr() == st.clen.data_ptr()
            or out.alive.data_ptr() == st.alive.data_ptr()):
        raise ValueError("merge_replay: out.clen and out.alive must not be st's")
    wide = n_slots > smem_slots("merge_replay", dev)
    scratch = torch.empty(5 * n_slots, dtype=torch.int32, device=dev) if wide else None
    with torch.cuda.device(dev):
        rc = _lib().mc2_merge_replay(
            n, n_slots, *_ptrs(st.assign, st.seq, st.alive, st.clen, t_dst,
                               out.assign, out.seq, out.alive, out.clen),
            scratch.data_ptr() if wide else None, scratch.numel() if wide else 0,
            _stream(dev))
    if rc != 0:
        raise RuntimeError(f"merge_replay kernel launch failed: cudaError {rc}")
    merge_replay.launches += 1
    if wide:
        merge_replay.wide_launches += 1
    return None


merge_replay.launches = 0  # kernel launches since the last reset
merge_replay.wide_launches = 0  # of them, the wide instantiation's
