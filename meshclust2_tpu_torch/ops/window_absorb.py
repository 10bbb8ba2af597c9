"""The accumulate step's tail: the window's decisions, its case applied to
the loop state, and the next center (closest-to-mean), in one launch.

The port of what meshclust2_tpu/cluster/device_loop.py's program body
(lines 1357-1467) does after the pair statistics: the decision half of
_build_program.scan_window._chunk_heavy (lines 1074-1209), the gated state
updates, and closest_to_mean / _mc_heavy (lines 1223-1355), XLA programs on
the TPU.  On CUDA tensors `window_step` launches the hand-written
cooperative kernel in csrc/window_absorb.cu; on CPU tensors it runs
`window_step_ref`, the plain PyTorch version, built on `window_absorb_ref`
(the decisions) and `closest_mean_ref`'s one-segment mode.

For the W >= 1 candidates of one window (cand[p], flat positions in flat
order; rows[p] = order[cand[p]]), with their float64 GLM sums s, dists and
pair statistics against the center:
    pos[p]  = s[p] >= pos_edge;
    bits    = 1 when some s[p] lies within max(8 s_err[p], margin *
              max(|s|, |pos_edge|, 1)) of the edge, | 2 when some candidate
              lies within max(8 (dist_err[p] + dist_err[best]), tie_margin *
              max(|dist[best]|, 1)) of the best dist while its dist or its
              keys differ from the best's (`tie`: the fields the model's
              dist reads, `tie_keys`; TIE_ALL, its stats, mags, selfdot,
              lens and stddev, where a single is not one of the
              statistics'), or, with `full` (a model with full-vector
              singles), its row does;
              s_err and dist_err are the fused kernel's bounds (0 for
              other models, where the gates reduce to the margins);
    best    = the first position of the largest dist;
    npos    = the number of positives.
Then, with bits 0, the min case (npos 0: cand[best] opens cluster cid + 1
at stamp stepc, alone in the member list, msum its row) or the absorb case
(the positives join cluster cid at stamp stepc, appended to the member
list after its first mcnt entries, msum += their column sums), and when
absorbing the member closest to the new mean.  Returns trip = int64 [4]
(bits, npos, closest-to-mean uncertain (0 unless absorbing), next center).

`window_step_block` is the same step on a rank of a row-sharded store (the
kernel's block mode, parallel/multihost_session.py): its counts hold only
the rank's rows (a RowBlock), the moments and the state are every rank's
alike, and the step is three launches with two collectives between them:
phase 1 writes the exchange from the rank's own candidates (their
statistics and decisions at their window positions, their positives'
column sums, the rank's first maximum's row in its seed slot; zeros
elsewhere), which the host all-reduces; phase 2, the decisions, the case,
msum and the rank's closest-to-mean partial in one launch; the host
all-gathers the partials; phase 3, the pick.  `window_step_blocks` runs G
blocks in one process, the exchange summed and the partials stacked as the
collectives do it.  Plain version `window_step_block_ref`.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from ..features import flags as F
from .closest_mean import (PART, RowBlock, _rows_i64, block_partials_ref, closest_mean_ref,
                           pick_ref)

# rows of the plain version's int64 temporaries per step
_REF_CHUNK = 16384

_ENTRY = {torch.uint8: "mc2_window_step_u8", torch.uint16: "mc2_window_step_u16"}
_BLOCK_ENTRY = {torch.uint8: "mc2_window_step_block_u8",
                torch.uint16: "mc2_window_step_block_u16"}


# the tie guard's keys: a near candidate whose keys and dist equal the
# best's ties it exactly, on the host too.  Besides the statistics and the
# moments, two exact integers that some singles read alone: selfdot - 2 dot
# (the squared euclidean distance less the center's selfdot) and mags - 2
# summin (the manhattan distance less the center's magnitude); the kernel's
# kTie* constants
(TIE_SUMMIN, TIE_DOT, TIE_EMD, TIE_MAG, TIE_SELFDOT, TIE_LEN, TIE_STD, TIE_NORM2,
 TIE_MANH) = (1 << i for i in range(9))
TIE_ALL = TIE_SUMMIN | TIE_DOT | TIE_EMD | TIE_MAG | TIE_SELFDOT | TIE_LEN | TIE_STD
# what each single's value is a function of, in the fused kernel and on the
# host alike (features/host.py, native/score_impl.h)
_SINGLE_TIE = {
    F.FEAT_MANHATTAN: TIE_MANH, F.FEAT_EUCLIDEAN: TIE_NORM2,
    F.FEAT_INTERSECTION: TIE_SUMMIN | TIE_MAG, F.FEAT_KULCZYNSKI2: TIE_SUMMIN | TIE_MAG,
    F.FEAT_SIMRATIO: TIE_DOT | TIE_NORM2, F.FEAT_NORMALIZED_VECTORS: TIE_DOT | TIE_SELFDOT,
    F.FEAT_PEARSON_COEFF: TIE_DOT | TIE_MAG | TIE_SELFDOT,
    F.FEAT_D2z: TIE_DOT | TIE_MAG | TIE_STD,
    F.FEAT_EUCLIDEAN_Z: TIE_DOT | TIE_MAG | TIE_SELFDOT | TIE_STD,
    F.FEAT_EMD: TIE_EMD, F.FEAT_LENGTHD: TIE_LEN}


def tie_keys(singles, combos) -> int:
    """The tie guard's keys for a model (its singles' flags and its combos
    (kind, single indices)): those of the singles of the first combo, whose
    value is the dist; TIE_ALL where one of them is not a statistics' single
    (a full-vector single compares rows as well, `full`).  Without combos
    the dist is a constant: no key."""
    keys = 0
    for i in (combos[0][1] if combos else ()):
        if singles[i] not in _SINGLE_TIE:
            return TIE_ALL
        keys |= _SINGLE_TIE[singles[i]]
    return keys


class StepState(NamedTuple):
    """The accumulate loop's state on the card, updated in place."""
    alive: torch.Tensor    # bool [n]: still in the pool
    assign: torch.Tensor   # int64 [n]: cluster id, -1 while alive
    astep: torch.Tensor    # int64 [n]: absorb stamp, 0 while alive
    members: torch.Tensor  # int64 [n + 1]: the open cluster's flat positions;
                           # slot n is the plain version's scatter sink
    msum: torch.Tensor     # int64 [D]: the open cluster's column sums


def _lib():
    from ._build import load

    lib = load("window_absorb").lib
    if lib.mc2_window_step_scratch_len.argtypes is None:
        p, i64, f64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = [p, ctypes.c_int, p, p, p, p, p, p, i64, p, p, p, p,
                           ctypes.c_int, p, f64, f64, f64, i64, p, p, p, p, p, p,
                           i64, i64, i64, p, i64, i64, ctypes.c_int, p]
            fn.restype = ctypes.c_int
        for name in _BLOCK_ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = [p, ctypes.c_int, p, p, p, p, p, p, i64, f64, f64, f64, i64,
                           p, p, p, p, p, p, i64, i64, i64, p, i64, i64, i64, i64,
                           ctypes.c_int, p, p, i64, p, p, p, i64, ctypes.c_int,
                           ctypes.c_int, p, p, ctypes.c_int, p]
            fn.restype = ctypes.c_int
        lib.mc2_window_step_scratch_len.argtypes = [i64]
        lib.mc2_window_step_scratch_len.restype = i64
    return lib


def step_scratch(n: int, device) -> torch.Tensor:
    """The step kernel's scratch for a pool of n flat positions (the trip,
    per-block partials, per-member distances), allocated once by the
    caller; on the CPU the plain versions' trip alone (int64 [4])."""
    device = torch.device(device)
    if device.type != "cuda":
        return torch.zeros(4, dtype=torch.int64, device=device)
    # zeroed: it holds the kernel's count of finished blocks
    return torch.zeros(_lib().mc2_window_step_scratch_len(n),
                       dtype=torch.int64, device=device)


def _check(counts, rows, s, dist, stats, s_err, dist_err, moments, n_rows=None):
    """n_rows: the moments' length where it is not the counts' (a row
    block's moments cover every store row)."""
    if counts.dtype not in _ENTRY:
        raise TypeError(f"counts must be uint8 or uint16, got {counts.dtype}")
    if counts.dim() != 2:
        raise ValueError(f"counts must be [N, D], got shape {tuple(counts.shape)}")
    n_cand = len(rows)
    want = (("rows", rows, torch.int64, (n_cand,)),
            ("s", s, torch.float64, (n_cand,)),
            ("dist", dist, torch.float64, (n_cand,)),
            ("stats", stats, torch.int64, (n_cand, 3)),
            ("s_err", s_err, torch.float64, (n_cand,)),
            ("dist_err", dist_err, torch.float64, (n_cand,)))
    rows_shape = counts.shape[:1] if n_rows is None else (n_rows,)
    want += tuple((name, t, torch.float64, rows_shape)
                  for name, t in zip(("mags", "selfdot", "lens", "stddevs"), moments))
    for name, t, dtype, shape in want:
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")
        if t.device != counts.device:
            raise ValueError(f"{name} is on {t.device}, counts on {counts.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not counts.is_contiguous():
        raise ValueError("counts must be contiguous")
    if counts.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {counts.device}")


def window_absorb_ref(counts, rows, s, dist, stats, mags, selfdot, lens, stddevs,
                      *, pos_edge: float, margin: float, tie_margin: float,
                      s_err: torch.Tensor, dist_err: torch.Tensor, tie: int,
                      full: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The decisions of one window in plain PyTorch, the same float64
    operations as the step kernel's: (pos bool [W], the positives' int64
    [D] column sum, info int64 [3] = (bits, npos, best)); best is W when W
    is 0."""
    _check(counts, rows, s, dist, stats, s_err, dist_err,
           (mags, selfdot, lens, stddevs))
    n_cand, d = len(rows), counts.shape[1]
    dev = counts.device
    pos, bits, best = _decide(counts, rows, s, dist, stats, (mags, selfdot, lens, stddevs),
                              pos_edge=pos_edge, margin=margin, tie_margin=tie_margin,
                              s_err=s_err, dist_err=dist_err, full=full, keys=tie)
    # CUDA has no uint16 gather: gather the same bits as int16 and mask
    src, mask = ((counts.view(torch.int16), 0xFFFF)
                 if counts.dtype == torch.uint16 else (counts, 0xFF))
    colsum = torch.zeros(d, dtype=torch.int64, device=dev)
    for c in range(0, n_cand, _REF_CHUNK):
        h = src[rows[c:c + _REF_CHUNK]].to(torch.int64) & mask
        colsum += (h * pos[c:c + _REF_CHUNK, None]).sum(dim=0)
    info = torch.stack([bits, pos.sum(dtype=torch.int64), best.to(torch.int64)])
    return pos, colsum, info


def _decide(counts, rows, s, dist, stats, moments, *, pos_edge: float, margin: float,
            tie_margin: float, s_err: torch.Tensor, dist_err: torch.Tensor, full: bool,
            keys: int):
    """The window's decisions, the step kernel's float64 operations: (pos
    bool [W], bits int64, best int64; best is W when W is 0).  The moments
    are indexed by the global rows; `counts` is read only with `full`; `keys`
    the tie guard's."""
    n_cand = len(rows)
    dev = s.device
    mags, selfdot, lens, stddevs = moments
    pos = s >= pos_edge
    scale = s.abs().clamp(min=max(abs(pos_edge), 1.0))
    thr = torch.fmax(8 * s_err, margin * scale)
    unc = ((s - pos_edge).abs() <= thr).any()
    tie = torch.zeros((), dtype=torch.bool, device=dev)
    best = torch.full((), n_cand, dtype=torch.int64, device=dev)
    if n_cand:
        # torch.argmax returns the first maximal position
        best = torch.argmax(dist)
        bv = dist[best]
        tie_thr = torch.fmax(8 * (dist_err + dist_err[best]),
                             tie_margin * bv.abs().clamp(min=1.0))
        near = (dist - bv).abs() <= tie_thr
        sd, dot = selfdot[rows], stats[:, 1].to(torch.float64)
        ma, summin = mags[rows], stats[:, 0].to(torch.float64)
        same = dist == bv
        for key, col in ((TIE_SUMMIN, stats[:, 0]), (TIE_DOT, stats[:, 1]),
                         (TIE_EMD, stats[:, 2]), (TIE_MAG, ma), (TIE_SELFDOT, sd),
                         (TIE_LEN, lens[rows]), (TIE_STD, stddevs[rows]),
                         (TIE_NORM2, sd - 2 * dot), (TIE_MANH, ma - 2 * summin)):
            if keys & key:
                same &= col == col[best]
        if full:
            # the statistics and moments do not determine a full-vector
            # single: the near candidates' rows must equal the best's
            idx = torch.nonzero(near & same).view(-1)
            same[idx] = (_rows_i64(counts, rows[idx])
                         == _rows_i64(counts, rows[best].view(1))).all(dim=1)
        tie = (near & ~same).any()
    return pos, unc.to(torch.int64) | 2 * tie.to(torch.int64), best


def _check_step(store, order, cand, s, dist, stats, state: StepState, cur_d,
                mcnt: int, s_err, dist_err, n_rows=None):
    counts = store.counts
    _check(counts, cand, s, dist, stats, s_err, dist_err,
           (store.mags, store.selfdot, store.lens, store.stddevs), n_rows)
    n = len(order)
    want = (("order", order, torch.int64, (n,)),
            ("cand", cand, torch.int64, (len(cand),)),
            ("alive", state.alive, torch.bool, (n,)),
            ("assign", state.assign, torch.int64, (n,)),
            ("astep", state.astep, torch.int64, (n,)),
            ("members", state.members, torch.int64, (n + 1,)),
            ("msum", state.msum, torch.int64, (counts.shape[1],)),
            ("cur_d", cur_d, torch.int64, (1,)))
    for name, t, dtype, shape in want:
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != counts.device:
            raise ValueError(f"{name} is on {t.device}, counts on {counts.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= len(cand) <= n - mcnt or mcnt < 0:
        raise ValueError(f"need 1 <= W <= n - mcnt, got W = {len(cand)}, "
                         f"n = {n}, mcnt = {mcnt}")


def window_step_ref(store, order, cand, s, dist, stats, state: StepState,
                    cur_d, *, cid: int, stepc: int, mcnt: int, pos_edge: float,
                    margin: float, tie_margin: float, s_err: torch.Tensor,
                    dist_err: torch.Tensor, tie: int, full: bool = False
                    ) -> torch.Tensor:
    """The step in plain PyTorch: `window_absorb_ref`, both cases under
    the decision flags, and `closest_mean_ref`'s one-segment mode over the
    first mcnt + W member slots with the first mcnt + npos kept.
    Candidates are alive, and alive rows are unassigned with stamp 0, so
    the else-values need no gather."""
    _check_step(store, order, cand, s, dist, stats, state, cur_d, mcnt, s_err,
                dist_err)
    counts = store.counts
    n, n_cand = len(order), len(cand)
    i64 = dict(dtype=torch.int64, device=counts.device)
    alive, assign, astep, members, msum = state
    pos, colsum, info = window_absorb_ref(
        counts, order[cand], s, dist, stats, store.mags, store.selfdot,
        store.lens, store.stddevs, pos_edge=pos_edge, margin=margin,
        tie_margin=tie_margin, s_err=s_err, dist_err=dist_err, full=full, tie=tie)
    bits, npos, best = info[0:1], info[1:2], info[2:3]
    ok = bits == 0
    absorb = ok & (npos > 0)
    is_min = ok & (npos == 0)

    pa = pos & absorb
    seed = cand[best.clamp(max=n_cand - 1)]
    _absorb_case(state, cand, pa, cid, stepc, mcnt)
    new_sum = msum + colsum
    size = mcnt + n_cand
    count = npos + mcnt
    first, unc = closest_mean_ref(
        counts, store.mags, order[members[:size]], None,
        torch.arange(size, **i64) < count, 1, maxc=store.maxc,
        tie_margin=tie_margin, col_sum=new_sum, count=count)
    unc = unc & absorb   # the loop reads it only after an absorb
    cur_next = torch.where(absorb & ~unc, members[first.clamp(max=n)],
                           torch.where(is_min, seed, cur_d))
    msum.copy_(torch.where(absorb, new_sum, msum))
    row = _rows_i64(counts, order[seed])[0]
    _min_case(state, seed, is_min, cid, stepc)
    msum.copy_(torch.where(is_min, row, msum))
    return torch.cat([bits, npos, unc.to(torch.int64), cur_next])


def _absorb_case(state: StepState, cand, pa, cid: int, stepc: int, mcnt: int) -> None:
    """The absorb case on the candidates: the positives `pa` join cluster
    cid at stamp stepc, appended to the member list in flat order after
    its first mcnt; the others stay in the pool (where pa is all False,
    nothing changes: candidates are alive, unassigned, stamp 0)."""
    alive, assign, astep, members, _ = state
    n = len(alive)
    alive[cand] = ~pa
    assign[cand] = torch.where(pa, cid, -1)
    astep[cand] = torch.where(pa, stepc, 0)
    slot = torch.cumsum(pa, 0, dtype=torch.int64) + (mcnt - 1)
    members.scatter_(0, torch.where(pa, slot, n), cand)


def _min_case(state: StepState, seed, is_min, cid: int, stepc: int) -> None:
    """The min case, under the flag is_min: the seed leaves the pool and
    opens cluster cid + 1 at stamp stepc, alone in the member list."""
    alive, assign, astep, members, _ = state
    alive[seed] = alive[seed] & ~is_min
    assign[seed] = torch.where(is_min, cid + 1, assign[seed])
    astep[seed] = torch.where(is_min, stepc, astep[seed])
    members[:1] = torch.where(is_min, seed, members[:1])


def window_step(store, order: torch.Tensor, cand: torch.Tensor, s: torch.Tensor,
                dist: torch.Tensor, stats: torch.Tensor, state: StepState,
                cur_d: torch.Tensor, *, cid: int, stepc: int, mcnt: int,
                pos_edge: float, margin: float, tie_margin: float,
                s_err: torch.Tensor, dist_err: torch.Tensor, tie: int, full: bool = False,
                scratch: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One accumulate step's tail (module docstring) over a DeviceStore
    `store`, the pool's flat-order `order` (int64 [n], flat position ->
    store row), the W >= 1 candidates `cand` with their float64 [W] s and
    dist and int64 [W, 3] statistics, `state` (updated in place) and the
    center's flat position `cur_d` (int64 [1]) -> trip int64 [4].  s_err
    and dist_err (float64 [W]) are the fused kernel's bounds; `full` asks
    for row identity in an exact tie, and `tie` gives the keys it compares
    (`tie_keys`).

    On CUDA one cooperative launch on the current stream, without syncing;
    `scratch` comes from `step_scratch(n)` (allocated here when None), and
    the trip returned is a view of it, overwritten by the next launch with
    the same scratch.  cur_d may be the previous trip's last entry."""
    _check_step(store, order, cand, s, dist, stats, state, cur_d, mcnt, s_err,
                dist_err)
    kw = dict(cid=int(cid), stepc=int(stepc), mcnt=int(mcnt),
              pos_edge=float(pos_edge), margin=float(margin),
              tie_margin=float(tie_margin))
    counts = store.counts
    if counts.device.type == "cpu":
        return window_step_ref(store, order, cand, s, dist, stats, state, cur_d,
                               s_err=s_err, dist_err=dist_err, full=full, tie=tie, **kw)
    n = len(order)
    lib = _lib()
    need = lib.mc2_window_step_scratch_len(n)
    if scratch is None:
        scratch = step_scratch(n, counts.device)
    if (scratch.dtype != torch.int64 or scratch.device != counts.device
            or scratch.numel() < need or not scratch.is_contiguous()):
        raise ValueError(f"scratch must be int64 [>= {need}] on {counts.device}")
    stream = torch.cuda.current_stream(counts.device).cuda_stream
    with torch.cuda.device(counts.device):
        rc = getattr(lib, _ENTRY[counts.dtype])(
            counts.data_ptr(), counts.shape[1], store.mags.data_ptr(),
            store.selfdot.data_ptr(), store.lens.data_ptr(),
            store.stddevs.data_ptr(), order.data_ptr(), cand.data_ptr(),
            len(cand), s.data_ptr(), dist.data_ptr(), s_err.data_ptr(),
            dist_err.data_ptr(), int(full), stats.data_ptr(),
            kw["pos_edge"], kw["margin"], kw["tie_margin"], int(store.maxc),
            *(t.data_ptr() for t in state), cur_d.data_ptr(), kw["cid"],
            kw["stepc"], kw["mcnt"], scratch.data_ptr(), scratch.numel(), n,
            int(tie), stream)
    if rc != 0:
        raise RuntimeError(f"window_step kernel launch failed: cudaError {rc}")
    window_step.launches += 1
    return scratch[:4]


window_step.launches = 0  # kernel launches since the last reset


# -- the block mode -------------------------------------------------------------


def seed_slot(d: int, itemsize: int) -> int:
    """int64 words of one rank's seed slot in the exchange: its first
    maximum's window position + 1, then that row's d counts as bytes."""
    return 1 + -(-d * itemsize // 8)


def step_xbuf_len(n_cand: int, d: int, itemsize: int, n_ranks: int) -> int:
    """int64 words of the block mode's exchange for a window of n_cand
    candidates (csrc/window_absorb.cu xbuf_words): the statistics [W, 3],
    (s, dist, s_err, dist_err) [4, W], the positives' column sums [d], then
    n_ranks seed slots."""
    return 7 * n_cand + d + n_ranks * seed_slot(d, itemsize)


def _check_block(phase: int, blk: RowBlock, order, cand, state: StepState, cur_d,
                 mcnt: int, scratch, xbuf, rank: int, n_ranks: int, own, rank_part,
                 parts):
    counts = blk.counts
    dev = counts.device
    if phase not in (1, 2, 3):
        raise ValueError(f"the block mode's phase is 1, 2 or 3, got {phase}")
    if counts.dtype not in _ENTRY or counts.dim() != 2 or not counts.is_contiguous():
        raise ValueError("the block's counts must be contiguous uint8/uint16 [rows, D]")
    n_rows, d = len(blk.mags), counts.shape[1]
    if not 0 <= blk.lo <= blk.hi <= n_rows or counts.shape[0] < blk.hi - blk.lo:
        raise ValueError(f"block rows [{blk.lo}, {blk.hi}) do not fit {n_rows} store rows "
                         f"and {counts.shape[0]} count rows")
    if not 0 <= rank < n_ranks:
        raise ValueError(f"rank {rank} is not one of {n_ranks}")
    n, n_cand = len(order), len(cand)
    want = [("order", order, torch.int64, (n,)), ("cand", cand, torch.int64, (n_cand,)),
            ("scratch", scratch, torch.int64, None)]
    if phase in (2, 3):
        want += [("members", state.members, torch.int64, (n + 1,)),
                 ("cur_d", cur_d, torch.int64, (1,))]
    if phase in (1, 2):
        want.append(("xbuf", xbuf, torch.int64,
                     (step_xbuf_len(n_cand, d, counts.element_size(), n_ranks),)))
    if phase == 1:
        own_pos, own_rows, own_stats, own_dec = own
        k = len(own_pos)
        want += [("own_pos", own_pos, torch.int64, (k,)),
                 ("own_rows", own_rows, torch.int64, (k,)),
                 ("own_stats", own_stats, torch.int64, (k, 3)),
                 ("own_dec", own_dec, torch.float64, (5, k))]
    if phase == 2:
        for name, t in zip(StepState._fields, state):
            want.append((name, t, torch.bool if name == "alive" else torch.int64,
                         (d,) if name == "msum" else (n + 1,) if name == "members"
                         else (n,)))
        want.append(("rank_part", rank_part, torch.int64, (PART,)))
    if phase == 3:
        want.append(("parts", parts, torch.int64, (n_ranks, PART)))
    for name, t, dtype, shape in want:
        if t is None or t.dtype != dtype or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype} on {dev}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if not 1 <= n_cand <= n - mcnt or mcnt < 0:
        raise ValueError(f"need 1 <= W <= n - mcnt, got W = {n_cand}, n = {n}, "
                         f"mcnt = {mcnt}")
    if phase == 1 and len(own[0]) > n_cand:
        raise ValueError(f"{len(own[0])} own candidates of a window of {n_cand}")


def _row_bytes(counts: torch.Tensor, row: int, words: int) -> torch.Tensor:
    """Row `row`'s counts as `words` int64 words of their bytes (zero
    padded), as the kernel packs a seed slot."""
    raw = torch.zeros(8 * words, dtype=torch.uint8, device=counts.device)
    b = counts[row].contiguous().view(torch.uint8)
    raw[:len(b)] = b
    return raw.view(torch.int64)


def _bytes_row(words: torch.Tensor, d: int, dtype) -> torch.Tensor:
    """The d counts of type `dtype` packed in int64 `words`, as int64."""
    raw = words.contiguous().view(torch.uint8)
    if dtype == torch.uint16:   # no uint16 arithmetic: as int16 and masked
        return raw[:2 * d].view(torch.int16).to(torch.int64) & 0xFFFF
    return raw[:d].to(torch.int64)


def step_exchange_ref(blk: RowBlock, order, cand, own_pos, own_rows, own_stats, own_dec, *,
                      pos_edge: float, rank: int, n_ranks: int, xbuf: torch.Tensor) -> None:
    """Phase 1 of the block mode in plain PyTorch: the exchange xbuf
    (step_xbuf_len words) from the rank's k own candidates (window
    positions own_pos, rising; block rows own_rows; their statistics [k, 3]
    and decisions [5, k] from the fused kernel's center form)."""
    counts = blk.counts
    n_cand, d = len(cand), counts.shape[1]
    sw = seed_slot(d, counts.element_size())
    x = xbuf[:step_xbuf_len(n_cand, d, counts.element_size(), n_ranks)]
    x.zero_()
    x[:3 * n_cand].view(n_cand, 3)[own_pos] = own_stats
    x[3 * n_cand:7 * n_cand].view(4, n_cand)[:, own_pos] = own_dec[[0, 2, 3, 4]].view(
        torch.int64)
    pos = torch.nonzero(own_dec[0] >= pos_edge).view(-1)
    for c in range(0, len(pos), _REF_CHUNK):
        x[7 * n_cand:7 * n_cand + d] += _rows_i64(counts, own_rows[pos[c:c + _REF_CHUNK]]).sum(
            dim=0)
    if len(own_pos):
        best = int(torch.argmax(own_dec[2]))   # the first maximum
        slot = x[7 * n_cand + d + rank * sw:7 * n_cand + d + (rank + 1) * sw]
        slot[0] = own_pos[best] + 1
        slot[1:] = _row_bytes(counts, int(own_rows[best]), sw - 1)


def window_step_block_ref(phase: int, blk: RowBlock, order, cand, state: StepState, cur_d,
                          *, cid: int, stepc: int, mcnt: int, pos_edge: float,
                          margin: float, tie_margin: float, tie: int, trip: torch.Tensor,
                          xbuf: Optional[torch.Tensor] = None, rank: int = 0,
                          n_ranks: int = 1, own=None, rank_part=None,
                          parts: Optional[torch.Tensor] = None) -> None:
    """One phase of the block mode in plain PyTorch, on the CPU: phase 1
    `step_exchange_ref` (own = (own_pos, own_rows, own_stats, own_dec));
    phase 2 from the all-reduced exchange the decisions and the case
    (`_decide`, `_absorb_case`, `_min_case`), msum (+= the column sums, or
    the seed's row from its owner's slot), and `block_partials_ref` over the
    block's members into `rank_part`; phase 3 `pick_ref` over `parts`.
    `trip` (int64 [4]) as the kernel's.  Runs on any device (the wrapper
    runs it on the CPU)."""
    counts = blk.counts
    n_cand, d = len(cand), counts.shape[1]
    i64 = dict(dtype=torch.int64, device=cand.device)
    if phase == 1:
        step_exchange_ref(blk, order, cand, *own, pos_edge=pos_edge, rank=rank,
                          n_ranks=n_ranks, xbuf=xbuf)
        return
    if phase == 3:
        bits, npos = int(trip[0]), int(trip[1])
        if bits == 0 and npos > 0:
            count = mcnt + npos
            first, unc = pick_ref(parts[:, None], count, tie_margin)
            f, u = int(first[0]), bool(unc[0])
            trip[2] = int(u)
            trip[3] = int(cur_d[0]) if u or f >= count else int(state.members[f])
        return
    x = xbuf
    stats = x[:3 * n_cand].view(n_cand, 3)
    s, dist, s_err, dist_err = x[3 * n_cand:7 * n_cand].view(torch.float64).view(4, n_cand)
    colsum = x[7 * n_cand:7 * n_cand + d]
    rows = order[cand]
    pos, bits_t, best = _decide(counts, rows, s, dist, stats, tuple(blk[1:5]),
                                pos_edge=pos_edge, margin=margin, tie_margin=tie_margin,
                                s_err=s_err, dist_err=dist_err, full=False, keys=tie)
    bits, npos = int(bits_t), int(pos.sum())
    absorb, is_min = bits == 0 and npos > 0, bits == 0 and npos == 0
    seed = cand[best.clamp(max=n_cand - 1)]
    was = int(cur_d[0])
    _absorb_case(state, cand, pos & absorb, cid, stepc, mcnt)
    _min_case(state, seed, torch.tensor(is_min, device=cand.device), cid, stepc)
    if is_min:
        sw = seed_slot(d, counts.element_size())
        seeds = x[7 * n_cand + d:7 * n_cand + d + n_ranks * sw].view(n_ranks, sw)
        owner = torch.nonzero(seeds[:, 0] == best + 1).view(-1)
        if len(owner):
            state.msum.copy_(_bytes_row(seeds[int(owner[0]), 1:], d, counts.dtype))
    if absorb:
        count = mcnt + npos
        new_sum = state.msum + colsum
        rank_part.copy_(block_partials_ref(
            blk, order[state.members[:count]], torch.zeros(count, **i64),
            torch.ones(count, dtype=torch.bool, device=cand.device), 1, new_sum[None],
            torch.tensor([count], **i64))[0])
        state.msum.copy_(new_sum)
    trip.copy_(torch.tensor([bits, npos, 0, int(seed) if is_min else was], **i64))


def window_step_block(phase: int, blk: RowBlock, order: torch.Tensor, cand: torch.Tensor,
                      state: StepState, cur_d: torch.Tensor, *, cid: int, stepc: int,
                      mcnt: int, pos_edge: float, margin: float, tie_margin: float,
                      tie: int, scratch: torch.Tensor, xbuf: Optional[torch.Tensor] = None,
                      rank: int = 0, n_ranks: int = 1, own_pos=None, own_rows=None,
                      own_stats=None, own_dec=None, rank_part=None,
                      parts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One phase (1, 2 or 3) of the step on rank `rank` of `n_ranks` over a
    row-sharded store (module docstring): `blk` holds the rank's rows,
    `order` maps flat positions to store rows, the window's candidates
    `cand`, state, cur_d and `tie` are window_step's, with no `full` (a
    model with full-vector singles needs rows for its tie guard).

    Phase 1 writes the exchange `xbuf` (int64 [step_xbuf_len(W, D, count
    size, n_ranks)]) from the rank's own candidates: own_pos (int64 [k],
    their window positions, rising), own_rows (int64 [k], their rows in the
    block), own_stats (int64 [k, 3]) and own_dec (float64 [5, k]), the
    fused kernel's center form over them; the caller all-reduces xbuf
    (SUM).  Phase 2 reads it, applies the step to the state and writes the
    rank's closest-to-mean partial into `rank_part` (int64 [6]), which the
    caller all-gathers into `parts` (int64 [n_ranks, 6]) for phase 3.
    Returns the trip, a view of `scratch` (step_scratch(n)), complete after
    phase 3.

    On CUDA one launch of csrc/window_absorb.cu's block mode a phase, on
    the current stream, without syncing; on the CPU window_step_block_ref."""
    k = 0 if own_pos is None else len(own_pos)
    dev = blk.counts.device
    if phase == 1 and k == 0:   # no own candidate: empty views
        own_pos = own_rows = torch.zeros(0, dtype=torch.int64, device=dev)
        own_stats = torch.zeros((0, 3), dtype=torch.int64, device=dev)
        own_dec = torch.zeros((5, 0), dtype=torch.float64, device=dev)
    own = (own_pos, own_rows, own_stats, own_dec)
    _check_block(phase, blk, order, cand, state, cur_d, mcnt, scratch,
                 None if xbuf is None else xbuf[:step_xbuf_len(
                     len(cand), blk.counts.shape[1], blk.counts.element_size(), n_ranks)],
                 rank, n_ranks, own, rank_part, parts)
    kw = dict(cid=int(cid), stepc=int(stepc), mcnt=int(mcnt), pos_edge=float(pos_edge),
              margin=float(margin), tie_margin=float(tie_margin))
    counts = blk.counts
    if counts.device.type == "cpu":
        window_step_block_ref(phase, blk, order, cand, state, cur_d, trip=scratch[:4],
                              xbuf=xbuf, rank=rank, n_ranks=n_ranks, own=own,
                              rank_part=rank_part, parts=parts, tie=tie, **kw)
        return scratch[:4]
    n = len(order)
    lib = _lib()
    need = lib.mc2_window_step_scratch_len(n)
    if phase == 2 and scratch.numel() < need:
        raise ValueError(f"scratch must be int64 [>= {need}] on {counts.device}")
    ptr = lambda t: t.data_ptr() if t is not None else None
    stream = torch.cuda.current_stream(counts.device).cuda_stream
    with torch.cuda.device(counts.device):
        rc = getattr(lib, _BLOCK_ENTRY[counts.dtype])(
            counts.data_ptr(), counts.shape[1], blk.mags.data_ptr(),
            blk.selfdot.data_ptr(), blk.lens.data_ptr(), blk.stddevs.data_ptr(),
            order.data_ptr(), cand.data_ptr(), len(cand), kw["pos_edge"], kw["margin"],
            kw["tie_margin"], int(blk.maxc), *(t.data_ptr() for t in state),
            cur_d.data_ptr(), kw["cid"], kw["stepc"], kw["mcnt"], scratch.data_ptr(),
            scratch.numel(), n, int(blk.lo), int(blk.hi), int(phase), ptr(own_pos),
            ptr(own_rows), k, ptr(own_stats), ptr(own_dec), ptr(xbuf),
            xbuf.numel() if xbuf is not None else 0, int(rank), int(n_ranks),
            ptr(rank_part), ptr(parts), int(tie), stream)
    if rc != 0:
        raise RuntimeError(f"window_step block kernel launch failed (phase {phase}): "
                           f"cudaError {rc}")
    window_step_block.launches += 1
    return scratch[:4]


window_step_block.launches = 0  # kernel launches since the last reset


def own_candidates(blk: RowBlock, order, cand, stats, dec):
    """(own_pos, own_rows, own_stats, own_dec) of the window's candidates
    whose rows the block holds, from the whole window's statistics [W, 3]
    and decisions [5, W] (what the rank's center form gives for them)."""
    rows = order[cand]
    pos = torch.nonzero((rows >= blk.lo) & (rows < blk.hi)).view(-1)
    return pos, rows[pos] - blk.lo, stats[pos].contiguous(), dec[:, pos].contiguous()


def window_step_blocks(blocks, states, scratches, xbufs, order, cand, s, dist, stats,
                       cur_ds, **kw):
    """The step over G row blocks in one process, as G ranks run it: each
    block's phase 1 from its own candidates (`own_candidates` of the
    window's statistics and decisions) into its exchange `xbufs[g]`; the
    exchanges summed and given to every block, as the all-reduce gives them;
    each block's phase 2 with its own state copy and scratch; the partials
    stacked, as the all-gather stacks them; each block's phase 3.  cur_ds[g]
    is block g's center (its own trip's last entry or a tensor of its own).
    Returns each block's trip."""
    G = len(blocks)
    dev = blocks[0].counts.device
    rank_parts = [torch.zeros(PART, dtype=torch.int64, device=dev) for _ in range(G)]
    s_err, dist_err = kw.pop("s_err"), kw.pop("dist_err")
    dec = torch.stack([s, torch.zeros_like(s), dist, s_err, dist_err])
    L = step_xbuf_len(len(cand), blocks[0].counts.shape[1], blocks[0].counts.element_size(),
                      G)
    for g in range(G):
        pos, rows, st, dc = own_candidates(blocks[g], order, cand, stats, dec)
        window_step_block(1, blocks[g], order, cand, states[g], cur_ds[g],
                          scratch=scratches[g], xbuf=xbufs[g], rank=g, n_ranks=G, own_pos=pos,
                          own_rows=rows, own_stats=st, own_dec=dc, **kw)
    total = torch.stack([x[:L] for x in xbufs]).sum(dim=0)
    for g in range(G):
        xbufs[g][:L].copy_(total)
        window_step_block(2, blocks[g], order, cand, states[g], cur_ds[g],
                          scratch=scratches[g], xbuf=xbufs[g], rank=g, n_ranks=G,
                          rank_part=rank_parts[g], **kw)
    gathered = torch.stack(rank_parts)
    return [window_step_block(3, blocks[g], order, cand, states[g], cur_ds[g],
                              scratch=scratches[g], rank=g, n_ranks=G, parts=gathered, **kw)
            for g in range(G)]
