"""The device session over a row-sharded store: the port of
meshclust2_tpu/parallel/multihost_session.py:build_multihost_session (l.
24-88).

The JAX package builds its single-device session's programs over the
global mesh and lets GSPMD partition them: counts P(axis, None), per-row
arrays P(axis), loop state replicated, the collectives where XLA puts them.
The port writes that partition out.  Each rank holds

  - its sorted row block (multihost.py:build_global_points), with one more
    row, the accumulate loop's center slot, and for the update phase a
    tail of one row a cluster slot, the current centers' rows;
  - the per-row moments of every row (mags, selfdot, lens, stddevs: 32
    bytes a row) and the loop state, the same on every rank.

The accumulate loop (`ShardedAccumulator`) is the port's host-driven step
loop (cluster/device_loop.py) with, each step: the center's row
broadcast from its owner into every rank's slot; the center form of the
fused pair-statistics kernel on the candidates the rank owns; then the
step kernel's block mode (ops/window_absorb.py:window_step_block): its
phase 1 writes the exchange from those candidates alone (their statistics
and decisions at their window positions, their positives' column sums,
the rank's first maximum's row; each value one rank's, the others add
zeros: exact), one all-reduce, its phase 2 decides the window and applies
the step, one all-gather of the closest-to-mean partials, phase 3 picks.
Two collectives a step.  A step without candidates seeds its cluster with
the seed's row, all-reduced from its owner.  The window bounds and the one
read a step stay as they are: every rank computes them alike.

The update phase (`ShardedPhase`) is the port's TorchDevicePhaseUpdater
with, each iteration: the layout and the replay on every rank alike (slot
metadata only); the filter's pairs that a rank's block holds the member of
scored by the pair form against the center rows in its tail;
closest_candidates' block mode (ops/phase.py:closest_candidates_block):
its phase 1 writes the exchange (those pairs' keep and uncertainty bits
and the column sums of the rank's kept rows per segment, int32 where the
sums fit), one all-reduce, phase 2, one all-gather of the partials, phase
3; the new centers' rows gathered into every rank's tail, one all-reduce of
their bytes (each row is one rank's); the merge decisions on every rank
alike over the tail (both rows of a merge candidate are centers), so they
need no collective.  Three collectives a pass.

On a one-rank mesh the block modes are the one-block case, bit for bit the
one-launch kernels, and the collectives are no-ops: the session there is
`OneRankAccumulator` and the single-device TorchDevicePhaseUpdater over the
rank's block, which holds every row at its own index (window_step,
closest_candidates), and launches what the single-device session
launches.

Every collective's inputs come from replicated values and every rank takes
the same branches, so the collectives stay in step.  A guarded abort
resumes on the host as on one device: the engine's host steps score through
MultihostScorer and fetch the rows they need (`updater` is None, as in the
JAX session).  A session that raises fails the run (`no_fallback`): a rank
that fell back alone would leave its peers at a collective.
"""
from __future__ import annotations

from collections import Counter
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..cluster.bvec import BVec
from ..cluster.device_loop import DeviceLoopUnsupported, TorchDeviceAccumulator
from ..cluster.device_phase import TorchDevicePhaseUpdater
from ..cluster.device_session import BIN_SIZE
from ..cluster.device_store import DeviceStore
from ..cluster.device_update import TorchDeviceUpdater
from ..ops import window_select
from ..ops.closest_mean import PART, RowBlock
from ..ops.pair_stats import has_vector, pair_stats_decision
from ..ops.phase import (PhaseState, closest_candidates_block, exchange_dtype,
                         exchange_words)
from ..ops.window_absorb import (StepState, _rows_i64, step_scratch, step_xbuf_len,
                                 window_step_block)
from .mesh import Mesh, all_gather, block_bounds


class Collectives:
    """The three collectives of the session over the mesh, each counted
    where it communicates (`sums`, `gathers`, `broadcasts`); a one-rank
    mesh runs none of them (the same bits)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.sums = self.gathers = self.broadcasts = 0

    @property
    def calls(self) -> int:
        return self.sums + self.gathers + self.broadcasts

    def sum_(self, t: torch.Tensor) -> None:
        """All-reduce SUM in place (every position one rank's, the others
        zero, in every use here: exact for any dtype as bytes)."""
        if self.mesh.world > 1 and t.numel():
            dist.all_reduce(t)
            self.sums += 1

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's `t`, stacked in rank order: [world, *t.shape]."""
        if self.mesh.world == 1:
            return t[None].contiguous()
        if not t.numel():
            return t.new_zeros((self.mesh.world,) + tuple(t.shape))
        self.gathers += 1
        return all_gather(self.mesh, t[None])

    def broadcast(self, t: torch.Tensor, src: int) -> None:
        """`t` from rank src into every rank's, in place."""
        if self.mesh.world > 1:
            dist.broadcast(t, src)
            self.broadcasts += 1


class ShardedRows:
    """A rank's rows of the row-sharded store: the block `counts` [hi - lo,
    D] of store rows [lo, hi) (block_bounds over n), every row's moments
    (float64 [n] each) and the pool's largest count."""

    def __init__(self, mesh: Mesh, counts: torch.Tensor, moments: torch.Tensor, maxc: int):
        self.mesh = mesh
        self.n = moments.shape[1]
        self.lo, self.hi, self.rows = block_bounds(self.n, mesh.world, mesh.rank)
        if counts.shape[0] < self.hi - self.lo:
            raise ValueError(f"the block holds {counts.shape[0]} rows, not {self.hi - self.lo}")
        self.counts = counts
        self.moments = moments          # [4, n]: mags, selfdot, lens, stddevs
        self.maxc = int(maxc)

    def block(self, counts: Optional[torch.Tensor] = None) -> RowBlock:
        """The RowBlock of `counts` (the block's rows first; by default the
        block itself)."""
        return RowBlock(self.counts if counts is None else counts, *self.moments,
                        self.maxc, self.lo, self.hi)

    def owner(self, row: int) -> int:
        return row // self.rows

    def owned_rows(self, rows: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        """`out` [len(rows), D] as bytes: each row's counts where this rank
        holds it, zeros elsewhere, ready for an all-reduce SUM."""
        own = (rows >= self.lo) & (rows < self.hi)
        width = out.shape[1]
        if self.hi > self.lo:
            src = self.counts.view(torch.uint8).view(self.counts.shape[0], width)
            got = src[(rows - self.lo).clamp(0, self.hi - self.lo - 1)]
            out.copy_(got * own[:, None].to(torch.uint8))
        else:
            out.zero_()
        return out


def _check_model(params) -> None:
    if has_vector(params):
        raise DeviceLoopUnsupported("the block modes take no full-vector single (their "
                                    "tie guards compare rows)")


class OneRankAccumulator(TorchDeviceAccumulator):
    """The accumulate loop of a one-rank mesh: `store` is the rank's block
    with its center slot (mesh_scorer.py:block_store), every row at its own
    index, so the single-device step runs on it; `fetch` serves the host's
    rows."""

    # the session fails the run rather than fall back: on two or more ranks
    # a rank that fell back to the host alone would wait at a collective
    no_fallback = True

    def __init__(self, meta, model, sim: float, store, fetch):
        super().__init__(meta, model, sim, store)
        _check_model(self.params)
        self._fetch = fetch

    def _rows_host(self, rows: np.ndarray) -> np.ndarray:
        return self._fetch(np.asarray(rows, dtype=np.int64))


class ShardedAccumulator(OneRankAccumulator):
    """The accumulate loop over a row-sharded store of two or more ranks
    (module docstring).  `store` is the rank's block with its center slot.
    `block_steps` counts the steps through the block mode,
    `step_collectives` how many steps made how many collectives after the
    center's broadcast."""

    def __init__(self, meta, model, sim: float, rows: ShardedRows, store, fetch,
                 coll: Collectives):
        super().__init__(meta, model, sim, store, fetch)
        self.rows = rows
        self.coll = coll
        self._slot = store.counts.shape[0] - 1
        self._slot_row = -1
        self._blk = rows.block(store.counts)
        self.block_steps = 0
        self.step_collectives: Counter = Counter()

    def _warm(self) -> None:
        """The rank's buffers, the window's kernel once, then each phase of
        the block mode once on a throwaway one-row pool of a row the rank
        holds, as a one-rank exchange (no collective)."""
        self.block_steps = 0
        self.step_collectives = Counter()
        n = len(self._s["order"])
        dev, d = self.device, self.store.counts.shape[1]
        size = self.store.counts.element_size()
        i64 = dict(dtype=torch.int64, device=dev)
        order = self._s["order"]
        self._own = (order >= self.rows.lo) & (order < self.rows.hi)
        self._own_k = 0
        self._rank_part = torch.zeros(PART, **i64)
        self._xbuf = torch.zeros(step_xbuf_len(n, d, size, self.coll.mesh.world), **i64)
        self._slot_t = torch.tensor([self._slot], **i64)
        self._slot_row = -1
        if self._sel is not None:
            window_select.warm(self.store.counts)
        if self.rows.hi == self.rows.lo:
            return
        one = torch.tensor([self.rows.lo], **i64)
        z = torch.zeros(1, **i64)
        stats, dec = pair_stats_decision(self.store, self.params, z, z)
        state = StepState(torch.ones(1, dtype=torch.bool, device=dev), z - 1, z.clone(),
                          torch.zeros(2, **i64), torch.zeros(d, **i64))
        rank_part = torch.zeros(PART, **i64)
        kw = dict(scratch=step_scratch(1, dev), xbuf=torch.zeros(step_xbuf_len(1, d, size, 1),
                                                                 **i64),
                  own_pos=z, own_rows=z, own_stats=stats, own_dec=dec, rank_part=rank_part,
                  parts=rank_part[None], **self._step_kw(0, 1, 0))
        for phase in (1, 2, 3):
            window_step_block(phase, self._blk, one, z, state, z, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _select_kernel(self):
        """The window's kernel with the rank's own candidates: their window
        positions into _own_pos, their block rows into _own_rows (slot n of
        each the plain twin's scatter sink)."""
        n = len(self._s["order"])
        self._own_pos = torch.zeros(n + 1, dtype=torch.int64, device=self.device)
        self._own_rows = torch.zeros(n + 1, dtype=torch.int64, device=self.device)
        return super()._select_kernel(rows=(self.rows.lo, self.rows.hi),
                                      own=(self._own_pos, self._own_rows))

    def _step_kw(self, cid: int, stepc: int, mcnt: int) -> dict:
        return dict(cid=cid, stepc=stepc, mcnt=mcnt, pos_edge=self.pos_edge,
                    margin=self.margin, tie_margin=self.tie_margin, tie=self.tie)

    def run(self, bv, carry=None):
        # the scorer's host steps between runs may have reused the slot
        self._slot_row = -1
        return super().run(bv, carry)

    def _window_extra(self, mask: torch.Tensor, csum: torch.Tensor) -> list:
        """The rank's own candidates: their window positions into _own_pos,
        their block rows into _own_rows; their count goes with the read."""
        n = len(self._own)
        own = mask & self._own
        ocs = torch.cumsum(own, 0, dtype=torch.int64)
        at = torch.where(own, ocs - 1, n)
        self._own_pos.scatter_(0, at, csum - 1)
        self._own_rows.scatter_(0, at, self._s["order"] - self.rows.lo)
        return [ocs[-1:]]

    def _take_extra(self, values: list) -> None:
        self._own_k = int(values[0])

    def _center(self, cur: int) -> None:
        """Row order[cur]'s counts from its owner into every rank's slot, its
        moments from the replicated ones."""
        row = int(self._ready[0]["order"][cur])
        if row == self._slot_row:
            return
        rows, st = self.rows, self.store
        if rows.lo <= row < rows.hi:
            st.counts[self._slot] = st.counts[row - rows.lo]
        self.coll.broadcast(st.counts[self._slot].view(torch.uint8), rows.owner(row))
        for m, t in zip(rows.moments, (st.mags, st.selfdot, st.lens, st.stddevs)):
            t[self._slot] = m[row]
        self._slot_row = row

    def _scan(self, n_cand: int, cur_d: torch.Tensor, cid: int, stepc: int,
              mcnt: int, cur: int) -> torch.Tensor:
        """One step over the window's n_cand candidates on the sharded store
        (module docstring): the rank's candidates through the center form,
        then the block mode's three phases around the exchange's all-reduce
        and the partials' all-gather."""
        self._center(cur)
        calls = self.coll.calls
        mesh = self.coll.mesh
        k = self._own_k
        stats = dec = None
        if k:
            stats, dec = pair_stats_decision(self.store, self.params, self._own_rows[:k],
                                             self._slot_t)
        state = StepState(self._alive, self._assign, self._astep, self._members,
                          self._msum)
        args = (self._blk, self._s["order"], self._cand[:n_cand], state, cur_d)
        kw = dict(scratch=self._scratch, xbuf=self._xbuf, rank=mesh.rank,
                  n_ranks=mesh.world, **self._step_kw(cid, stepc, mcnt))
        window_step_block(1, *args, own_pos=self._own_pos[:k], own_rows=self._own_rows[:k],
                          own_stats=stats, own_dec=dec, **kw)
        counts = self.store.counts
        self.coll.sum_(self._xbuf[:step_xbuf_len(n_cand, counts.shape[1],
                                                 counts.element_size(), mesh.world)])
        window_step_block(2, *args, rank_part=self._rank_part, **kw)
        trip = window_step_block(3, *args, parts=self.coll.gather(self._rank_part), **kw)
        self.block_steps += 1
        self.step_collectives[self.coll.calls - calls] += 1
        return trip

    def _seed(self, seed: torch.Tensor, cid: int, stepc: int) -> None:
        """A step without candidates: the seed leaves the pool and opens
        cluster cid alone; msum is its row where the rank owns it, zeros
        elsewhere (`_seed_sum` adds the ranks' parts)."""
        self._alive[seed] = False
        self._assign[seed] = cid
        self._astep[seed] = stepc
        self._members[:1] = seed
        rows = self.rows
        row = self._s["order"][seed]
        own = ((row >= rows.lo) & (row < rows.hi)).to(torch.int64)
        local = (row - rows.lo).clamp(0, self.store.counts.shape[0] - 1)
        self._msum.copy_((_rows_i64(self.store.counts, local) * own[:, None])[0])

    def _seed_sum(self) -> None:
        self.coll.sum_(self._msum)


class ShardedPhase(TorchDevicePhaseUpdater):
    """The update phase over a row-sharded store of two or more ranks
    (module docstring).  Its store is the rank's block with a tail of one
    row a cluster slot, built at a run's start; `updater` (the decisions)
    works on it.  `block_passes` counts the passes through the block mode,
    `pass_collectives` how many passes made how many collectives."""

    def __init__(self, meta, model, sim: float, rows: ShardedRows, coll: Collectives,
                 delta: int = 5, iterations: int = 15):
        self.rows = rows
        self.coll = coll
        self.model = model
        self._tail = 0
        self.block_passes = 0
        self.pass_collectives: Counter = Counter()
        super().__init__(meta, model, sim, self._store(1), delta=delta,
                         iterations=iterations)
        _check_model(self.updater.params)

    def _store(self, tail: int):
        """The rank's block with `tail` more rows (the tail's moments filled
        in by _gather_tail)."""
        rows = self.rows
        nb = rows.hi - rows.lo
        counts = torch.zeros((nb + tail, rows.counts.shape[1]), dtype=rows.counts.dtype,
                             device=rows.counts.device)
        counts[:nb] = rows.counts[:nb]
        self._mom = torch.zeros((4, nb + tail), dtype=torch.float64, device=counts.device)
        self._mom[:, :nb] = rows.moments[:, rows.lo:rows.hi]
        store = DeviceStore(counts, *self._mom, maxc=rows.maxc)
        self._tail = tail
        self._blk = rows.block(store.counts)
        return store

    def warm_up(self) -> None:
        super().warm_up()
        self.block_passes = 0
        self.pass_collectives = Counter()

    def _begin(self, cur: PhaseState) -> None:
        """A store whose tail fits the state's slots, the run's buffers, and
        the current centers' rows gathered into the tail."""
        S, n = len(cur.cen), len(cur.assign)
        if S > self._tail:
            self.store = self._store(S)
            self.updater = TorchDeviceUpdater(self.model, self.store, self.margin,
                                              self.tie_margin)
        dev, d = self.device, self.store.counts.shape[1]
        i64 = dict(dtype=torch.int64, device=dev)
        bound = (2 * self.delta + 1) * n
        self._bound = torch.arange(bound, **i64)
        self._own_pos = torch.zeros(bound + 1, **i64)   # slot bound a sink
        self._own_cs = torch.zeros(bound, **i64)
        self._own_k = 0
        # the exchange at its widest: int64 words, viewed as int32 where the
        # sums fit
        self._xbuf = torch.zeros(exchange_words(bound, S, d), **i64)
        self._rank_part = torch.zeros((S, PART), **i64)
        width = d * self.store.counts.element_size()
        self._bytes = torch.zeros((S, width), dtype=torch.uint8, device=dev)
        self._gather_tail(cur.cen)

    def _gather_tail(self, cen: torch.Tensor) -> None:
        """Slot s's center row cen[s] into tail row s on every rank: each
        row from its owner, one all-reduce of the bytes; its moments from
        the replicated ones."""
        rows = self.rows
        nb = rows.hi - rows.lo
        S = len(cen)
        got = rows.owned_rows(cen, self._bytes[:S])
        self.coll.sum_(got)
        counts = self.store.counts
        counts[nb:nb + S] = got.view(counts.dtype).view(S, counts.shape[1])
        self._mom[:, nb:nb + S] = rows.moments[:, cen]

    def _layout_extra(self, lay) -> list:
        """The layout's pairs whose member this rank holds: their positions
        into _own_pos, their running count into _own_cs; their count goes
        with the read."""
        bound = len(self._bound)
        b = lay.b_rows[:bound]
        own = (self._bound < lay.hdr[1]) & (b >= self.rows.lo) & (b < self.rows.hi)
        torch.cumsum(own, 0, dtype=torch.int64, out=self._own_cs)
        self._own_pos.scatter_(0, torch.where(own, self._own_cs - 1, bound), self._bound)
        return [self._own_cs[-1:]]

    def _take_extra(self, values: list) -> None:
        self._own_k = int(values[0])

    def _filter(self, cur: PhaseState, rows, delta: int, lay, n_alive: int,
                n_pairs: int, cand, final: bool = False):
        """The filter over the rank's pairs against the tail's centers, then
        closest_candidates' block mode: its exchange (the filter's bits and
        the kept rows' column sums) all-reduced, its partials all-gathered;
        then the new centers' rows into the tail."""
        calls = self.coll.calls
        dev = self.device
        nb = self.rows.hi - self.rows.lo
        k = self._own_k
        if k:
            pos = self._own_pos[:k]
            a = nb + lay.inv[lay.seg[pos]]            # the center's tail row
            keep_o, unc_o = self.updater.filter_keep(a, lay.b_rows[pos] - self.rows.lo)
        else:
            keep_o = unc_o = torch.zeros(0, dtype=torch.bool, device=dev)
        C, d = n_alive, self.store.counts.shape[1]
        x = self._xbuf
        if exchange_dtype(n_pairs, self.rows.maxc) == torch.int32:
            x = x.view(torch.int32)
        x = x[:exchange_words(n_pairs, C, d)]
        args = (self._blk, cur, rows, delta, lay, n_alive, n_pairs, cand)
        kw = dict(tie_margin=self.tie_margin, final=final)
        closest_candidates_block(1, *args, xbuf=x, own_cs=self._own_cs, own_keep=keep_o,
                                 own_unc=unc_o, **kw)
        self.coll.sum_(x)
        nw = -(-n_pairs // 32)
        unc = x[nw:2 * nw].any().view(1)            # the filter's uncertainty
        closest_candidates_block(2, *args, xbuf=x, rank_part=self._rank_part, **kw)
        _, cunc = closest_candidates_block(
            3, *args, parts=self.coll.gather(self._rank_part[:C]), **kw)
        self._gather_tail(cand.cen)
        self.block_passes += 1
        self.pass_collectives[self.coll.calls - calls] += 1
        return unc, cunc.any().view(1)

    def _merge(self, cand, lay, m: int, n_alive: int):
        """The merge decisions over the tail rows of the new centers: the
        candidate at position i delta + q - 1 pairs rank i + q's with rank
        i's (positions past C are masked by cand.ok)."""
        nb = self.rows.hi - self.rows.lo
        x = self._bound[:m]
        i = torch.div(x, self.delta, rounding_mode="floor")
        j = (i + x % self.delta + 1).clamp(max=n_alive - 1)
        return self.updater.merge_device(nb + lay.inv[j], nb + lay.inv[i], cand.seg[:m],
                                         n_alive, valid=cand.ok[:m])


class MultihostSession:
    """The TorchDeviceSession surface the engine reads (`accumulator`,
    `phase`, `updater`, `scorer`, `bv`) over a row-sharded store."""

    def __init__(self, accumulator, phase, scorer, bv):
        self.accumulator = accumulator
        self.phase = phase
        self.updater = None      # an aborted phase resumes through the scorer
        self.scorer = scorer
        self.bv = bv


def build_multihost_session(meta, model, sim: float, mesh: Mesh, store, fetch,
                            scorer, delta: int = 5, iterations: int = 15
                            ) -> MultihostSession:
    """The session over the row-sharded store of build_global_points:
    `store` is the rank's block with its center slot, `meta` the replicated
    metadata (self_dots, maxc), `fetch` the host's rows, `scorer` the
    MultihostScorer of the engine's host steps.  Uploads the moments, builds
    the kernels and warms the loop and the phase (collective calls: every
    rank builds its session at once); one rank's is the single-device
    accumulator and phase over its block.  Raises DeviceLoopUnsupported
    for a model with full-vector singles."""
    dev = mesh.device
    moments = torch.from_numpy(np.stack([
        np.asarray(a, dtype=np.float64)
        for a in (meta.mags, meta.self_dots, meta.lengths, meta.stddevs)])).to(dev)
    lo, hi, _ = block_bounds(meta.n, mesh.world, mesh.rank)
    rows = ShardedRows(mesh, store.counts[:hi - lo], moments, meta.maxc)
    coll = Collectives(mesh)
    bv = BVec(meta.lengths, BIN_SIZE)
    bv.insert_all(meta.lengths)
    bv.insert_finalize(meta.lengths)
    if mesh.world == 1:
        acc = OneRankAccumulator(meta, model, sim, store, fetch)
        phase = TorchDevicePhaseUpdater(meta, model, sim, store, delta=delta,
                                        iterations=iterations)
    else:
        acc = ShardedAccumulator(meta, model, sim, rows, store, fetch, coll)
        phase = ShardedPhase(meta, model, sim, rows, coll, delta=delta,
                             iterations=iterations)
    acc.ensure_ready(bv)
    phase.warm_up()
    return MultihostSession(acc, phase, scorer, bv)


def pointset_session(ps, model, sim: float, mesh: Mesh, delta: int = 5,
                     iterations: int = 15):
    """(session, fetch) over a PointSet that every rank holds whole, its
    rows sharded as build_global_points shards them: the rank keeps its
    block of ps.counts on mesh.device and fetches the host's rows from the
    owners (graft_entry.dryrun_multichip's sections 6 and 7)."""
    from .multihost import MultihostScorer, RowFetch, kernel_store

    ps.self_dots = np.einsum("ij,ij->i", ps.counts.astype(np.int64),
                             ps.counts.astype(np.int64))
    ps.maxc = int(ps.counts.max()) if ps.n else 0
    lo, hi, _ = block_bounds(ps.n, mesh.world, mesh.rank)
    block = torch.from_numpy(np.ascontiguousarray(ps.counts[lo:hi])).to(mesh.device)
    store, m = kernel_store(ps, block, mesh)
    fetch = RowFetch(mesh, store.counts, ps.n)
    scorer = MultihostScorer(ps, model, mesh, store, m, fetch)
    return build_multihost_session(ps, model, sim, mesh, store, fetch, scorer,
                                   delta=delta, iterations=iterations), fetch
