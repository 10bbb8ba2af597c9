"""The engine's Scorer protocol over the process mesh: the port of
meshclust2_tpu/parallel/mesh_scorer.py:MeshScorer (l. 40-335).

Each rank holds its contiguous row block (mesh.py:block_bounds) in the
port's DeviceStore layout, with one more row: the slot of the center.  A
call with one center broadcasts the center's row and moments from the rank
that owns it into every rank's slot, each rank runs the center form of the
fused pair-statistics kernel (ops/pair_stats.py:pair_stats_decision,
csrc/pair_stats.cu) on the called rows it holds, and the (prob, dist,
s_err, dist_err) of every rank are all-gathered (`score_center_all` calls it
with every row).  A mixed-center batch (the merge pass, the update filter)
shards its pairs over the ranks with the unique rows replicated in a small
store of their own, through the pair form of the same kernel; a batch with
more than MAX_PAIR_UNIQUE_ROWS unique rows is halved until each part fits
(where the JAX scorer sends it to the host oracle), so every pair is scored
by the kernel.

Decisions are re-checked as the port's single-device scorer re-checks them
(ops/device_features.py:recheck_rules, rules (i)-(iii) with the kernel's
error bounds), not by the JAX float32 margins: the kernel's epilogue is
float64 and those rules make the decisions the host oracle's.  Every rank
holds the same gathered values and takes the same branches, so collectives
stay in step.

MESH_SUPPORTED is the JAX package's set, so the port takes no model that
the JAX mesh scorer refuses (`create` returns None).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..cluster.device_store import DeviceStore, store_refusal
from ..cluster.engine import HostScorer
from ..features import flags as F
from ..model.classifier import model_to_torch
from ..ops.device_features import recheck_rules
from ..ops.pair_stats import pair_stats_decision
from .mesh import Mesh, all_gather, block_bounds, gather_rows, make_mesh

MESH_SUPPORTED = frozenset({
    F.FEAT_MANHATTAN, F.FEAT_EUCLIDEAN, F.FEAT_INTERSECTION,
    F.FEAT_KULCZYNSKI2, F.FEAT_SIMRATIO, F.FEAT_NORMALIZED_VECTORS,
    F.FEAT_PEARSON_COEFF, F.FEAT_D2z, F.FEAT_EUCLIDEAN_Z, F.FEAT_EMD,
    F.FEAT_LENGTHD,
})


def moments(mags, self_dots, lengths, stddevs) -> np.ndarray:
    """float64 [rows, 4]: a row's moments in the store's order (mags,
    selfdot, lens, stddevs)."""
    return np.stack([np.asarray(a, dtype=np.float64)
                     for a in (mags, self_dots, lengths, stddevs)], axis=1)


def block_store(counts: torch.Tensor, mom: torch.Tensor, maxc: int):
    """(a DeviceStore over a row block, its moments [4, rows + 1]) from
    counts [rows, D] and float64 moments [rows, 4] on one device, with one
    more row at the end: the center slot, which `_center` fills."""
    rows, d = counts.shape
    c = torch.zeros((rows + 1, d), dtype=counts.dtype, device=counts.device)
    c[:rows] = counts
    m = torch.zeros((4, rows + 1), dtype=torch.float64, device=counts.device)
    m[:, :rows] = mom.T
    return DeviceStore(counts=c, mags=m[0], selfdot=m[1], lens=m[2], stddevs=m[3],
                       maxc=int(maxc)), m


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8)


class MeshScorer:
    """Scorer over the process mesh; requires model singles in
    MESH_SUPPORTED (create() returns None otherwise)."""

    # mixed-center batches replicate their unique rows on every rank; this
    # bounds that working set (merge batches reference only center rows)
    MAX_PAIR_UNIQUE_ROWS = 1 << 14

    @classmethod
    def create(cls, ps, model, mesh: Optional[Mesh] = None):
        """The scorer, or None for a model with singles outside
        MESH_SUPPORTED or a pool the kernels do not take
        (device_store.store_refusal)."""
        if not set(model.singles) <= MESH_SUPPORTED or store_refusal(ps) is not None:
            return None
        return cls(ps, model, mesh=mesh)

    def __init__(self, ps, model, mesh: Optional[Mesh] = None):
        from ..cluster.device_loop import envelope_check

        self.mesh = mesh or make_mesh()
        self.ps = ps
        self._mom = moments(ps.mags, envelope_check(ps), ps.lengths, ps.stddevs)
        lo, hi, _ = block_bounds(ps.n, self.mesh.world, self.mesh.rank)
        dev = self.mesh.device
        self.store, self._m = block_store(
            torch.from_numpy(np.ascontiguousarray(ps.counts[lo:hi])).to(dev),
            torch.from_numpy(self._mom[lo:hi]).to(dev),
            int(ps.counts.max()) if ps.n else 0)
        self._setup(model, HostScorer(ps, model))

    def _setup(self, model, host) -> None:
        from ..cluster.device_loop import resolve_margins

        self.model = model
        self.params = model_to_torch(model, self.mesh.device)
        self.margin = resolve_margins(None, None)[0]
        self._host = host
        self.scored_pairs = 0
        self.split_batches = 0
        self.rechecked_pairs = 0
        self.rechecked_by_rule = np.zeros(3, dtype=np.int64)

    # ------------------------------------------------------------------

    def _rows_of(self, rows: np.ndarray) -> np.ndarray:
        """The counts of these global rows on the host (here the pool's)."""
        return self.ps.counts[rows]

    def _center(self, c: int) -> None:
        """Broadcast row c's counts and moments from the rank that owns it
        into every rank's center slot."""
        mesh, st, m = self.mesh, self.store, self._m
        lo, _, rows = block_bounds(self.ps.n, mesh.world, mesh.rank)
        owner = c // rows
        slot = st.counts.shape[0] - 1
        if owner == mesh.rank:
            st.counts[slot] = st.counts[c - lo]
            m[:, slot] = m[:, c - lo]
        if mesh.world > 1:
            dist.broadcast(_as_bytes(st.counts[slot]), owner)
            mom = m[:, slot].contiguous()
            dist.broadcast(mom, owner)
            m[:, slot] = mom

    def _gather(self, local: torch.Tensor, owner: np.ndarray) -> Tuple[np.ndarray, ...]:
        """Each rank's float64 [4, L] values (its own pairs filled), all
        gathered; each pair's from its owner: (prob, dist, s_err,
        dist_err)."""
        mesh = self.mesh
        if mesh.world > 1:
            got = all_gather(mesh, local).cpu().numpy().reshape(
                (mesh.world,) + tuple(local.shape))
            vals = got[owner, :, np.arange(len(owner))].T
        else:
            vals = local.cpu().numpy()
        return vals[0], vals[1], vals[2], vals[3]

    def _center_decision(self, a: np.ndarray, c: int):
        """(prob, dist, s_err, dist_err) of the pairs (a[p], c)."""
        n, mesh = self.ps.n, self.mesh
        self._center(c)
        lo, hi, rows = block_bounds(n, mesh.world, mesh.rank)
        mine = np.nonzero((a >= lo) & (a < hi))[0]
        dev = mesh.device
        local = torch.zeros((4, len(a)), dtype=torch.float64, device=dev)
        if len(mine):
            a_t = torch.from_numpy(a[mine] - lo).to(dev)
            b_t = torch.tensor([self.store.counts.shape[0] - 1], dtype=torch.int64,
                               device=dev)
            _, dec = pair_stats_decision(self.store, self.params, a_t, b_t)
            local[:, torch.from_numpy(mine).to(dev)] = dec[1:]
        return self._gather(local, a // rows)

    def _pair_decision(self, a: np.ndarray, b: np.ndarray):
        """(prob, dist, s_err, dist_err) of a mixed-center batch: the unique
        rows replicated in a store of their own, the pairs sharded; halved
        while its unique rows exceed MAX_PAIR_UNIQUE_ROWS (every rank cuts
        the same parts, so the collectives stay in step)."""
        mesh = self.mesh
        uniq, inv = np.unique(np.concatenate([a, b]), return_inverse=True)
        if len(uniq) > self.MAX_PAIR_UNIQUE_ROWS:
            h = len(a) // 2
            self.split_batches += 1
            return tuple(np.concatenate(v) for v in zip(
                self._pair_decision(a[:h], b[:h]), self._pair_decision(a[h:], b[h:])))
        counts = np.ascontiguousarray(self._rows_of(uniq))
        maxc = int(counts.max()) if len(uniq) else 0
        dev = mesh.device
        store, _ = block_store(torch.from_numpy(counts).to(dev),
                               torch.from_numpy(self._mom[uniq]).to(dev), maxc)
        L = len(a)
        lo, hi, _ = block_bounds(L, mesh.world, mesh.rank)
        mine = torch.zeros((hi - lo, 4), dtype=torch.float64, device=dev)
        if hi > lo:
            idx = torch.from_numpy(np.concatenate([inv[lo:hi], inv[L + lo:L + hi]])).to(dev)
            _, dec = pair_stats_decision(store, self.params, idx[:hi - lo], idx[hi - lo:])
            mine = dec[1:].T
        vals = gather_rows(mesh, mine, L).cpu().numpy().T
        return vals[0], vals[1], vals[2], vals[3]

    def _recheck(self, a, b, prob, dist_, s_err, dist_err):
        rules = recheck_rules(prob, dist_, s_err, dist_err, self.margin)
        self.rechecked_by_rule += [int(r.sum()) for r in rules]
        idx = np.nonzero(rules[0] | rules[1] | rules[2])[0]
        if len(idx):
            self.rechecked_pairs += len(idx)
            p2, d2 = self._host.score(a[idx], b[idx])
            prob[idx] = p2
            dist_[idx] = d2
        return prob, dist_

    # ------------------------------------------------------------------

    def score_center_all(self, center_row: int) -> Tuple[np.ndarray, np.ndarray]:
        """(prob, dist) of EVERY row against the center, computed sharded
        (without re-checks, as the JAX method)."""
        a = np.arange(self.ps.n, dtype=np.int64)
        prob, dist_, _, _ = self._center_decision(a, int(center_row))
        return prob, dist_

    def score(self, a_rows, b_rows) -> Tuple[np.ndarray, np.ndarray]:
        """Scorer-protocol entry: one center (a constant b) or a mixed
        batch."""
        a = np.atleast_1d(np.asarray(a_rows, dtype=np.int64))
        b = np.atleast_1d(np.asarray(b_rows, dtype=np.int64))
        if len(b) == 1 and len(a) > 1:
            b = np.broadcast_to(b, a.shape)
        if len(a) == 1 and len(b) > 1:
            a = np.broadcast_to(a, b.shape)
        a = np.ascontiguousarray(a)
        b = np.ascontiguousarray(b)
        if len(a) == 0:
            return np.empty(0), np.empty(0)
        if (b == b[0]).all():
            vals = self._center_decision(a, int(b[0]))
        else:
            vals = self._pair_decision(a, b)
        self.scored_pairs += len(a)
        return self._recheck(a, b, *vals)
