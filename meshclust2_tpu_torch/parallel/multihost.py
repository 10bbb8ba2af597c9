"""Multi-process data-parallel clustering over torch.distributed: the port
of meshclust2_tpu/parallel/multihost.py (l. 1-472).

One process a device (NCCL between cards, gloo on the CPU), formed from
the JAX package's environment (`initialize_from_env`: MC2_NPROCS,
MC2_PROC_ID, MC2_COORD) with a TCP rendezvous and a fixed timeout, so that
a dead peer ends the run instead of hanging it:

  - every process streams the FASTA (headers are cheap) but encodes and
    counts only its own contiguous block of records (`build_point_set`,
    through the k-mer kernel under MC2_DEVICE_COUNT=1);
  - the per-row metadata, the self dot products and the largest count are
    all-gathered; the global sort permutation (headers with std::sort
    semantics, then lengths) is computed identically on every process;
  - the count rows travel by one all-to-all into sorted row blocks, each
    process's block on its device in the DeviceStore layout;
  - every process runs the same engine over the device session of
    multihost_session.py (the accumulate loop and the update phase over the
    row-sharded store, the step kernel's and closest_candidates' block
    modes), whose collectives every process meets in step; its host steps
    after a guarded abort score through MultihostScorer (mesh_scorer.py
    over the sorted blocks), whose gathered decisions every process
    shares; the host-exact work (re-checks, closest-to-mean) fetches the
    rows it needs from their owners (`fetch`: a gather of the requested
    rows to every process);
  - process 0 alone writes the CLSTR.

Under MC2_NO_DEVICE_SESSION=1 (the JAX package's switch) every window goes
through MultihostScorer (per-window scoring, the scorer-alone path's
counters).  A pool the kernels do not take (uint32/uint64 histograms, or
counts outside the exact-integer envelope: `refusal`) is clustered on the
host: every window through FetchOracle, the native scorer's float64
semantics on rows fetched from their owners.  Each route says so in one
stderr line, decided before any device work.
"""
from __future__ import annotations

import os
import sys
from datetime import timedelta
from typing import List

import numpy as np
import torch
import torch.distributed as dist

from ..features import host as H
from ..kmer.counting import build_point_set
from .mesh import Mesh, all_gather, backend_for, block_bounds, gather_rows, make_mesh
from .mesh_scorer import MESH_SUPPORTED, MeshScorer, block_store, moments

# seconds a collective waits for its peers before the run fails (a stuck
# process; a dead one's closed connection fails it at once)
DIST_TIMEOUT_S = 600.0


def initialize_from_env(device) -> tuple:
    """(process_id, num_processes) from MC2_NPROCS / MC2_PROC_ID /
    MC2_COORD (host:port of process 0's rendezvous); forms the process
    group when MC2_NPROCS > 1, over NCCL where each process has a card of
    its own and gloo on the CPU or on a shared card (mesh.backend_for).  A
    single process gets its one-rank group from make_mesh."""
    nprocs = int(os.environ.get("MC2_NPROCS", "1"))
    if nprocs <= 1:
        return 0, 1
    pid = int(os.environ["MC2_PROC_ID"])
    dist.init_process_group(
        backend_for(device, nprocs),
        init_method=f"tcp://{os.environ.get('MC2_COORD', 'localhost:9731')}",
        rank=pid, world_size=nprocs, timeout=timedelta(seconds=DIST_TIMEOUT_S))
    return pid, nprocs


def _stream_records(files: List[str]):
    from ..io.fasta import iter_fasta

    for f in files:
        yield from iter_fasta(f)


def load_points_multihost(files: List[str], k: int, datatype: str,
                          process_id: int, num_processes: int):
    """Block-parallel load: (every header, this process's block as a
    PointSet, (lo, hi, n)), rows in file order."""
    from ..io.fasta import encode_sequence

    raw = list(_stream_records(files))
    n = len(raw)
    lo = process_id * n // num_processes
    hi = (process_id + 1) * n // num_processes
    local = build_point_set([encode_sequence(h, s) for h, s in raw[lo:hi]], k, datatype)
    return [h for h, _ in raw], local, (lo, hi, n)


class _MetaPS:
    """PointSet-shaped metadata without the count matrix: the rows stay in
    the processes' blocks, `fetch` serves the host's needs."""

    def __init__(self, k, headers, lengths, mags, stddevs, one_mers, dim):
        self.k = k
        self.headers = headers
        self.lengths = lengths
        self.mags = mags
        self.stddevs = stddevs
        self.one_mers = one_mers
        self.counts = None
        self.seqs = None
        self._dim = dim

    @property
    def n(self):
        return len(self.headers)

    @property
    def dim(self):
        return self._dim


class RowFetch:
    """fetch(rows) -> counts [len(rows), D] on the host, every process
    passing the same rows: each owner sends the requested rows it holds, one
    all-gather.  Rows travel as bytes, so any count type goes.  `calls`,
    `rows` and `remote_rows` (rows this process does not hold) count the
    traffic."""

    def __init__(self, mesh: Mesh, counts: torch.Tensor, n: int):
        self.mesh = mesh
        self.counts = counts     # this process's sorted block [rows (+ slot), D]
        self.n = n
        self.calls = self.rows = self.remote_rows = 0
        self._bytes = counts.view(torch.uint8).view(counts.shape[0], -1)

    def __call__(self, rows) -> np.ndarray:
        rows = np.array(rows, dtype=np.int64, ndmin=1)
        mesh = self.mesh
        lo, _, block = block_bounds(self.n, mesh.world, mesh.rank)
        owner = rows // block
        self.calls += 1
        self.rows += len(rows)
        self.remote_rows += int((owner != mesh.rank).sum())
        dtype = _NP_DTYPES[self.counts.dtype]
        if mesh.world == 1:
            got = self._bytes[torch.from_numpy(rows).to(mesh.device)]
            return got.cpu().numpy().view(dtype)
        per = np.bincount(owner, minlength=mesh.world)
        m = max(1, int(per.max()))
        mine = np.nonzero(owner == mesh.rank)[0]
        width = self._bytes.shape[1]
        send = torch.zeros((m, width), dtype=torch.uint8, device=mesh.device)
        if len(mine):
            send[:len(mine)] = self._bytes[torch.from_numpy(rows[mine] - lo).to(mesh.device)]
        out = all_gather(mesh, send)
        # each requested row's place in its owner's send buffer
        order = np.argsort(owner, kind="stable")
        starts = np.concatenate([[0], np.cumsum(per)[:-1]])
        flat = np.empty(len(rows), dtype=np.int64)
        flat[order] = owner[order] * m + np.arange(len(rows)) - starts[owner[order]]
        return out.cpu().numpy()[flat].view(dtype)


_NP_DTYPES = {torch.uint8: np.uint8, torch.uint16: np.uint16, torch.uint32: np.uint32,
              torch.uint64: np.uint64}


class FetchOracle:
    """The float64 host oracle over fetched rows: the re-check seam when no
    process holds the whole matrix."""

    def __init__(self, meta: _MetaPS, model, fetch):
        self.meta = meta
        self.model = model
        self.fetch = fetch

    def _side(self, rows):
        rows = np.asarray(rows)
        return H.PairSide(
            counts=self.fetch(rows).astype(np.float64),
            mags=self.meta.mags[rows].astype(np.float64),
            one_mers=self.meta.one_mers[rows].astype(np.float64),
            stddevs=self.meta.stddevs[rows],
            lengths=self.meta.lengths[rows].astype(np.float64),
            k=self.meta.k,
        )

    def score(self, a_rows, b_rows):
        a_rows = np.atleast_1d(np.asarray(a_rows))
        b_rows = np.atleast_1d(np.asarray(b_rows))
        if len(b_rows) == 1 and len(a_rows) > 1:
            b_rows = np.broadcast_to(b_rows, a_rows.shape)
        if len(a_rows) == 1 and len(b_rows) > 1:
            a_rows = np.broadcast_to(a_rows, b_rows.shape)
        return self.model.score(self._side(a_rows), self._side(b_rows))


class MultihostScorer(MeshScorer):
    """MeshScorer over the sorted row blocks of build_global_points: the
    center's row comes from its owner's block, a mixed batch's unique rows
    from `fetch`, re-checks from FetchOracle."""

    def __init__(self, meta: _MetaPS, model, mesh: Mesh, store, moments_t, fetch: RowFetch):
        self.mesh = mesh
        self.ps = meta
        self._mom = moments(meta.mags, meta.self_dots, meta.lengths, meta.stddevs)
        self.store, self._m = store, moments_t
        self._fetch = fetch
        self._setup(model, FetchOracle(meta, model, fetch))

    def _rows_of(self, rows: np.ndarray) -> np.ndarray:
        return self._fetch(rows)

    def warm_up(self) -> None:
        """Build the kernel and run both forms once (a collective call on
        every process), so that the clustering window holds scoring only;
        the counters start at zero after it."""
        one = np.zeros(1, dtype=np.int64)
        self._center_decision(one, 0)
        self._pair_decision(np.zeros(2, dtype=np.int64),
                            np.array([0, min(1, self.ps.n - 1)], dtype=np.int64))
        self.scored_pairs = self.rechecked_pairs = self.split_batches = 0
        self.rechecked_by_rule[:] = 0


def build_global_points(files: List[str], k: int, datatype: str, mesh: Mesh):
    """(meta, block): every process's sorted row block [rows, 4^k] on its
    device, at the histograms' natural width, and the replicated metadata.
    Sort order matches cli.load_sorted_points (headers with std::sort
    semantics, then lengths); blocks are mesh.py:block_bounds over the n
    rows, in file order for the counting and in sorted order after the
    all-to-all, which moves the rows as bytes."""
    from ..io.fasta import encode_sequence
    from ..native import sort_perm, sort_perm_strings

    headers: List[str] = []
    raw: List[str] = []
    for header, seq in _stream_records(files):
        headers.append(header)
        raw.append(seq)
    n = len(headers)
    d = 4 ** k
    W, me, dev = mesh.world, mesh.rank, mesh.device
    lo, hi, B = block_bounds(n, W, me)
    local = build_point_set([encode_sequence(headers[i], raw[i]) for i in range(lo, hi)],
                            k, datatype, count_device=dev)
    counts = local.counts
    sdots = np.einsum("ij,ij->i", counts.astype(np.int64), counts.astype(np.int64))

    # the per-row metadata (the "length vector") and self dots, one gather
    meta_cols = np.empty((hi - lo, 9), dtype=np.int64)
    meta_cols[:, 0] = local.lengths
    meta_cols[:, 1] = local.mags
    meta_cols[:, 2] = local.stddevs.astype(np.float64).view(np.int64)
    meta_cols[:, 3:7] = local.one_mers.astype(np.uint64).view(np.int64)
    meta_cols[:, 7] = sdots
    meta_cols[:, 8] = int(counts.max()) if len(counts) else 0
    full = gather_rows(mesh, torch.from_numpy(meta_cols).to(dev), n).cpu().numpy()
    lengths, mags = full[:, 0].copy(), full[:, 1].copy()
    stds = full[:, 2].copy().view(np.float64)
    ones = full[:, 3:7].copy().view(np.uint64)
    maxc = int(full[:, 8].max()) if n else 0

    # the global sort permutation, identical on every process
    p1 = np.asarray(sort_perm_strings(headers))
    perm = p1[np.asarray(sort_perm(lengths[p1]))]

    # the all-to-all: sorted position q holds file row perm[q], counted by
    # the process whose file block holds it; each process sends, in q
    # order, its rows of every sorted block, and places what it receives
    # source by source
    src = perm // B
    width = d * counts.itemsize
    rows_t = torch.from_numpy(np.ascontiguousarray(counts).view(np.uint8)
                              .reshape(hi - lo, width)).to(dev)
    mine = np.nonzero(src == me)[0]
    send = rows_t[torch.from_numpy(perm[mine] - lo).to(dev)]
    in_split = np.bincount(mine // B, minlength=W).tolist()
    out_split = np.bincount(src[lo:hi], minlength=W).tolist()
    recv = torch.empty((hi - lo, width), dtype=torch.uint8, device=dev)
    dist.all_to_all_single(recv, send, out_split, in_split)
    place = torch.from_numpy(np.argsort(src[lo:hi], kind="stable")).to(dev)
    block = torch.empty_like(recv)
    block[place] = recv
    block = block.view(_TORCH_DTYPES[np.dtype(counts.dtype)]).view(hi - lo, d)

    meta = _MetaPS(k=k, headers=[headers[i] for i in perm], lengths=lengths[perm],
                   mags=mags[perm], stddevs=stds[perm], one_mers=ones[perm], dim=d)
    meta.self_dots = full[perm, 7].copy()
    meta.maxc = maxc
    meta.dtype = counts.dtype
    return meta, block


_TORCH_DTYPES = {np.dtype(v): k for k, v in _NP_DTYPES.items()}


def kernel_store(meta: _MetaPS, block: torch.Tensor, mesh: Mesh):
    """(the DeviceStore of this process's block with its center slot, its
    moments [4, rows + 1]) for the kernels (mesh_scorer.py:block_store)."""
    lo, hi, _ = block_bounds(meta.n, mesh.world, mesh.rank)
    mom = moments(meta.mags[lo:hi], meta.self_dots[lo:hi], meta.lengths[lo:hi],
                  meta.stddevs[lo:hi])
    return block_store(block, torch.from_numpy(mom).to(block.device), meta.maxc)


def refusal(meta: _MetaPS):
    """Why the kernels do not take the gathered pool, or None
    (device_store.store_refusal, from the metadata)."""
    from ..cluster.device_loop import DeviceLoopUnsupported, envelope_check_vals

    if meta.dtype not in (np.uint8, np.uint16):
        return f"{np.dtype(meta.dtype)} histograms (the kernels read uint8/uint16)"
    try:
        envelope_check_vals(meta.maxc, int(meta.mags.max()) if meta.n else 0,
                            int(meta.lengths.max()) if meta.n else 0, meta.self_dots)
    except DeviceLoopUnsupported as e:
        return f"{e} (outside the kernels' exact-integer envelope)"
    return None


def run_multihost(args):
    """CLI entry (meshclust2-torch --multihost): recover-path clustering
    with weights trained elsewhere (--recover); training stays
    single-process.  Routes by input before any device work, with one
    stderr line: the device session over the row-sharded store by default
    (multihost_session.py), MultihostScorer per-window scoring under
    MC2_NO_DEVICE_SESSION=1, the host route over fetched rows for a pool the
    kernels do not take.  Returns the CLI's ClusterRun; rc 2 without
    --recover or for a model outside MESH_SUPPORTED (the JAX mesh scorer
    raises on one)."""
    from ..cli import ClusterRun
    from ..model.classifier import CompiledModel
    from ..model.weights import load_weights
    from ..runtime import resolve_device
    from ..utils.clock import Clock

    if not args.recover:
        print("--multihost requires --recover (train single-process first)",
              file=sys.stderr)
        return ClusterRun(rc=2)
    pred = load_weights(args.recover)
    model = CompiledModel(pred.classifier, bias=args.bias)
    bad = set(model.singles) - MESH_SUPPORTED
    if bad:
        print(f"meshclust2-torch: --multihost: features {sorted(bad)} are outside the "
              f"mesh scorer's set", file=sys.stderr)
        return ClusterRun(rc=2)
    device = resolve_device(args.device)   # raises without a card
    if device.type == "cuda":
        local = int(os.environ.get("MC2_PROC_ID", "0")) % torch.cuda.device_count()
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    formed = not dist.is_initialized()
    pid, _ = initialize_from_env(device)
    mesh = make_mesh(device)
    # the run's clock is the current one until the clustering returns
    with Clock(annotate=bool(args.profile)) as clock:
        res = _cluster(args, pred, model, mesh, pid, clock)
    if formed:
        dist.barrier()
        dist.destroy_process_group()
    return res


def _cluster(args, pred, model, mesh: Mesh, pid: int, clock):
    """The clustering of run_multihost on its process group: the points,
    the route, the engine, rank 0's CLSTR."""
    from ..cli import ClusterRun
    from ..cluster.engine import MeanShiftEngine
    from ..io.clstr import write_clstr
    from ..utils.clock import span

    with span("setup.count"):
        meta, block = build_global_points(args.files, pred.k, pred.datatype, mesh)
    sim = pred.id_cutoff
    session = scorer = None
    why = refusal(meta)
    if why is not None:
        fetch = RowFetch(mesh, block, meta.n)
        scorer = FetchOracle(meta, model, fetch)
        print(f"meshclust2-torch: --multihost: {why}: clustering on the host scorer "
              f"over the row-sharded store (FetchOracle)", file=sys.stderr)
    else:
        with span("setup.session"):
            store, m = kernel_store(meta, block, mesh)
            del block
            fetch = RowFetch(mesh, store.counts, meta.n)
            scorer = MultihostScorer(meta, model, mesh, store, m, fetch)
            scorer.warm_up()
            if not os.environ.get("MC2_NO_DEVICE_SESSION"):
                from .multihost_session import build_multihost_session

                session = build_multihost_session(
                    meta, model, sim, mesh, store, fetch, scorer,
                    delta=args.delta, iterations=args.iterations)
        if session is None:
            print("meshclust2-torch: --multihost runs MultihostScorer per-window scoring "
                  "(MC2_NO_DEVICE_SESSION=1)", file=sys.stderr)
        else:
            print("meshclust2-torch: --multihost runs the device session over the "
                  "row-sharded store", file=sys.stderr)
    clock.stamp("read_in_points")
    engine = MeanShiftEngine(meta, model, sim, scorer=scorer, delta=args.delta,
                             iterations=args.iterations, device_session=session)
    engine.row_fetcher = fetch
    engine._host_oracle_cached = getattr(scorer, "_host", scorer)
    clusters = engine.run(clock=clock)
    if pid == 0:
        with span("update.write"):
            write_clstr(args.output, engine.to_output(clusters))
    clock.stamp("update")
    clock.stamp("done")
    acc = session.accumulator if session is not None else None
    phase = session.phase if session is not None else None
    if os.environ.get("MC2_DEVICE_PROF"):
        print(f"multihost rank {mesh.rank} of {mesh.world}: windows "
              f"{engine.stats.windows_scored}, pairs {engine.stats.pairs_scored}, "
              f"clusters {engine.stats.clusters_before_update} -> {len(clusters)}, "
              f"iterations {engine.stats.update_iterations}, scored "
              f"{getattr(scorer, 'scored_pairs', 0)}, re-checked "
              f"{getattr(scorer, 'rechecked_pairs', 0)} "
              f"{getattr(scorer, 'rechecked_by_rule', np.zeros(3, np.int64)).tolist()}, "
              f"fetches {fetch.calls} ({fetch.rows} rows, {fetch.remote_rows} remote), "
              f"output {_digest(engine, clusters)}, {_session_line(acc, phase)}")
    return ClusterRun(rc=0, engine=engine, scorer=scorer, accumulator=acc, phase=phase,
                      clock=clock)


def _session_line(acc, phase) -> str:
    """The device session's counters: the accumulator's steps, windows,
    pairs and guarded aborts, the phase's iterations, pairs and abort; the
    block modes' steps and passes with their collectives ({collectives:
    how many}) and the block modes' kernel launches."""
    if acc is None:
        return "no session"
    from ..ops.phase import closest_candidates_block
    from ..ops.window_absorb import window_step_block

    per = lambda c: "{" + ", ".join(f"{k}: {v}" for k, v in sorted(c.items())) + "}"
    # a one-rank session has no block mode
    return (f"accumulator steps {acc.total_steps}, windows {acc.last_windows}, pairs "
            f"{acc.last_pairs}, aborts {acc.aborts}; phase iterations "
            f"{phase.last_iterations}, pairs {phase.scored_pairs}, abort {phase.last_abort}; "
            f"block mode: steps {getattr(acc, 'block_steps', 0)}, collectives a step "
            f"{per(getattr(acc, 'step_collectives', {}))}, passes "
            f"{getattr(phase, 'block_passes', 0)}, collectives a pass "
            f"{per(getattr(phase, 'pass_collectives', {}))}, launches window_absorb_block "
            f"{window_step_block.launches}, closest_candidates_block "
            f"{closest_candidates_block.launches}")


def _digest(engine, clusters) -> str:
    """A digest of the clustering every process computed (its CLSTR's
    content), so that a run can show that all took the same branches."""
    import hashlib

    h = hashlib.sha256()
    for cl in clusters:
        h.update(np.asarray(sorted(cl.members), dtype=np.int64).tobytes())
        h.update(np.int64(cl.center_row).tobytes())
    return h.hexdigest()[:16]
