"""The port's counterpart of meshclust2_tpu/parallel/mesh.py: the process
mesh, the sharded compute steps over torch.distributed, and the device k-mer
histogram build.

The JAX package shards the [N, 4^k] histogram matrix over a jax.sharding
Mesh and writes the reductions the algorithm needs as XLA collectives.  The
port runs one process a device (`make_mesh`: the process group, the rank,
the world size and the rank's device; NCCL for CUDA tensors, gloo for CPU
ones) and writes the same steps as SPMD functions over each rank's
contiguous row block (`block_bounds`), with torch.distributed collectives:

  - `sharded_center_scores`: each rank scores its rows against the
    replicated center; the result stays row-sharded (`gather_rows`
    assembles it on every rank);
  - `sharded_mean_update`: an all-reduce SUM of the masked sums and counts,
    the local distance to the mean, an all-reduce MIN of the value and then
    of the global row among the ranks that hold it;
  - `sharded_glm_solve`: an all-reduce of X^T X and X^T y, a replicated
    solve;
  - `classify_kernel_factory`: the float32 epilogue raw singles ->
    (prob, dist), plain torch, as the JAX factory.

No engine path of either package calls the last three; their products stay
torch.matmul (plain products outside any Pallas kernel).  The engine's
sharded scoring is parallel/mesh_scorer.py (the fused pair-statistics
kernel on each rank's block) and the multi-process runtime
parallel/multihost.py.

The histogram build (`device_build_counts`, the port of
sharded_histogram_build, pack_segment_codes and device_build_counts, JAX
lines 171-276) runs the hand-written kernel of csrc/kmer_count.cu
(ops/kmer_count.py) on one device over the native counter's ragged
packing, in chunks of records: it is what kmer/counting.py:build_point_set
calls under MC2_DEVICE_COUNT, and in a multi-process run each rank calls it
on its own block of records (multihost.py:build_global_points).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """A 1-D process mesh over the default process group: one rank a
    device."""

    rank: int
    world: int
    device: torch.device


def backend_for(device: torch.device, world: int = 1) -> str:
    """The collective backend of a rank on `device` in a group of `world`
    ranks: NCCL where every rank has a card of its own, gloo on the CPU and
    where ranks share a card (NCCL refuses two ranks on one device; gloo
    takes CUDA tensors)."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return "nccl" if world <= torch.cuda.device_count() else "gloo"


def make_mesh(device=None) -> Mesh:
    """The mesh of this process (meshclust2_tpu/parallel/mesh.py:make_mesh,
    l. 28): the default process group, which a multi-process run forms
    first (multihost.py:initialize_from_env); a process without one forms a
    one-rank group here.  `device` is the rank's device (None: the card
    cuda:<rank % cards>, raising without one; "cpu" asks for the CPU).  The
    group's backend must be backend_for's (NCCL for ranks with a card each,
    gloo on the CPU or on a shared card); another raises."""
    from ..runtime import resolve_device

    if device is None:
        resolve_device("cuda")   # raises without a card
        rank = dist.get_rank() if dist.is_initialized() else 0
        device = torch.device("cuda", rank % torch.cuda.device_count())
    dev = torch.device(device)
    backend = backend_for(dev, dist.get_world_size() if dist.is_initialized() else 1)
    if not dist.is_initialized():
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    elif dist.get_backend() != backend:
        raise ValueError(f"a mesh on {dev} needs a {backend} process group; this "
                         f"process's is {dist.get_backend()}")
    return Mesh(dist.get_rank(), dist.get_world_size(), dev)


def block_bounds(n: int, world: int, rank: int) -> Tuple[int, int, int]:
    """(lo, hi, rows a block) of rank `rank`'s contiguous row block of n
    rows over `world` ranks: blocks of ceil(n / world) rows, the last ones
    short or empty, as the JAX package pads n to the mesh size."""
    rows = max(1, -(-n // world))
    lo = min(n, rank * rows)
    return lo, min(n, lo + rows), rows


def all_gather(mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
    """Every rank's `local` [m, ...] concatenated along dim 0 into
    [world * m, ...], in rank order."""
    out = torch.empty((mesh.world * local.shape[0],) + tuple(local.shape[1:]),
                      dtype=local.dtype, device=local.device)
    dist.all_gather_into_tensor(out, local.contiguous())
    return out


def gather_rows(mesh: Mesh, local: torch.Tensor, n: int) -> torch.Tensor:
    """The row blocks [hi - lo, ...] of every rank (block_bounds over n
    rows), all-gathered into [n, ...] on every rank, on the local tensor's
    device.  Bytes travel as uint8, so any dtype goes."""
    lo, hi, rows = block_bounds(n, mesh.world, mesh.rank)
    if local.shape[0] != hi - lo:
        raise ValueError(f"gather_rows: {local.shape[0]} local rows, the block holds "
                         f"{hi - lo}")
    # the width from the shape: a rank's block may be empty
    width = int(np.prod(local.shape[1:], dtype=np.int64)) * local.element_size()
    flat = local.contiguous().view(torch.uint8).view(local.shape[0], width)
    send = torch.zeros((rows, width), dtype=torch.uint8, device=local.device)
    send[:hi - lo] = flat
    out = all_gather(mesh, send)
    return out[:n].contiguous().view(local.dtype).view((n,) + tuple(local.shape[1:]))


def classify_kernel_factory(weights, mins, maxs, is_sim, combo_spec, bias: float = 0.0):
    """An epilogue raw singles [B, S] -> (prob, dist) [B] in float32
    (meshclust2_tpu/parallel/mesh.py:classify_kernel_factory, l. 38: the
    decision path Predictor.cpp:315-333).  combo_spec: (kind, idx tuple)
    per combo (model.combos)."""
    w = torch.as_tensor(np.asarray(weights), dtype=torch.float32)
    mn = torch.as_tensor(np.asarray(mins), dtype=torch.float32)
    mx = torch.as_tensor(np.asarray(maxs), dtype=torch.float32)
    sim = torch.as_tensor(np.asarray(is_sim, dtype=bool))
    spec = tuple((kind, tuple(idxs)) for kind, idxs in combo_spec)

    def epilogue(raw: torch.Tensor):
        dev = raw.device
        v = (raw - mn.to(dev)[None, :]) / (mx - mn).to(dev)[None, :]
        v = torch.where(sim.to(dev)[None, :], v, 1.0 - v)
        cols = []
        for kind, idxs in spec:
            if kind == "xy":
                c = torch.prod(v[:, list(idxs)], dim=1)
            elif kind == "x2y2":
                c = torch.prod(v[:, list(idxs)] ** 2, dim=1)
            elif kind == "xy2":
                c = v[:, idxs[0]] * v[:, idxs[1]] ** 2
            else:  # x2y
                c = v[:, idxs[0]] ** 2 * v[:, idxs[1]]
            cols.append(c)
        combo = torch.stack(cols, dim=1)
        wd = w.to(dev)
        s = wd[0] + combo @ wd[1:]
        # logistic(s) + bias (Predictor.cpp:310-320: the --bias knob)
        prob = 1.0 / (1.0 + torch.exp(-s)) + torch.tensor(bias, dtype=torch.float32)
        return prob, combo[:, 0]

    return epilogue


def sharded_center_scores(mesh: Mesh, singles_fn, epilogue):
    """fn(H_local, center) -> (prob, dist) of this rank's rows, row-sharded
    (meshclust2_tpu/parallel/mesh.py:sharded_center_scores, l. 75):
    singles_fn(H_local, center) gives the raw singles of the local rows
    against the replicated center.  No collective; `gather_rows` assembles
    a result on every rank."""

    def fn(H_local: torch.Tensor, center: torch.Tensor):
        return epilogue(singles_fn(H_local, center))

    return fn


def sharded_mean_update(mesh: Mesh):
    """fn(H_local [n_loc, D], mags_local [n_loc], mask_local [C, n_loc],
    global_rows_local [n_loc]) -> (value [C], global row [C]), replicated:
    per center the member closest to its members' mean histogram by the
    reference's distance_d (DivergencePoint.cpp:54-66), members
    row-sharded (meshclust2_tpu/parallel/mesh.py:sharded_mean_update, l.
    96-146), in float32.  Ties go to the smallest global row; an empty
    center gives (+inf, -1)."""

    def fn(H_local, mags_local, mask_local, global_rows_local):
        del mags_local   # the JAX signature's; distance_d reads the rows
        H = H_local.to(torch.float32)
        mask = mask_local.to(torch.float32)
        sums = mask @ H                                          # [C, D]
        counts = mask.sum(dim=1)                                 # [C]
        dist.all_reduce(sums)
        dist.all_reduce(counts)
        top = sums / torch.clamp(counts, min=1.0)[:, None]
        r = torch.floor(top + 0.5)
        dd = 2.0 * torch.minimum(H[None, :, :], r[:, None, :]).sum(-1)
        mag = torch.trunc(H[None, :, :] + top[:, None, :]).sum(-1)
        frac = dd / mag
        d = 10000.0 * (1.0 - frac * frac)                        # [C, n_loc]
        d = torch.where(mask > 0, d, torch.full_like(d, float("inf")))
        if d.shape[1]:
            local_min, arg = d.min(dim=1)
            local_arg = global_rows_local.to(torch.int64)[arg]
        else:
            local_min = torch.full((mask.shape[0],), float("inf"), device=H.device)
            local_arg = torch.full((mask.shape[0],), 2 ** 30, dtype=torch.int64,
                                   device=H.device)
        gmin = local_min.clone()
        dist.all_reduce(gmin, op=dist.ReduceOp.MIN)
        winner = torch.where(local_min == gmin, local_arg,
                             torch.full_like(local_arg, 2 ** 30))
        dist.all_reduce(winner, op=dist.ReduceOp.MIN)
        empty = counts <= 0
        gmin = torch.where(empty, torch.full_like(gmin, float("inf")), gmin)
        garg = torch.where(empty, torch.full_like(winner, -1), winner)
        return gmin, garg

    return fn


def sharded_glm_solve(mesh: Mesh):
    """fn(X_local, y_local) -> w, replicated: the normal equations with
    all-reduced moments X^T X and X^T y, then one solve on every rank
    (meshclust2_tpu/parallel/mesh.py:sharded_glm_solve, l. 149-168;
    GLM.cpp:20-23), in float64."""

    def fn(X_local, y_local):
        X = X_local.to(torch.float64)
        y = y_local.to(torch.float64)
        xtx = X.T @ X
        xty = X.T @ y
        dist.all_reduce(xtx)
        dist.all_reduce(xty)
        return torch.linalg.solve(xtx, xty)

    return fn


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
