#!/usr/bin/env python3
"""The redesigned kernels' device times in several checkouts of the
repository, on one card, in turns.

    python3 kernel_ab.py ROOT [ROOT ...] [--order 0,1,1,0] [--out FILE]
                         [--phase | --kmer | --block | --window]

Each run is a process of its own that imports the port of one checkout
(`meshclust2_tpu_torch` from that root), builds its kernels into the
checkout's build/, and times, at the main path's shapes of chip_smoke.py
(d4) and (d5) on the same seeded inputs in every checkout (a 10,000 x 1,024
uint8 store of counts 1..39, the center form at W = 1,571 against row 4,000
and the pair form at P = 98,304):

- `plane_singles` with the plane singles of the markov and the plane model
  (markov, rre_k_r, sim_mm; spearman, d2s, d2_star, n2rc);
- `pair_stats_decision` with the slow and the blockwise model (the FULL
  kernel), with the markov and the plane model (the PLANE epilogue), and
  with a fast model (intersection, manhattan; the fast instantiation);

each by CUDA events behind a busy wait (median of 20 launches), each
result held against its plain version within the sum of both bounds (the
statistics bit for bit).

With --phase it times instead the update phase's kernels (ops/phase.py:
`phase_layout`, `merge_replay`, and the iteration's closest-to-mean with
its candidates step: `closest_candidates`, one launch, or in a checkout
that predates it `closest_mean` then `phase_candidates`, two launches
timed together) on seeded synthetic states after accumulate
(`phase_state`, a seeded 1,024-bin uint8 store, 10 % of the pairs kept)
at two shapes, each held against its plain version bit for bit: "d6",
chip_smoke.py (d6)'s (n = 10,000, S = 1,147, delta = 5, 288 merges), and
"100k", the 100k bench set's (n = 100,000, S and merges as its run prints
them, PHASE_SHAPES); `closest_mean` alone on the same filter too; the
ptxas lines of the phase and closest-to-mean libraries, and each shape's
C, P, events and each kernel's bytes and bound (phase_bytes,
chip_smoke.py:bound_ms).

With --kmer it times the k-mer histogram kernel (ops/kmer_count.py:
`kmer_count`, a checkout that has it) on the bench set's records
(bench.py:ensure_dataset at 10,000 and 100,000 sequences, k = 5, uint8),
against its plain version and torch.bincount over the windows' flat
indices (the nearest one-call PyTorch counterpart: it leaves out the index
sweep and the saturation), with its bound (the codes read and the counts
written once), and the counting part of set-up: device_build_counts
against the native counter on the same records; then, beside their
bounds and torch.bincount, a homopolymer of 999,999 bases, one random
record of 2,000,050 bases (split at 1 Mbp) and 2,000 of the 10k records
at k = 8.  It also prints the plane store's device bytes
(every tensor the store adds to the DeviceStore), the ptxas lines of the
pair-statistics library and a SHA-256 of each fast instantiation's SASS
(cuobjdump), keyed by (count type, NV, NARROW), so that two checkouts'
fast kernels can be compared.

With --window it times the accumulate step's window and seed
(cluster/device_loop.py: a checkout's torch operations, `_window_ops` after
`_seed`, or the one launch of ops/window_select.py) on seeded pools of the
clustering cells' sizes (WINDOW_SHAPES: 10,000 and 100,000 rows of lengths
800-1,499 in bins of 1,000, half of them alive, `window_pool`), each from
the same state: the device time of what a step issues (by CUDA events
behind a busy wait), the host's time to issue it, and the whole call with
the step's read (host clock, medians of 21); the one launch is held
against its plain twin bit for bit, and every checkout's reads (the seven
integers and the candidates' sum) must agree.

With --block it times the row-sharded session's step and pass
(parallel/multihost_session.py) as the sequence a rank runs from its own
candidates' statistics (the step) or its own pairs' filter bits (the pass)
to the trip or the new centers and candidates, for G = 1 and G = 4 ranks in
this process (the all-reduces and all-gathers stood in for by sums and
stacks on the card), in the checkout's own design: before the redesign, the
session's zeroed exchange buffers, scatters and three block-mode launches
around the statistics', the partial sums' and the partials' collectives at
any G; after it, at G = 1 the one-launch kernels (window_step,
closest_candidates) and at G = 4 the block modes' exchange, fused phase and
pick.  The step at chip_smoke.py (m4)'s shape (a seeded 10,000 x 1,024
uint8 store, W = 1,571, 15 positives, 9 + 15 members), the pass on the
seeded (d6) state of --phase (10 % of the pairs kept, 1 % uncertain); each
result held against the plain one-launch version bit for bit; each
sequence by CUDA events behind a busy wait, and rank 0's launches before
its first collective and between it and the next (the fused phase 2 after
the redesign, phases 1 and 2 before it), with the bytes a rank's exchange
all-reduces.  The runs go in the order `--order` gives
(indices into the roots; default: the roots, then again reversed); the end
prints the median device time of each kernel and checkout, and the line
before the last is one JSON object of all runs.  Exits non-zero if a
kernel differs from its plain version beyond the bounds, or if two
checkouts' fast kernels differ in SASS or ptxas resources.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys

W, P, N, D = 1_571, 98_304, 10_000, 1_024
# (n, S, merges) of the phase's shapes, delta = 5
PHASE_SHAPES = {"d6": (10_000, 1_147, 288), "100k": (100_000, 5_803, 1_996)}
PHASE_DELTA = 5
# the bench set's sizes of --kmer (bench.py:ensure_dataset)
KMER_SHAPES = {"10k": 10_000, "100k": 100_000}
# the seed of --kmer's 2 Mbp record
KMER_SEED = 20261018
# --window's pools: the two clustering cells' sizes, and their seed
WINDOW_SHAPES = {"10k": 10_000, "100k": 100_000}
WINDOW_SEED = 20261019


def phase_bytes(n: int, n_slots: int, n_alive: int, n_pairs: int, delta: int) -> dict:
    """The bytes each phase kernel must move, each input read and each
    output written once, for the bounds of chip_smoke.py (d6) and --phase:
    the layout reads assign, seq, alive and every row's length, the center
    row, member count and length window (blen, elen) of the C alive slots,
    and writes rank [S], inv [C], moff [C + 1], flat [n], the P pairs'
    three arrays and hdr; closest_candidates' candidates step reads alive,
    the dead slots' centers, per rank inv, its new center's member row and
    length window, and writes the new centers [S] and the delta C
    candidates' four arrays (its closest-to-mean part depends on the kept
    rows: the callers add it); the replay reads and writes assign, seq,
    alive and clen and reads t_dst."""
    S, C, m = n_slots, n_alive, delta * n_alive
    return {"phase_layout": 24 * n + S + 32 * C + 8 * (S + 2 * C + 1 + n + 3 * n_pairs + 2),
            "closest_candidates": S + 8 * (S - C) + 40 * C + 8 * S + 25 * m,
            "merge_replay": 2 * (16 * n + 9 * S) + 8 * S}


def phase_state(n: int, n_slots: int, merges: int, seed: int, big: float = 0.0,
                delta: int = PHASE_DELTA, sim: float = 0.9) -> dict:
    """A seeded synthetic update-phase state after accumulate, as numpy
    int64 arrays (bool `alive`): n rows of lengths 800-1,499 in length
    order, in n_slots clusters of consecutive rows (each at least one; with
    `big`, one cluster holds that share of the rows) in slot order, so that
    neighbouring slots hold similar lengths as the engine's cluster list
    does; members in a random order, a random member each cluster's center;
    the rows' length windows trunc(L sim), trunc(L / sim)
    (TorchDevicePhaseUpdater._phase_rows); and `merges` absorb events
    t_dst, each slot into one of the delta slots above it, as the merge
    pass makes them (chains included)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = np.sort(rng.integers(800, 1_500, n)).astype(np.int64)
    sizes = np.ones(n_slots, np.int64)
    rest = n - n_slots
    if big:
        k = int(rng.integers(0, n_slots))
        sizes[k] += int(big * n) - 1
        rest -= int(big * n) - 1
    if rest < 0:
        raise ValueError(f"{n} rows cannot fill {n_slots} slots (big {big})")
    sizes += rng.multinomial(rest, np.full(n_slots, 1.0 / n_slots))
    starts = np.cumsum(sizes) - sizes
    assign = np.repeat(np.arange(n_slots, dtype=np.int64), sizes)
    seq = np.empty(n, np.int64)
    for s in range(n_slots):
        seq[starts[s]:starts[s] + sizes[s]] = rng.permutation(sizes[s])
    cen = starts + (rng.random(n_slots) * sizes).astype(np.int64)
    t_dst = np.full(n_slots, -1, np.int64)
    if n_slots > 1 and merges:
        src = rng.choice(n_slots - 1, min(merges, n_slots - 1), replace=False)
        t_dst[src] = np.minimum(n_slots - 1, src + rng.integers(1, delta + 1, len(src)))
    L = lens.astype(np.float64)
    return dict(assign=assign, seq=seq, cen=cen, alive=np.ones(n_slots, bool),
                clen=sizes, lens=lens, blen=(sim * L).astype(np.int64),
                elen=(L / sim).astype(np.int64), t_dst=t_dst)


def specs(F):
    """(singles, combos) of the models timed, as chip_smoke.py gives them."""
    return {
        "markov": ([F.FEAT_MARKOV, F.FEAT_INTERSECTION, F.FEAT_RRE_K_R, F.FEAT_SIM_MM],
                   [("xy", F.FEAT_INTERSECTION), ("xy", F.FEAT_MARKOV | F.FEAT_SIM_MM),
                    ("xy", F.FEAT_RRE_K_R)]),
        "plane": ([F.FEAT_SPEARMAN, F.FEAT_D2s, F.FEAT_D2_star, F.FEAT_N2RC],
                  [("xy", F.FEAT_SPEARMAN), ("xy", F.FEAT_D2s | F.FEAT_D2_star),
                   ("xy", F.FEAT_N2RC)]),
        "slow": ([F.FEAT_MANHATTAN, F.FEAT_INTERSECTION, F.FEAT_JEFFEREY_DIV,
                  F.FEAT_JENSEN_SHANNON],
                 [("xy", F.FEAT_INTERSECTION), ("xy", F.FEAT_JEFFEREY_DIV | F.FEAT_MANHATTAN),
                  ("x2y2", F.FEAT_JENSEN_SHANNON)]),
        "blockwise": ([F.FEAT_INTERSECTION, F.FEAT_HELLINGER, F.FEAT_CHI_SQUARED,
                       F.FEAT_KL_COND, F.FEAT_MISMATCH],
                      [("xy", F.FEAT_INTERSECTION), ("xy", F.FEAT_HELLINGER | F.FEAT_CHI_SQUARED),
                       ("xy", F.FEAT_KL_COND | F.FEAT_MISMATCH)]),
        "fast": ([F.FEAT_INTERSECTION, F.FEAT_MANHATTAN],
                 [("xy", F.FEAT_INTERSECTION), ("xy", F.FEAT_MANHATTAN)]),
    }


def device_us(fn, reps: int = 20, setup=None, sleep: int = 2_000_000) -> float:
    """Median device time in us of fn()'s launches, each queued behind a
    busy wait on the card (chip_smoke.py:device_us) of `sleep` cycles
    (2,000,000: ~1 ms; longer where the host queues more than that);
    setup(), when given, runs before each call outside the events."""
    import torch

    times = []
    for i in range(reps + 1):
        if setup:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep)
        start.record()
        fn()
        end.record()
        end.synchronize()
        if i:
            times.append(start.elapsed_time(end) * 1e3)
    return statistics.median(times)


# the busy wait before --block's sequences (~10 ms: a sequence of four
# ranks queues ~40 launches and torch operations from the host)
SEQ_SLEEP = 20_000_000


def wall_us(fn, reps: int = 20, setup=None) -> float:
    """Median time in us from fn()'s call to its last launch's end, by
    CUDA events without a busy wait: the host's queueing where it is the
    slower side (as in the session's host-driven loop)."""
    import torch

    times = []
    for i in range(reps + 1):
        if setup:
            setup()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        if i:
            times.append(start.elapsed_time(end) * 1e3)
    return statistics.median(times)


def fast_kernels(built) -> dict:
    """{"T NV NARROW": (ptxas resources, SASS SHA-256)} of the fused
    kernel's fast instantiations (neither FULL nor PLANE) in one build."""
    res, name = {}, None
    for line in built.log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        elif name and ("registers" in line or "stack frame" in line):
            res.setdefault(name, []).append(line.split(" : ", 1)[-1].strip())
    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(built.path)], capture_output=True,
                          text=True, check=True).stdout
    bodies, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            cur = m.group(1)
            bodies[cur] = []
        elif cur and re.match(r"\s+/\*[0-9a-f]{4}\*/", line):
            bodies[cur].append(re.sub(r"^\s+/\*[0-9a-f]{4}\*/\s+", "", line).split(";")[0])
    out = {}
    for mangled in list(bodies) + [n for n in res if n not in bodies]:
        # pair_stats_kernel<T, NV, NARROW, [FULL,] PLANE>, from the mangled
        # name: T h (uint8) or t (uint16), NV Li<n>E (n1: -1), flags Lb<0|1>E
        m = re.search(r"pair_stats_kernelI([ht])Li(n?\d+)E((?:Lb[01]E)+)E", mangled)
        if not m:
            continue
        flags = re.findall(r"Lb([01])E", m.group(3))
        if "1" in flags[1:]:
            continue   # a FULL or PLANE instantiation
        key = (f"{'uint8' if m.group(1) == 'h' else 'uint16'} "
               f"{m.group(2).replace('n', '-')} {'narrow' if flags[0] == '1' else 'wide'}")
        out[key] = ("; ".join(res.get(mangled, [])),
                    hashlib.sha256("\n".join(bodies.get(mangled, [])).encode()).hexdigest())
    return out


def _nvcc() -> str:
    from meshclust2_tpu_torch.ops import _build

    return _build.nvcc_path()


def one(root: str) -> dict:
    """The timings of checkout `root` (this process imports its port)."""
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from meshclust2_tpu_torch.cluster.device_store import DeviceStore
    from meshclust2_tpu_torch.features import flags as F
    from meshclust2_tpu_torch.kmer.counting import PointSet
    from meshclust2_tpu_torch.model.classifier import (PLANE_SINGLES, CompiledModel,
                                                       model_to_torch)
    from meshclust2_tpu_torch.model.weights import ModelBlock
    from meshclust2_tpu_torch.ops import _build
    from meshclust2_tpu_torch.ops.device_features import TorchDeviceFeatureEngine
    from meshclust2_tpu_torch.ops.pair_stats import (pair_stats_decision,
                                                     pair_stats_decision_ref)
    from meshclust2_tpu_torch.ops.plane_singles import plane_singles, plane_singles_ref

    import meshclust2_tpu_torch
    assert os.path.dirname(os.path.dirname(meshclust2_tpu_torch.__file__)) == root
    dev = torch.device("cuda")
    rng = np.random.default_rng(20261017)
    counts = rng.integers(1, 40, (N, D)).astype(np.uint8)
    n = len(counts)
    ps = PointSet(k=5, headers=[f"s{i}" for i in range(n)], counts=counts,
                  one_mers=rng.integers(1, 400, (n, 4)).astype(np.uint64),
                  lengths=rng.integers(700, 1500, n).astype(np.int64),
                  mags=counts.astype(np.int64).sum(axis=1),
                  stddevs=rng.random(n) * 3 + 0.5, ids=np.arange(n))
    store = DeviceStore.from_pointset(ps, dev)
    sp = specs(F)
    pflags = sorted({f for name in ("markov", "plane") for f in sp[name][0]
                     if f in PLANE_SINGLES})
    eng = TorchDeviceFeatureEngine(ps, pflags, store)
    planes = eng.planes
    forms = {"center": (torch.arange(3_000, 3_000 + W, device=dev),
                        torch.tensor([4_000], device=dev)),
             "pair": (torch.from_numpy(rng.integers(0, N, P)).to(dev),
                      torch.from_numpy(rng.integers(0, N, P)).to(dev))}
    builds = {name: _build.load(name) for name in ("pair_stats", "plane_singles")}
    out = {"root": root, "card": torch.cuda.get_device_name(0),
           "plane_store_bytes": sum(t.numel() * t.element_size()
                                    for k, t in vars(planes).items()
                                    if isinstance(t, torch.Tensor)
                                    and k not in ("counts", "mags")),
           "fast_kernels": fast_kernels(builds["pair_stats"]),
           "ptxas": [ln.strip() for ln in builds["pair_stats"].log.splitlines()
                     + builds["plane_singles"].log.splitlines()
                     if "registers" in ln or "spill" in ln or "entry function" in ln],
           "us": {}}

    def check(got, want, what, bounds=True):
        if bounds and not bool(((got[0] - want[0]).abs() <= got[1] + want[1]).all()):
            raise AssertionError(f"{root}: {what} differs from its plain version "
                                 f"beyond the bounds")

    for name, (singles, combos) in sp.items():
        mflags = [f for f in singles if f in PLANE_SINGLES]
        # a wide normalization: the times do not depend on it
        params = model_to_torch(CompiledModel(ModelBlock(
            combos=combos, weights=rng.normal(0.0, 2.0, len(combos) + 1),
            singles=singles, mins=np.full(len(singles), -1.0),
            maxs=np.full(len(singles), 1e4))), dev)
        for form, (a, b) in forms.items():
            key = f"{name} {form}"
            pl = None
            if mflags:
                pl = plane_singles(planes, a, b, mflags)
                torch.cuda.synchronize()
                check(pl, plane_singles_ref(planes, a, b, mflags), f"plane_singles {key}")
                out["us"][f"plane_singles {key}"] = device_us(
                    lambda: plane_singles(planes, a, b, mflags))
            stats, dec = pair_stats_decision(store, params, a, b, pl)
            torch.cuda.synchronize()
            p_stats, p_dec = pair_stats_decision_ref(store, params, a, b, pl)
            if not torch.equal(stats, p_stats):
                raise AssertionError(f"{root}: statistics differ ({key})")
            for r, e in ((0, 3), (2, 4)):
                if not bool(((dec[r] - p_dec[r]).abs() <= dec[e] + p_dec[e]).all()):
                    raise AssertionError(f"{root}: decision row {r} beyond bounds ({key})")
            out["us"][f"decision {key}"] = device_us(
                lambda: pair_stats_decision(store, params, a, b, pl))
    return out


def one_phase(root: str) -> dict:
    """The phase kernels' timings of checkout `root` at PHASE_SHAPES."""
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from meshclust2_tpu_torch.ops import _build
    from meshclust2_tpu_torch.ops import phase as P

    import meshclust2_tpu_torch
    assert os.path.dirname(os.path.dirname(meshclust2_tpu_torch.__file__)) == root
    from meshclust2_tpu_torch.ops.closest_mean import closest_mean, closest_mean_ref
    from chip_smoke import CLOSEST_OPS, bound_ms

    dev = torch.device("cuda")
    logs = [_build.load(name).log for name in ("phase", "closest_mean")]
    out = {"root": root, "card": torch.cuda.get_device_name(0), "fast_kernels": {},
           "ptxas": [ln.strip() for log in logs for ln in log.splitlines()
                     if "registers" in ln or "spill" in ln or "entry function" in ln],
           "us": {}, "shapes": {}}
    delta = PHASE_DELTA
    for shape, (n, n_slots, merges) in PHASE_SHAPES.items():
        arr = {k: torch.from_numpy(v).to(dev)
               for k, v in phase_state(n, n_slots, merges, seed=20261017).items()}
        st = P.PhaseState(arr["assign"], arr["seq"], arr["cen"], arr["alive"], arr["clen"])
        rows = P.PhaseRows(arr["lens"], arr["blen"], arr["elen"])
        lay, lay_p = (P.new_layout(n, n_slots, delta, dev) for _ in range(2))
        P.phase_layout(st, rows, delta, lay)
        P.phase_layout_ref(st, rows, delta, lay_p)
        C, n_pairs = lay_p.hdr.tolist()
        if lay.hdr.tolist() != [C, n_pairs] or not all(
                torch.equal(getattr(lay, f)[:k], getattr(lay_p, f)[:k])
                for f, k in (("rank", n_slots), ("inv", C), ("moff", C + 1), ("flat", n),
                             ("a_rows", n_pairs), ("b_rows", n_pairs), ("seg", n_pairs))):
            raise AssertionError(f"{root}: phase_layout differs from its plain version "
                                 f"({shape})")
        # the filter: a seeded store, 10 % of the pairs kept
        rng = np.random.default_rng(3)
        counts = torch.from_numpy(rng.integers(1, 40, (n, D)).astype(np.uint8)).to(dev)
        mags = counts.sum(dim=1, dtype=torch.int64).to(torch.float64)
        keep = torch.from_numpy(rng.random(n_pairs) < 0.1).to(dev)
        ckw = dict(maxc=39, tie_margin=1e-12)
        b, sg = lay.b_rows[:n_pairs], lay.seg[:n_pairs]
        cand, cand_p = (P.new_candidates(n_slots, delta, dev) for _ in range(2))
        if hasattr(P, "closest_candidates"):
            cargs = (counts, mags, keep, st, rows, delta, lay, C, n_pairs)

            def fold():
                return P.closest_candidates(*cargs, cand, **ckw)

            want = P.closest_candidates_ref(*cargs, cand_p, **ckw)
        else:
            def fold():
                first, unc = closest_mean(counts, mags, b, sg, keep, C, **ckw)
                P.phase_candidates(st, rows, delta, lay, first, C, n_pairs, cand)
                return first, unc

            want = closest_mean_ref(counts, mags, b, sg, keep, C, **ckw)
            P.phase_candidates_ref(st, rows, delta, lay, want[0], C, n_pairs, cand_p)
        got = fold()
        m = delta * C
        if not (all(torch.equal(x, y) for x, y in zip(got, want))
                and torch.equal(cand.cen, cand_p.cen) and all(
                    torch.equal(getattr(cand, f)[:m], getattr(cand_p, f)[:m])
                    for f in ("a", "b", "seg", "ok"))):
            raise AssertionError(f"{root}: closest-to-mean and candidates differ ({shape})")
        rep, rep_p = (P.new_state(n, n_slots, dev) for _ in range(2))
        P.merge_replay(st, arr["t_dst"], rep)
        P.merge_replay_ref(st, arr["t_dst"], rep_p)
        if not all(torch.equal(getattr(rep, f), getattr(rep_p, f))
                   for f in ("assign", "seq", "alive", "clen")):
            raise AssertionError(f"{root}: merge_replay differs ({shape})")
        nbytes = phase_bytes(n, n_slots, C, n_pairs, delta)
        kept = b[keep]
        nbytes["closest_candidates"] += (torch.unique(kept).numel() * (D + 8)
                                         + 17 * n_pairs + 9 * C)
        ops = {"closest_candidates": CLOSEST_OPS * len(kept) * D + 2 * D}
        out["shapes"][shape] = dict(n=n, S=n_slots, C=C, P=n_pairs, kept=len(kept),
                                    events=int((arr["t_dst"] >= 0).sum()),
                                    bytes=nbytes, bound_us={
                                        k: bound_ms(v, ops.get(k, 0))[0] * 1e3
                                        for k, v in nbytes.items()})
        out["us"][f"phase_layout {shape}"] = device_us(
            lambda: P.phase_layout(st, rows, delta, lay))
        out["us"][f"closest_candidates {shape}"] = device_us(fold)
        out["us"][f"closest_mean {shape}"] = device_us(
            lambda: closest_mean(counts, mags, b, sg, keep, C, **ckw))
        out["us"][f"merge_replay {shape}"] = device_us(
            lambda: P.merge_replay(st, arr["t_dst"], rep))
    return out


BLOCK_SEED = 20261019


def block_step_inputs(np, torch, dev, store_cls):
    """The (m4) step: a seeded 10,000 x 1,024 uint8 store (counts 1..39),
    a pool of its rows in a permuted flat order, an open cluster of 9
    members, a window of W = 1,571 alive candidates with 15 positives, their
    seeded dists."""
    rng = np.random.default_rng(BLOCK_SEED)
    n, w, mcnt, npos = N, W, 9, 15
    counts = rng.integers(1, 40, (n, D)).astype(np.uint8)
    c64 = counts.astype(np.int64)
    order = rng.permutation(n).astype(np.int64)
    flat = rng.permutation(n)
    mem, free = flat[:mcnt], flat[mcnt:]
    alive = np.zeros(n, bool)
    alive[free] = True
    assign = np.full(n, -1, np.int64)
    assign[mem] = 3
    astep = np.zeros(n, np.int64)
    astep[mem] = np.arange(mcnt)
    members = np.zeros(n + 1, np.int64)
    members[:mcnt] = mem
    cand = np.sort(rng.choice(free, w, replace=False)).astype(np.int64)
    s = 0.25 - 0.5 - rng.random(w)
    s[rng.choice(w, npos, replace=False)] = 0.25 + 0.5 + rng.random(npos)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    store = store_cls(counts=up(counts), mags=up(c64.sum(axis=1).astype(np.float64)),
                      selfdot=up((c64 * c64).sum(axis=1).astype(np.float64)),
                      lens=up(rng.integers(800, 1500, n).astype(np.float64)),
                      stddevs=up(rng.random(n)), maxc=int(counts.max()))
    state = (up(alive), up(assign), up(astep), up(members), up(c64[order[mem]].sum(axis=0)))
    zero = torch.zeros(w, dtype=torch.float64, device=dev)
    kw = dict(cid=3, stepc=n + 7, mcnt=mcnt, pos_edge=0.25, margin=1e-8, tie_margin=1e-12,
              s_err=zero, dist_err=zero.clone())
    return store, up(order), up(cand), up(s), up(rng.random(w)), state, up(mem[:1]), kw


def _blocks_of(store, G: int):
    """G RowBlocks of the store's rows (parallel/mesh.py:block_bounds)."""
    from meshclust2_tpu_torch.ops.closest_mean import RowBlock
    from meshclust2_tpu_torch.parallel.mesh import block_bounds

    n = store.counts.shape[0]
    got = []
    for g in range(G):
        lo, hi, _ = block_bounds(n, G, g)
        got.append(RowBlock(store.counts[lo:hi].contiguous(), store.mags, store.selfdot,
                            store.lens, store.stddevs, store.maxc, lo, hi))
    return got


def block_step(out: dict, redesigned: bool, np, torch, dev) -> None:
    """--block's step: the sequences at G = 1 and 4 into out["us"]."""
    from meshclust2_tpu_torch.cluster.device_store import DeviceStore
    from meshclust2_tpu_torch.ops import window_absorb as WA
    from meshclust2_tpu_torch.ops.closest_mean import PART
    from meshclust2_tpu_torch.ops.pair_stats import pair_stats

    i64 = dict(dtype=torch.int64, device=dev)
    store, order, cand, s, dist, state0, cur_d, kw = block_step_inputs(
        np, torch, dev, DeviceStore)
    if hasattr(WA, "TIE_ALL"):   # a tree before the keyed tie guard takes no keys
        kw["tie"] = WA.TIE_ALL
    n, w, d = N, W, D
    center = order[cur_d].expand(w).contiguous()
    stats = pair_stats(store.counts, order[cand], center)
    dec = torch.stack([s, torch.zeros_like(s), dist, kw["s_err"], kw["dist_err"]])
    plain_state = WA.StepState(*(t.clone() for t in state0))
    want = WA.window_step_ref(store, order, cand, s, dist, stats, plain_state, cur_d, **kw)
    base = {k: kw[k] for k in ("cid", "stepc", "mcnt", "pos_edge", "margin", "tie_margin",
                               "tie") if k in kw}
    rows = order[cand]
    for G in (1, 4):
        blocks = _blocks_of(store, G)
        states = [WA.StepState(*(t.clone() for t in state0)) for _ in blocks]
        scr = [WA.step_scratch(n, dev) for _ in blocks]
        curs = [cur_d.clone() for _ in blocks]
        rps = [torch.zeros(PART, **i64) for _ in blocks]
        own = [torch.nonzero((rows >= b.lo) & (rows < b.hi)).view(-1) for b in blocks]
        own_in = [(p, rows[p] - b.lo, stats[p].contiguous(), dec[:, p].contiguous())
                  for p, b in zip(own, blocks)]
        if redesigned:
            L = WA.step_xbuf_len(w, d, 1, G)
            xs = [torch.zeros(L, **i64) for _ in blocks]
            xbytes = 8 * L
        else:
            parts_ = [torch.zeros(d, **i64) for _ in blocks]
            xbytes = 8 * (8 * w + d)
        old = {}   # before the redesign: the window's exchanged statistics

        def exchange(g):
            """Rank g's launches and torch operations before its first
            collective."""
            p, r, st, dc = own_in[g]
            if redesigned:
                WA.window_step_block(1, blocks[g], order, cand, states[g], curs[g],
                                     scratch=scr[g], xbuf=xs[g], rank=g, n_ranks=G,
                                     own_pos=p, own_rows=r, own_stats=st, own_dec=dc, **base)
                return None
            buf = torch.zeros((8, w), **i64)
            buf[:3, p] = st.T
            buf[3:, p] = dc.view(torch.int64)
            return buf

        def old_args(g):
            st_all, dc_all = old["stats"], old["dec"]
            return ((blocks[g], order, cand, dc_all[0], dc_all[2], st_all, states[g], curs[g]),
                    dict(base, s_err=dc_all[3], dist_err=dc_all[4]))

        def old_exchange():
            bufs = [exchange(g) for g in range(G)]
            tot = torch.stack(bufs).sum(dim=0) if G > 1 else bufs[0]
            old["stats"] = tot[:3].T.contiguous()
            old["dec"] = tot[3:].view(torch.float64)

        def old_mid(g):
            """Rank g's phases 1 and 2 (around the partial sums' all-reduce)."""
            a, k = old_args(g)
            WA.window_step_block(1, *a, scratch=scr[g], part=parts_[g], rank_part=rps[g], **k)
            WA.window_step_block(2, *a, scratch=scr[g], part=parts_[g], rank_part=rps[g], **k)

        def seq():
            if redesigned and G == 1:   # the session's one-rank step: the one-launch kernel
                return WA.window_step(store, order, cand, s, dist, stats, states[0], curs[0],
                                      scratch=scr[0], **kw)
            if redesigned:
                for g in range(G):
                    exchange(g)
                total = torch.stack(xs).sum(dim=0) if G > 1 else xs[0]
                for g in range(G):
                    WA.window_step_block(2, blocks[g], order, cand, states[g], curs[g],
                                         scratch=scr[g], xbuf=total, rank=g, n_ranks=G,
                                         rank_part=rps[g], **base)
            else:
                old_exchange()
                for g in range(G):
                    a, k = old_args(g)
                    WA.window_step_block(1, *a, scratch=scr[g], part=parts_[g],
                                         rank_part=rps[g], **k)
                if G > 1:
                    total = torch.stack(parts_).sum(dim=0)
                    for g in range(G):
                        parts_[g].copy_(total)
                for g in range(G):
                    a, k = old_args(g)
                    WA.window_step_block(2, *a, scratch=scr[g], part=parts_[g],
                                         rank_part=rps[g], **k)
            gathered = torch.stack(rps) if G > 1 else rps[0][None].contiguous()
            trips = []
            for g in range(G):
                if redesigned:
                    trips.append(WA.window_step_block(
                        3, blocks[g], order, cand, states[g], curs[g], scratch=scr[g],
                        rank=g, n_ranks=G, parts=gathered, **base))
                else:
                    a, k = old_args(g)
                    trips.append(WA.window_step_block(
                        3, *a, scratch=scr[g], part=parts_[g], rank_part=rps[g],
                        parts=gathered, **k))
            return trips[0]

        def restore():
            for st in states:
                for t, t0 in zip(st, state0):
                    t.copy_(t0)
            if not redesigned:
                for t in parts_:
                    t.zero_()

        restore()
        trip = seq()
        torch.cuda.synchronize()
        if not torch.equal(trip, want) or not all(
                torch.equal(a[:-1], b[:-1]) if k == "members" else torch.equal(a, b)
                for k, a, b in zip(WA.StepState._fields, states[0], plain_state)):
            raise AssertionError(f"the step's sequence at G = {G} differs from the plain "
                                 f"step: {trip} != {want}")
        out["us"][f"step sequence G={G}"] = device_us(seq, setup=restore, sleep=SEQ_SLEEP)
        out["us"][f"step sequence G={G} wall"] = wall_us(seq, setup=restore)
        if G == 4:
            # rank 0's launches between its first two collectives
            restore()
            if redesigned:
                for g in range(G):
                    exchange(g)
                total_x = torch.stack(xs).sum(dim=0)
                mid = lambda: WA.window_step_block(
                    2, blocks[0], order, cand, states[0], curs[0], scratch=scr[0],
                    xbuf=total_x, rank=0, n_ranks=G, rank_part=rps[0], **base)
            else:
                old_exchange()
                mid = lambda: old_mid(0)
            out["us"]["step rank 0 between collectives G=4"] = device_us(mid, setup=restore)
        out["shapes"][f"step G={G}"] = dict(
            W=w, positives=15, members=kw["mcnt"] + 15, D=d,
            exchange_bytes=0 if redesigned and G == 1 else xbytes)


def block_pass(out: dict, redesigned: bool, np, torch, dev) -> None:
    """--block's pass: the sequences at G = 1 and 4 into out["us"]."""
    from meshclust2_tpu_torch.cluster.device_store import DeviceStore
    from meshclust2_tpu_torch.ops import phase as P
    from meshclust2_tpu_torch.ops.closest_mean import PART

    i64 = dict(dtype=torch.int64, device=dev)
    nn, n_slots, merges = PHASE_SHAPES["d6"]
    delta = PHASE_DELTA
    arr = {k: torch.from_numpy(v).to(dev)
           for k, v in phase_state(nn, n_slots, merges, seed=20261017).items()}
    st = P.PhaseState(arr["assign"], arr["seq"], arr["cen"], arr["alive"], arr["clen"])
    prow = P.PhaseRows(arr["lens"], arr["blen"], arr["elen"])
    lay = P.new_layout(nn, n_slots, delta, dev)
    P.phase_layout(st, prow, delta, lay)
    C, n_pairs = lay.hdr.tolist()
    rng = np.random.default_rng(3)
    counts = torch.from_numpy(rng.integers(1, 40, (nn, D)).astype(np.uint8)).to(dev)
    mags = counts.sum(dim=1, dtype=torch.int64).to(torch.float64)
    zeros = torch.zeros(nn, dtype=torch.float64, device=dev)
    pstore = DeviceStore(counts=counts, mags=mags, selfdot=zeros, lens=zeros,
                         stddevs=zeros, maxc=39)
    keep = torch.from_numpy(rng.random(n_pairs) < 0.1).to(dev)
    func = torch.from_numpy(rng.random(n_pairs) < 0.01).to(dev)
    ckw = dict(maxc=39, tie_margin=1e-12)
    want_c = P.new_candidates(n_slots, delta, dev)
    f0, u0 = P.closest_candidates_ref(counts, mags, keep, st, prow, delta, lay, C,
                                      n_pairs, want_c, **ckw)
    b = lay.b_rows[:n_pairs]
    m = delta * C
    nw = -(-n_pairs // 32)
    for G in (1, 4):
        blocks = _blocks_of(pstore, G)
        outs = [P.new_candidates(n_slots, delta, dev) for _ in blocks]
        rps = [torch.zeros((C, PART), **i64) for _ in blocks]
        owns = [(b >= blk.lo) & (b < blk.hi) for blk in blocks]
        pos = [torch.nonzero(o).view(-1) for o in owns]
        args = (st, prow, delta, lay, C, n_pairs)
        if redesigned:
            dtype = P.exchange_dtype(n_pairs, 39)
            L = P.exchange_words(n_pairs, C, D)
            xs = [torch.zeros(L, dtype=dtype, device=dev) for _ in blocks]
            cs = [torch.cumsum(o, 0, dtype=torch.int64) for o in owns]
            own_k = [keep[p].contiguous() for p in pos]
            own_u = [func[p].contiguous() for p in pos]
            xbytes = L * torch.zeros(0, dtype=dtype).element_size()
        else:
            nums = [torch.zeros((C, D), **i64) for _ in blocks]
            xbytes = 2 * n_pairs + 8 * C * D

        def pass_seq():
            if redesigned and G == 1:   # the session's one-rank pass
                func.any().view(1)
                return P.closest_candidates(counts, mags, keep, *args, outs[0], **ckw)
            if redesigned:
                for g in range(G):
                    P.closest_candidates_block(1, blocks[g], *args, outs[g], xbuf=xs[g],
                                               own_cs=cs[g], own_keep=own_k[g],
                                               own_unc=own_u[g], tie_margin=1e-12)
                total = torch.stack(xs).sum(dim=0, dtype=dtype) if G > 1 else xs[0]
                total[nw:2 * nw].any().view(1)
                for g in range(G):
                    P.closest_candidates_block(2, blocks[g], *args, outs[g], xbuf=total,
                                               rank_part=rps[g], tie_margin=1e-12)
            else:
                bits = []
                for g in range(G):
                    bt = torch.zeros((2, n_pairs), dtype=torch.uint8, device=dev)
                    bt[0, pos[g]] = keep[pos[g]].to(torch.uint8)
                    bt[1, pos[g]] = func[pos[g]].to(torch.uint8)
                    bits.append(bt)
                tot = torch.stack(bits).sum(dim=0, dtype=torch.uint8) if G > 1 else bits[0]
                kp = tot[0].bool()
                tot[1].bool().any().view(1)
                for g in range(G):
                    P.closest_candidates_block(1, blocks[g], kp, *args, outs[g], num=nums[g],
                                               tie_margin=1e-12)
                total = torch.stack(nums).sum(dim=0) if G > 1 else nums[0]
                for g in range(G):
                    P.closest_candidates_block(2, blocks[g], kp, *args, outs[g], num=total,
                                               rank_part=rps[g], tie_margin=1e-12)
            gathered = (torch.stack([r[:C] for r in rps]) if G > 1
                        else rps[0][:C][None].contiguous())
            got = []
            for g in range(G):
                pre = () if redesigned else (keep,)
                got.append(P.closest_candidates_block(3, blocks[g], *pre, *args, outs[g],
                                                      parts=gathered, tie_margin=1e-12))
            return got[0]

        f, u = pass_seq()
        torch.cuda.synchronize()
        if not (torch.equal(f, f0) and torch.equal(u, u0)
                and torch.equal(outs[0].cen, want_c.cen) and all(
                    torch.equal(getattr(outs[0], k)[:m], getattr(want_c, k)[:m])
                    for k in ("a", "b", "seg", "ok"))):
            raise AssertionError(f"the pass's sequence at G = {G} differs from the plain "
                                 f"closest_candidates")
        out["us"][f"pass sequence G={G}"] = device_us(pass_seq, sleep=SEQ_SLEEP)
        out["us"][f"pass sequence G={G} wall"] = wall_us(pass_seq)
        out["shapes"][f"pass G={G}"] = dict(
            C=C, P=n_pairs, kept=int(keep.sum()),
            exchange_bytes=0 if redesigned and G == 1 else xbytes)


def one_block(root: str) -> dict:
    """The session's step and pass sequences of checkout `root` (--block)."""
    sys.path.insert(0, root)
    import numpy as np
    import torch
    import meshclust2_tpu_torch
    assert os.path.dirname(os.path.dirname(meshclust2_tpu_torch.__file__)) == root
    from meshclust2_tpu_torch.ops import window_absorb as WA

    from meshclust2_tpu_torch.ops import _build

    dev = torch.device("cuda")
    redesigned = hasattr(WA, "step_xbuf_len")
    logs = [_build.load(name).log for name in ("window_absorb", "closest_mean")]
    out = {"root": root, "card": torch.cuda.get_device_name(0), "fast_kernels": {},
           "ptxas": [ln.strip() for log in logs for ln in log.splitlines()
                     if "registers" in ln or "spill" in ln or "entry function" in ln],
           "us": {}, "shapes": {}, "redesigned": redesigned}
    block_step(out, redesigned, np, torch, dev)
    block_pass(out, redesigned, np, torch, dev)
    return out


def window_pool(np, torch, dev, n: int):
    """--window's pool: n seeded rows of lengths 800-1,499 and 1,024 counts
    of 1-39 in the benchmark's bins of 1,000, an accumulator over them on
    the card, half of them alive at random, and a center."""
    from meshclust2_tpu_torch.cluster.bvec import BVec
    from meshclust2_tpu_torch.cluster.device_loop import TorchDeviceAccumulator
    from meshclust2_tpu_torch.cluster.device_store import DeviceStore
    from meshclust2_tpu_torch.kmer.counting import PointSet
    from meshclust2_tpu_torch.model.classifier import CompiledModel
    from meshclust2_tpu_torch.model.weights import load_weights

    w = load_weights(os.path.join("tests", "fixtures", "med2000_weights.txt"))
    rng = np.random.default_rng(WINDOW_SEED + n)
    counts = rng.integers(1, 40, (n, D), dtype=np.uint8)
    lengths = np.sort(rng.integers(800, 1_500, n)).astype(np.int64)
    ps = PointSet(k=5, headers=[f"s{i}" for i in range(n)], counts=counts,
                  one_mers=rng.integers(1, 400, (n, 4)).astype(np.uint64), lengths=lengths,
                  mags=counts.astype(np.int64).sum(axis=1), stddevs=rng.random(n) + 0.5,
                  ids=np.arange(n))
    bv = BVec(ps.lengths, 1_000)
    bv.insert_all(ps.lengths)
    bv.insert_finalize(ps.lengths)
    acc = TorchDeviceAccumulator(ps, CompiledModel(w.classifier), w.id_cutoff,
                                 DeviceStore.from_pointset(ps, dev))
    acc.ensure_ready(bv)
    alive = rng.random(n) < 0.5
    carry = {"alive0": alive, "assign0": np.where(alive, -1, 0), "astep0": np.zeros(n, np.int64),
             "centers0": np.zeros(n, np.int64), "cid0": 1, "stepc0": n + 2,
             "cur0": int(rng.integers(n // 3, 2 * n // 3)),
             "msum0": np.zeros(D, np.int64), "done0": False}
    return acc, carry


def one_window(root: str) -> dict:
    """--window: the accumulate step's window and seed of checkout `root` at
    WINDOW_SHAPES, in the checkout's own design."""
    sys.path.insert(0, root)
    import time

    import numpy as np
    import torch
    import meshclust2_tpu_torch
    assert os.path.dirname(os.path.dirname(meshclust2_tpu_torch.__file__)) == root
    from meshclust2_tpu_torch.cluster.device_loop import TorchDeviceAccumulator
    from meshclust2_tpu_torch.ops import _build

    dev = torch.device("cuda")
    fused = hasattr(TorchDeviceAccumulator, "_seed_window")
    out = {"root": root, "card": torch.cuda.get_device_name(0), "fast_kernels": {},
           "ptxas": [], "us": {}, "shapes": {}, "fused": fused}
    if fused:
        out["ptxas"] = [ln.strip() for ln in _build.load("window_select").log.splitlines()
                        if "registers" in ln or "spill" in ln or "entry function" in ln]
    for shape, n in WINDOW_SHAPES.items():
        acc, carry = window_pool(np, torch, dev, n)
        cur_d = acc._upload(carry, n)[-1]
        trip = torch.tensor([0, 0, 0, carry["cur0"]], dtype=torch.int64, device=dev)
        state = [acc._alive, acc._assign, acc._astep, acc._members, acc._msum, acc._crank0]
        acc._window(cur_d, None)   # the ranks of this state, as the loop has them
        saved = [t.clone() for t in state]

        def restore():
            for t, t0 in zip(state, saved):
                t.copy_(t0)

        if fused:
            issue = {"window": lambda: acc._sel.window(trip.data_ptr() + 24, trip.data_ptr()),
                     "seed": lambda: acc._sel.seed(7, n + 9)}
            step = {"window": lambda: acc._window(trip[3:], trip),
                    "seed": lambda: acc._seed_window(7, n + 9)}
        else:
            def old_seed(read):
                seed = (torch.searchsorted(acc._crank0, 1) - 1).view(1)
                acc._seed(seed, 7, n + 9)
                return acc._window(seed, None) if read else acc._window_ops(seed, None)

            issue = {"window": lambda: acc._window_ops(trip[3:], trip),
                     "seed": lambda: old_seed(False)}
            step = {"window": lambda: acc._window(trip[3:], trip),
                    "seed": lambda: old_seed(True)}
        reads = {}
        for mode in ("window", "seed"):
            restore()
            got = step[mode]()
            reads[mode] = list(got if mode == "window" else got[1] if fused else got)
            reads[mode].append(int(acc._cand[:reads[mode][4]].sum()))
            if fused:   # the kernel against its plain twin on the same state
                cand = acc._cand[:reads[mode][4]].clone()
                after = [t.clone() for t in state[:5]]
                restore()
                if mode == "window":
                    want = torch.cat(acc._window_ops(trip[3:], trip)).tolist()
                else:
                    seed = (torch.searchsorted(acc._crank0, 1) - 1).view(1)
                    acc._seed(seed, 7, n + 9)
                    want = torch.cat(acc._window_ops(seed, None)).tolist()
                if (want != reads[mode][:7] or not torch.equal(cand, acc._cand[:want[4]])
                        or not all(torch.equal(a, b) for a, b in zip(after, state[:5]))):
                    raise AssertionError(f"{root}: window_select differs from its plain "
                                         f"twin ({shape}, {mode}): {reads[mode]} != {want}")
            out["us"][f"{mode} {shape} device"] = device_us(issue[mode], setup=restore)
            walls = {"issue": [], "step": []}
            for _ in range(21):
                for kind, fn in (("issue", issue[mode]), ("step", step[mode])):
                    restore()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    walls[kind].append((time.perf_counter() - t0) * 1e6)
                    torch.cuda.synchronize()
            out["us"][f"{mode} {shape} issue"] = statistics.median(walls["issue"])
            out["us"][f"{mode} {shape} step"] = statistics.median(walls["step"])
        out["shapes"][shape] = dict(n=n, reads=reads)
    return out


def one_kmer(root: str) -> dict:
    """The k-mer kernel's timings of checkout `root` at KMER_SHAPES."""
    sys.path.insert(0, root)
    import time

    import numpy as np
    import torch

    import bench
    import meshclust2_tpu_torch
    assert os.path.dirname(os.path.dirname(meshclust2_tpu_torch.__file__)) == root
    from chip_smoke import bound_ms, cuda_ms
    from meshclust2_tpu_torch import native
    from meshclust2_tpu_torch.io.fasta import encode_sequence, read_fasta
    from meshclust2_tpu_torch.ops import _build
    from meshclust2_tpu_torch.ops.kmer_count import (kmer_count, kmer_count_ref,
                                                     kmer_windows, packed_on)
    from meshclust2_tpu_torch.parallel.mesh import device_build_counts

    dev = torch.device("cuda")
    built = _build.load("kmer_count")
    out = {"root": root, "card": torch.cuda.get_device_name(0), "fast_kernels": {},
           "ptxas": [ln.strip() for ln in built.log.splitlines()
                     if "registers" in ln or "spill" in ln or "entry function" in ln],
           "us": {}, "shapes": {}}
    k, dtype_max = 5, 255
    for shape, n_seqs in KMER_SHAPES.items():
        bench.N_SEQS = n_seqs
        fasta = os.path.join(root, "build", "ab", f"bench_{n_seqs}.fasta")
        os.makedirs(os.path.dirname(fasta), exist_ok=True)
        bench.ensure_dataset(fasta)
        recs = read_fasta(fasta)
        packing = native._pack_records(recs)
        packed = packed_on(packing, dev)
        got = kmer_count(*packed, k, dtype_max)
        want = kmer_count_ref(*packed, k, dtype_max)
        native_c, native_o = native.count_kmers_batch(recs, k, dtype_max)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                and np.array_equal(got[0].cpu().numpy(), native_c)
                and np.array_equal(got[1].cpu().numpy().astype(np.uint64), native_o)):
            raise AssertionError(f"{root}: kmer_count differs ({shape})")
        flat, _ = kmer_windows(*packed, k)
        d = 4 ** k
        nbytes = (sum(t.numel() * t.element_size() for t in packed)
                  + got[0].numel() * got[0].element_size() + got[1].numel() * 8)
        b_ms, b_by = bound_ms(nbytes, k * len(flat))
        out["us"][f"kmer_count {shape}"] = device_us(lambda: kmer_count(*packed, k, dtype_max))
        out["us"][f"plain {shape}"] = cuda_ms(lambda: kmer_count_ref(*packed, k, dtype_max),
                                              reps=3) * 1e3
        out["us"][f"bincount {shape}"] = device_us(
            lambda: torch.bincount(flat, minlength=len(recs) * d))
        # the counting part of set-up, host wall: the device build (packing,
        # copies, kernel, read-back) and the native counter, medians of 3
        walls = {}
        for name, fn in (("device_build_counts", lambda: device_build_counts(
                recs, k, dtype_max)), ("native", lambda: native.count_kmers_batch(
                    recs, k, dtype_max))):
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            walls[name] = statistics.median(times)
        out["shapes"][shape] = dict(n=len(recs), codes=int(packing[1][-1]),
                                    windows=len(flat), bytes=nbytes, bound_us=b_ms * 1e3,
                                    bound_by=b_by, counting_s=walls)
        if shape == "10k":
            bench_recs = recs
    # the shapes a record-per-block design serialises: a homopolymer (every
    # window in one bin), one 2 Mbp record (split at 1 Mbp), and 2,000 of
    # the 10k records at k = 8 (histograms past shared memory)
    rng = np.random.default_rng(KMER_SEED)
    for shape, recs, k_, dm in (
            ("homopolymer", [encode_sequence("homo", "A" * 999_999)], 5, 255),
            ("2mbp", [encode_sequence("long", "".join(rng.choice(list("ACGT"), 2_000_050)))],
             5, 255),
            ("k8", bench_recs[:2_000], 8, 65535)):
        packed = packed_on(native._pack_records(recs), dev)
        got = kmer_count(*packed, k_, dm)
        want = kmer_count_ref(*packed, k_, dm)
        native_c, native_o = native.count_kmers_batch(recs, k_, dm)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                and np.array_equal(got[0].cpu().numpy(), native_c)
                and np.array_equal(got[1].cpu().numpy().astype(np.uint64), native_o)):
            raise AssertionError(f"{root}: kmer_count differs ({shape})")
        flat, _ = kmer_windows(*packed, k_)
        nbytes = (sum(t.numel() * t.element_size() for t in packed)
                  + got[0].numel() * got[0].element_size() + got[1].numel() * 8)
        b_ms, b_by = bound_ms(nbytes, k_ * len(flat))
        out["us"][f"kmer_count {shape}"] = device_us(lambda: kmer_count(*packed, k_, dm))
        out["us"][f"bincount {shape}"] = device_us(
            lambda: torch.bincount(flat, minlength=len(recs) * 4 ** k_))
        out["shapes"][shape] = dict(n=len(recs), k=k_, codes=int(packed[1][-1]),
                                    windows=len(flat), bytes=nbytes, bound_us=b_ms * 1e3,
                                    bound_by=b_by)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--order", default=None)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--phase", action="store_true",
                      help="time the update phase's kernels at PHASE_SHAPES")
    mode.add_argument("--kmer", action="store_true",
                      help="time the k-mer histogram kernel at KMER_SHAPES")
    mode.add_argument("--block", action="store_true",
                      help="time the row-sharded session's step and pass sequences")
    mode.add_argument("--window", action="store_true",
                      help="time the accumulate step's window and seed at WINDOW_SHAPES")
    args = ap.parse_args(argv)
    flag = (["--phase"] if args.phase else ["--kmer"] if args.kmer
            else ["--block"] if args.block else ["--window"] if args.window else [])
    if args.one:
        run = (one_phase if args.phase else one_kmer if args.kmer
               else one_block if args.block else one_window if args.window else one)
        print(json.dumps(run(os.path.abspath(args.roots[0]))), flush=True)
        return 0
    roots = [os.path.abspath(r) for r in args.roots]
    order = ([int(i) for i in args.order.split(",")] if args.order
             else list(range(len(roots))) + list(range(len(roots)))[::-1])
    runs = []
    for i in order:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", roots[i]]
                              + flag,
                              cwd=roots[i], capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-6000:], sep="\n", file=sys.stderr)
            raise SystemExit(f"kernel_ab: the run of {roots[i]} exited {proc.returncode}")
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append(got)
        extra = (f"shapes {got['shapes']}" if flag
                 else f"plane store {got['plane_store_bytes']:,} bytes")
        print(f"run {len(runs)}: {roots[i]}: " + ", ".join(
            f"{k} {v:.2f}" for k, v in got["us"].items()) + f"; {extra}; {got['card']}",
            flush=True)
    # a cached build has no ptxas log: its resources are compared where
    # both runs compiled
    ok = True
    if flag:
        for root in roots:
            print(f"ptxas, {root}: " + "; ".join(next(
                (r["ptxas"] for r in runs if r["root"] == root and r["ptxas"]), [])))
    first = runs[0]["fast_kernels"]
    for r in runs[1:]:
        mine = r["fast_kernels"]
        diff = sorted(k for k in set(first) | set(mine)
                      if k not in first or k not in mine or first[k][1] != mine[k][1]
                      or (first[k][0] and mine[k][0] and first[k][0] != mine[k][0]))
        if diff:
            print(f"fast instantiations differ ({r['root']} vs {runs[0]['root']}): {diff}")
            ok = False
    if args.window:
        for r in runs[1:]:
            if r["shapes"] != runs[0]["shapes"]:
                print(f"the windows' reads differ ({r['root']} vs {runs[0]['root']})")
                ok = False
    if not flag:
        print(f"fast instantiations (count type, NV, NARROW): {len(first)}, same SASS and "
              f"ptxas resources in every run: {ok}; " + "; ".join(
                  f"{k}: {v[0]}" for k, v in sorted(first.items())), flush=True)
    for root in roots:
        mine = [r for r in runs if r["root"] == root]
        print(f"median device us, {root}: " + ", ".join(
            f"{k} {statistics.median(r['us'][k] for r in mine):.2f}" for k in mine[0]["us"]))
    print(json.dumps(runs))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(runs, f)
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
