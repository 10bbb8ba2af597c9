#!/usr/bin/env python3
"""The redesigned kernels' device times in several checkouts of the
repository, on one card, in turns.

    python3 kernel_ab.py ROOT [ROOT ...] [--order 0,1,1,0] [--out FILE] [--phase | --kmer]

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
fast kernels can be compared.  The runs go in the order `--order` gives
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


def device_us(fn, reps: int = 20) -> float:
    """Median device time in us of fn()'s launches, each queued behind a
    busy wait on the card (chip_smoke.py:device_us)."""
    import torch

    times = []
    for i in range(reps + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
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
    args = ap.parse_args(argv)
    flag = ["--phase"] if args.phase else ["--kmer"] if args.kmer else []
    if args.one:
        run = one_phase if args.phase else one_kmer if args.kmer else one
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
        extra = (f"shapes {got['shapes']}" if args.phase or args.kmer
                 else f"plane store {got['plane_store_bytes']:,} bytes")
        print(f"run {len(runs)}: {roots[i]}: " + ", ".join(
            f"{k} {v:.2f}" for k, v in got["us"].items()) + f"; {extra}; {got['card']}",
            flush=True)
    # a cached build has no ptxas log: its resources are compared where
    # both runs compiled
    ok = True
    if args.phase or args.kmer:
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
    if not (args.phase or args.kmer):
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
