#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from meshclust2_tpu_torch/csrc (one nvcc
per source, in parallel), holds each against its plain PyTorch version and
a numpy reference, times both at the main path's shapes beside the least
time the card could take (its bound), then clusters med2000 and the
10,000-sequence bench dataset through `meshclust2_tpu_torch.cli` on the
card, on its three paths: the default (TorchDeviceAccumulator and
TorchDeviceUpdater), MC2_NO_DEVICE_LOOP=1 (the accumulate windows through
TorchDeviceScorer) and MC2_NO_DEVICE_LOOP=1 MC2_NO_DEVICE_UPDATE_BATCH=1
(both phases through the scorer).  Each run is checked against its
reference CLSTR and engine counters, and each path's kernel launches are
counted from zero.  Then it trains on the 10k set at the default flags
(the pair tables through the pair-statistics kernel) and clusters it with
the trained model, and holds the weights and the CLSTR against the JAX
package's `--device host` training and host engine.  A torch.profiler run
of the default path gives the device's busy share.  The JAX package runs
only as a separate program (`--device host`, its native host path), on the
same file, as the reference on the same machine.

Each phase prints one line; any failure raises and exits non-zero.  The
line before the last is the kernels' JSON record, and the last line is
{"ok": true, "device": {...}}.  Without a usable CUDA card, or run from a
directory that holds nothing else of the repository, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import gzip
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(ROOT, "tests", "fixtures")

# the port's three paths and the switches (the JAX package's own) that
# select them
PATHS = {
    "default": {},
    "no_device_loop": {"MC2_NO_DEVICE_LOOP": "1"},
    "no_device_loop_no_update_batch": {"MC2_NO_DEVICE_LOOP": "1",
                                       "MC2_NO_DEVICE_UPDATE_BATCH": "1"},
}
# engine counters of the recover path (windows scored, pairs scored,
# clusters before the update phase, update iterations), as the JAX
# package's sessionless device configurations count them: its
# DeviceAccumulator and DeviceUpdater (the default path); its DeviceScorer
# windows and DeviceUpdater (MC2_NO_DEVICE_LOOP=1); and with
# MC2_NO_DEVICE_UPDATE_BATCH=1 too, every update pair through the scorer and
# the engine's memo (the counters of the native host scorer)
MED2000_COUNTERS = {"default": (146, 165_218, 305, 6),
                    "no_device_loop": (146, 152_619, 305, 6),
                    "no_device_loop_no_update_batch": (146, 62_376, 305, 6)}
MED2000_UPDATER_PAIRS = 116_481
BENCH10K_COUNTERS = {"default": (590, 1_635_533, 1_147, 7),
                     "no_device_loop": (590, 1_386_736, 1_147, 7),
                     "no_device_loop_no_update_batch": (590, 789_698, 1_147, 7)}
BENCH10K_UPDATER_PAIRS = 708_385
BENCH10K_CLUSTERS = 788
# the accumulator's (steps, windows, pairs), as the JAX DeviceAccumulator
# counts them (med2000: its --device host MC2_DEVICE_LOOP=1 run; 10k: the
# BENCH_r05.json tail)
MED2000_ACC = (393, 146, 48_737)
BENCH10K_ACC = (1_503, 590, 927_148)
MARGIN, TIE_MARGIN = 1e-8, 1e-12
KERNELS = ("pair_stats", "closest_mean", "window_absorb")
# the training run of this slice: the JAX CLI's default training flags
TRAIN_FLAGS = ["--id", "0.9", "--kmer", "5", "--feat", "fast",
               "--sample", "2000", "--num-templates", "300"]
# the card's peak rates (NVIDIA's H100 SXM data sheet, at 700 W): HBM
# bytes per second, and the float32
# rate outside the tensor cores, the one non-tensor rate the table gives,
# taken for the kernels' integer and float64 operations too (no lower than
# their own rates, so the bound stays a lower bound on the time)
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
# pair statistics, per pair and element: min, add, multiply, add, subtract,
# prefix add, abs, add
PAIR_OPS = 8
# closest-to-mean, per kept row and element: min against the rounded mean,
# add, the truncated sum with the mean, add
CLOSEST_OPS = 4


def phase(tag: str, msg: str) -> None:
    print(f"[{tag}] {msg}", flush=True)


def read_clstr(path: str) -> list:
    """CLSTR file -> clusters, each a list of (header, is_center)."""
    clusters = []
    with open(path) as f:
        for line in f:
            if line.startswith(">Cluster"):
                clusters.append([])
            elif line.strip():
                rest = line.rstrip("\n").split("\t", 1)[1].split("nt, ", 1)[1]
                clusters[-1].append((rest[:rest.rfind("... ")],
                                     rest.rstrip().endswith("*")))
    return clusters


def signature(clusters):
    """Membership and centers per cluster (tests/test_parity_10k.py)."""
    return sorted(
        (frozenset(h for h, _ in c), tuple(sorted(h for h, star in c if star)))
        for c in clusters)


def cuda_ms(fn, reps: int, warm: int = 3) -> float:
    """Median device time of fn() in ms over `reps` runs, by CUDA events."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def tbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound_ms(nbytes: float, ops: float):
    """(the least time in ms, what bounds it): the bytes over the card's
    memory rate or the operations over its peak rate, the larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pair_stats_bound(store, a, b):
    """Each referenced row read once, the indices read, [P, 3] int64
    written; PAIR_OPS per pair and element."""
    rows = int(torch_unique(a, b))
    d = store.shape[1]
    return bound_ms(rows * d * store.element_size() + tbytes(a, b)
                    + 24 * len(a), PAIR_OPS * len(a) * d)


def torch_unique(*ts) -> int:
    import torch

    return torch.unique(torch.cat(ts)).numel()


def counters(res):
    s = res.engine.stats
    return (s.windows_scored, s.pairs_scored, s.clusters_before_update,
            s.update_iterations)


def acc_counts(res):
    acc = res.accumulator
    return acc.total_steps, acc.last_windows, acc.last_pairs


def window(clock_stamps) -> float:
    return clock_stamps["done"] - clock_stamps["read_in_points"]


def window_parts(stamps, n: int) -> str:
    """The clustering window and its accumulate and update parts, in
    seconds and sequences per second."""
    total = window(stamps)
    acc = stamps["accumulate"] - stamps["read_in_points"]
    upd = stamps["update"] - stamps["accumulate"]
    return (f"window {total:.3f} s = {n / total:.1f} seqs/s (accumulate "
            f"{acc:.3f} s, update {upd:.3f} s)")


def run_path(torch_cli, path: str, argv):
    """cli.run on one of the port's paths (PATHS)."""
    os.environ.update(PATHS[path])
    try:
        return torch_cli.run(argv)
    finally:
        for k in PATHS[path]:
            os.environ.pop(k, None)


def segments(rng, n_rows: int, n_segs: int, mean_size: int):
    """Ragged nondecreasing segments over random rows: empty and one-row
    segments among them, rows repeated inside a segment (exact ties), and
    80 % of the pairs kept."""
    sizes = rng.integers(0, 2 * mean_size, n_segs)
    sizes[rng.choice(n_segs, n_segs // 6, replace=False)] = 0
    sizes[rng.choice(n_segs, n_segs // 6, replace=False)] = 1
    seg = np.repeat(np.arange(n_segs), sizes)
    rows = rng.integers(0, n_rows, len(seg))
    dup = rng.choice(len(seg) - 1, len(seg) // 8, replace=False)
    dup = dup[seg[dup + 1] == seg[dup]]
    rows[dup + 1] = rows[dup]
    return rows.astype(np.int64), seg.astype(np.int64), rng.random(len(seg)) < 0.8


def absorb_window(rng, n_rows: int, n_cand: int, edge: float):
    """One window for window_absorb: candidate rows with repeats, sums on,
    one ulp off and just inside the margin of the edge, dists with exact
    ties between repeated rows, equal dists of different rows and near
    ties within the tie margin."""
    rows = rng.integers(0, n_rows, n_cand).astype(np.int64)
    s = rng.normal(edge, 2.0, n_cand)
    dist = rng.random(n_cand)
    s[np.abs(s - edge) < 1e-6] += 1e-3    # no accidental near-edge sums
    if n_cand <= 8:
        return rows, s, dist
    on_edge, copy, tie = rng.random(3) < 0.6
    if on_edge:
        s[::7] = edge
        s[1::11] = np.nextafter(edge, -np.inf)
        s[2::13] = edge + 0.5 * MARGIN * max(abs(edge), 1.0)
    top = int(np.argmax(dist))
    if copy:
        rows[-1] = rows[top]
        dist[-1] = dist[top]                        # an exact copy
    if tie:
        if rng.random() < 0.5:
            dist[n_cand // 2] = dist[top]           # other inputs, equal dist
        else:
            dist[n_cand // 3] = dist[top] * (1 - 0.3 * TIE_MARGIN)
    return rows, s, dist


def profile_path(torch_cli, path: str, argv):
    """One run of `path` with torch.profiler around engine.run (the
    clustering window): the run, the profiled window's wall time, and the
    device time (us) and event count by kernel or copy name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine_cls = torch_cli.MeanShiftEngine
    real = engine_cls.run
    held = {}

    def profiled(self, *args, **kw):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = real(self, *args, **kw)
            torch.cuda.synchronize()
            held["wall"] = time.perf_counter() - t0
        held["prof"] = prof
        return out

    engine_cls.run = profiled
    try:
        res = run_path(torch_cli, path, argv)
    finally:
        engine_cls.run = real
    by_name = Counter()
    launches = Counter()
    for e in held["prof"].events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us()
            launches[e.name] += 1
    return res, held["wall"], by_name, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from meshclust2_tpu_torch import cli as torch_cli
    from meshclust2_tpu_torch.cluster.engine import distance_d
    from meshclust2_tpu_torch.model.weights import load_weights
    from meshclust2_tpu_torch.ops import _build
    from meshclust2_tpu_torch.ops.closest_mean import closest_mean, closest_mean_ref
    from meshclust2_tpu_torch.ops.pair_stats import (
        center_block_stats, pair_stats, pair_stats_ref)
    from meshclust2_tpu_torch.ops.window_absorb import (
        window_absorb, window_absorb_ref)
    from meshclust2_tpu_torch.runtime import card_name_and_power, resolve_device

    wrappers = {"pair_stats": pair_stats, "closest_mean": closest_mean,
                "window_absorb": window_absorb}
    dev = resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)

    # (a) the card and the toolchain
    card = card_name_and_power()
    print(card, flush=True)
    nvcc_v = subprocess.run([_build.nvcc_path(), "--version"],
                            capture_output=True, text=True, check=True).stdout
    phase("a", f"card: {card}; torch {torch.__version__}, CUDA "
               f"{torch.version.cuda}, nvcc {nvcc_v.strip().splitlines()[-1]}, "
               f"python {sys.version.split()[0]}")

    # (b) the builds, one nvcc per source, started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        builds = dict(zip(KERNELS, pool.map(_build.load, KERNELS)))
    for built in builds.values():
        ptxas = "; ".join(ln.strip() for ln in built.log.splitlines()
                          if "registers" in ln or "spill" in ln)
        phase("b", f"built {os.path.relpath(built.path, ROOT)} (nvcc "
                   f"{built.seconds:.3f} s); ptxas: {ptxas}")
    phase("b", f"{len(builds)} builds in {time.perf_counter() - t0:.3f} s")

    # (c) kernel = plain version = int64 oracle, bit for bit
    def oracle(counts, a, b):
        h = counts[a].astype(np.int64)
        c = counts[b].astype(np.int64)
        return np.stack([np.minimum(h, c).sum(1), (h * c).sum(1),
                         np.abs(np.cumsum(h - c, axis=1)).sum(1)], axis=1)

    rng = np.random.default_rng(20261016)
    max_err = 0
    n_cases = 0
    for dtype in (np.uint8, np.uint16):
        for d in (16, 256, 1024, 4096):
            n = 333
            counts = rng.integers(0, np.iinfo(dtype).max + 1, (n, d)).astype(dtype)
            c_d = torch.from_numpy(counts).to(dev)
            center = int(rng.integers(0, n))
            forms = {
                "center": (np.arange(n - 2, dtype=np.int64),
                           np.full(n - 2, center, dtype=np.int64)),
                "pair": (rng.integers(0, n, 1001), rng.integers(0, n, 1001)),
            }
            for form, (a, b) in forms.items():
                a_d = torch.from_numpy(a).to(dev)
                b_d = torch.from_numpy(b).to(dev)
                got = pair_stats(c_d, a_d, b_d)
                torch.cuda.synchronize()
                plain = pair_stats_ref(c_d, a_d, b_d)
                want = torch.from_numpy(oracle(counts, a, b))
                if not (torch.equal(got, plain) and torch.equal(got.cpu(), want)):
                    raise AssertionError(f"pair_stats differs: {dtype.__name__} "
                                         f"D={d} {form} form")
                max_err = max(max_err, int((got - plain).abs().max()))
                n_cases += 1
            block = center_block_stats(c_d[:n - 2], c_d[center])
            torch.cuda.synchronize()
            if not torch.equal(block.cpu(), torch.from_numpy(
                    oracle(counts, np.arange(n - 2), np.full(n - 2, center)))):
                raise AssertionError(f"center_block_stats differs: "
                                     f"{dtype.__name__} D={d}")
            n_cases += 1
    phase("c", f"kernel == plain == int64 oracle bit for bit in {n_cases} "
               f"cases (uint8/uint16, D in 16/256/1024/4096, center and pair "
               f"forms, ragged P)")

    # (c2) closest_mean kernel = plain version (first and unc) = a numpy
    # reference (distance_d over each segment's kept rows, first strict
    # minimum) wherever unc is False
    def closest_ref(counts, rows, seg, keep, n_segs):
        first = np.full(n_segs, len(rows), np.int64)
        for c in range(n_segs):
            pos = np.nonzero((seg == c) & keep)[0]
            if len(pos):
                cg = counts[rows[pos]]
                first[c] = pos[int(np.argmin(distance_d(
                    cg, cg.astype(np.float64).mean(axis=0))))]
        return first

    def closest_args(counts, rows, seg, keep):
        mags = counts.sum(axis=1, dtype=np.int64).astype(np.float64)
        return [torch.from_numpy(a).to(dev) for a in (counts, mags, rows, seg, keep)]

    cm_err = 0
    n_cases = n_unc = 0
    for dtype in (np.uint8, np.uint16):
        for d in (16, 256, 1024, 4096):
            counts = rng.integers(0, np.iinfo(dtype).max + 1, (300, d)).astype(dtype)
            rows, seg, keep = segments(rng, 300, 77, 20)
            args = closest_args(counts, rows, seg, keep)
            if dtype == np.uint8 and d == 256:
                # a store that starts off a 16-byte boundary: the bin-wise path
                raw = torch.empty(counts.nbytes + 1, dtype=torch.uint8, device=dev)
                args[0] = raw[1:].view(300, d).copy_(args[0])
            kw = dict(maxc=int(counts.max()), tie_margin=TIE_MARGIN)
            first, unc = closest_mean(*args, 77, **kw)
            torch.cuda.synchronize()
            p_first, p_unc = closest_mean_ref(*args, 77, **kw)
            want = closest_ref(counts, rows, seg, keep, 77)
            f, u = first.cpu().numpy(), unc.cpu().numpy()
            if not (torch.equal(first, p_first) and torch.equal(unc, p_unc)
                    and np.array_equal(f[~u], want[~u])):
                raise AssertionError(f"closest_mean differs: {dtype.__name__} D={d}")
            cm_err = max(cm_err, int((first - p_first).abs().max()))
            n_cases += 1
            n_unc += int(u.sum())
    phase("c2", f"closest_mean kernel == plain (first, unc) == numpy distance_d "
                f"argmin in {n_cases} cases (uint8/uint16, D in 16/256/1024/4096, "
                f"77 ragged segments with empty, one-row and duplicated rows, an "
                f"unaligned store); {n_unc} segments uncertain")

    # (c3) the one-segment mode = its plain version = the segmented kernel
    # on the same rows as one segment = the numpy reference where certain
    n_cases = n_unc = 0
    for dtype in (np.uint8, np.uint16):
        for d in (16, 256, 1024, 4096):
            counts = rng.integers(0, np.iinfo(dtype).max + 1, (300, d)).astype(dtype)
            for n_pairs in (1, 700, 20_000):
                rows = rng.integers(0, 300, n_pairs).astype(np.int64)
                rows[1::9] = rows[::9][:len(rows[1::9])]
                keep = rng.random(n_pairs) < 0.9
                keep[0] = True
                seg = np.zeros(n_pairs, np.int64)
                args = closest_args(counts, rows, seg, keep)
                one = dict(col_sum=torch.from_numpy(
                    counts[rows[keep]].astype(np.int64).sum(axis=0)).to(dev),
                    count=torch.tensor([int(keep.sum())], device=dev))
                kw = dict(maxc=int(counts.max()), tie_margin=TIE_MARGIN)
                got = closest_mean(args[0], args[1], args[2], None, args[4], 1,
                                   **kw, **one)
                segd = closest_mean(*args, 1, **kw)
                torch.cuda.synchronize()
                plain = closest_mean_ref(args[0], args[1], args[2], None,
                                         args[4], 1, **kw, **one)
                u = bool(got[1].item())
                if not all(torch.equal(g, s) and torch.equal(g, p)
                           for g, s, p in zip(got, segd, plain)):
                    raise AssertionError(f"closest_mean one-segment differs: "
                                         f"{dtype.__name__} D={d} P={n_pairs}")
                if not u and got[0].item() != closest_ref(counts, rows, seg,
                                                          keep, 1)[0]:
                    raise AssertionError(f"closest_mean one-segment != numpy: "
                                         f"{dtype.__name__} D={d} P={n_pairs}")
                cm_err = max(cm_err, int((got[0] - plain[0]).abs().max()))
                n_cases += 1
                n_unc += u
    phase("c3", f"closest_mean one-segment kernel == plain == segmented kernel "
                f"(first, unc) == numpy distance_d argmin in {n_cases} cases "
                f"(uint8/uint16, D in 16/256/1024/4096, P in 1/700/20,000 with "
                f"repeated and unkept rows); {n_unc} uncertain")

    # (c4) window_absorb kernel = plain version bit for bit (pos, colsum,
    # bits, npos, best) on ragged windows with exact ties, near ties and
    # sums on the edge
    wa_err = 0
    n_cases = 0
    bits_seen = Counter()
    for dtype in (np.uint8, np.uint16):
        for d in (16, 256, 1024, 4096):
            n = 333
            counts = rng.integers(0, np.iinfo(dtype).max + 1, (n, d)).astype(dtype)
            c_d = torch.from_numpy(counts).to(dev)
            moments = [torch.from_numpy(rng.integers(1, 30, n).astype(np.float64)).to(dev)
                       for _ in range(4)]
            for n_cand in (1, 63, 2_048, int(rng.integers(100, 3_000))):
                edge = float(rng.normal(0.0, 1.0))
                rows, s, dist = absorb_window(rng, n, n_cand, edge)
                r_d = torch.from_numpy(rows).to(dev)
                center = torch.full_like(r_d, int(rng.integers(0, n)))
                stats = pair_stats(c_d, r_d, center)
                args = [c_d, r_d, torch.from_numpy(s).to(dev),
                        torch.from_numpy(dist).to(dev), stats, *moments]
                kw = dict(pos_edge=edge, margin=MARGIN, tie_margin=TIE_MARGIN)
                got = window_absorb(*args, **kw)
                torch.cuda.synchronize()
                plain = window_absorb_ref(*args, **kw)
                if not all(torch.equal(g, p) for g, p in zip(got, plain)):
                    raise AssertionError(f"window_absorb differs: {dtype.__name__} "
                                         f"D={d} W={n_cand}")
                wa_err = max(wa_err, int((got[1] - plain[1]).abs().max()),
                             int((got[2] - plain[2]).abs().max()))
                bits_seen[int(got[2][0])] += 1
                n_cases += 1
    phase("c4", f"window_absorb kernel == plain (pos, colsum, bits, npos, best) "
                f"bit for bit in {n_cases} windows (uint8/uint16, D in "
                f"16/256/1024/4096, W in 1/63/2,048/ragged, sums on and one ulp "
                f"off the edge, exact and near dist ties); bits seen "
                f"{dict(sorted(bits_seen.items()))}")

    # (d) kernel vs plain version at the main path's shapes: a 10,000-row
    # uint8 store at D = 1,024 (k = 5), center form P = 2,048, pair form
    # P = 98,304 (the largest update batch)
    store = torch.from_numpy(
        rng.integers(1, 40, (10_000, 1024)).astype(np.uint8)).to(dev)
    # and the training tables' shape: P = 2,200 pairs (one table at the
    # default flags) over a store of the 10,000 points and 2,200 mutants
    store_t = torch.from_numpy(
        rng.integers(1, 40, (12_200, 1024)).astype(np.uint8)).to(dev)
    shapes = {
        "center": (store, torch.arange(3_000, 5_048, device=dev),
                   torch.full((2_048,), 4_000, dtype=torch.int64, device=dev)),
        "pair": (store, torch.from_numpy(rng.integers(0, 10_000, 98_304)).to(dev),
                 torch.from_numpy(rng.integers(0, 10_000, 98_304)).to(dev)),
        "train": (store_t, torch.from_numpy(rng.integers(0, 10_000, 2_200)).to(dev),
                  torch.from_numpy(rng.integers(10_000, 12_200, 2_200)).to(dev)),
    }
    timing = {}
    for form, (st_d, a_d, b_d) in shapes.items():
        got = pair_stats(st_d, a_d, b_d)
        plain = pair_stats_ref(st_d, a_d, b_d)
        torch.cuda.synchronize()
        if not torch.equal(got, plain):
            raise AssertionError(f"pair_stats differs at the {form} main-path shape")
        max_err = max(max_err, int((got - plain).abs().max()))
        k_ms = cuda_ms(lambda: pair_stats(st_d, a_d, b_d), reps=50)
        p_ms = cuda_ms(lambda: pair_stats_ref(st_d, a_d, b_d), reps=10)
        b_ms, b_by = pair_stats_bound(st_d, a_d, b_d)
        timing[form] = (k_ms, p_ms, b_ms, b_by)
        phase("d", f"{form} form P={len(a_d)} N={len(st_d)} D=1024 uint8: "
                   f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms (median, CUDA "
                   f"events), bound {b_ms:.4f} ms ({b_by}); {card}")

    # (d2) closest_mean vs its plain version at the update phase's shape:
    # the same store, P = 98,304 pairs (the largest update batch) in 1,000
    # segments of uneven size
    n_pairs, n_segs = 98_304, 1_000
    cuts = np.sort(rng.integers(0, n_pairs + 1, n_segs - 1))
    seg = np.searchsorted(cuts, np.arange(n_pairs), side="right").astype(np.int64)
    rows = rng.integers(0, 10_000, n_pairs)
    keep = rng.random(n_pairs) < 0.8
    mags = store.sum(dim=1, dtype=torch.int64).to(torch.float64)
    cm_args = [store, mags] + [torch.from_numpy(a).to(dev) for a in (rows, seg, keep)]
    kw = dict(maxc=int(store.max()), tie_margin=TIE_MARGIN)
    got = closest_mean(*cm_args, n_segs, **kw)
    plain = closest_mean_ref(*cm_args, n_segs, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])):
        raise AssertionError("closest_mean differs at the main-path shape")
    cm_k = cuda_ms(lambda: closest_mean(*cm_args, n_segs, **kw), reps=50)
    cm_p = cuda_ms(lambda: closest_mean_ref(*cm_args, n_segs, **kw), reps=10)

    def closest_bound(rows_d, keep_d, extra):
        """The kept rows read once with their mags, the row list and keep
        flags read, `extra` bytes more; CLOSEST_OPS per kept row and
        element, plus the mean."""
        kept = rows_d[keep_d]
        uniq = torch_unique(kept)
        d = store.shape[1]
        return bound_ms(uniq * (d + 8) + tbytes(rows_d, keep_d) + extra,
                        CLOSEST_OPS * len(kept) * d + 2 * d)

    cm_b, cm_by = closest_bound(cm_args[2], cm_args[4],
                                tbytes(cm_args[3]) + 9 * n_segs)
    phase("d2", f"closest_mean P={len(rows)} C={n_segs} D=1024 uint8: kernel "
                f"{cm_k:.4f} ms, plain {cm_p:.4f} ms (median, CUDA events), "
                f"bound {cm_b:.4f} ms ({cm_by}); {card}")

    # (d3) the one-segment mode at the accumulate loop's largest shape: one
    # segment of 98,304 rows of the same store, 90 % kept; beside it the
    # segmented kernel given the same rows as one segment
    keep1 = torch.from_numpy(rng.random(n_pairs) < 0.9).to(dev)
    rows1 = cm_args[2]
    seg1 = torch.zeros(n_pairs, dtype=torch.int64, device=dev)
    one = dict(col_sum=(store[rows1].to(torch.int64) * keep1[:, None]).sum(dim=0),
               count=keep1.sum(dtype=torch.int64).view(1))
    got = closest_mean(store, mags, rows1, None, keep1, 1, **kw, **one)
    plain = closest_mean_ref(store, mags, rows1, None, keep1, 1, **kw, **one)
    segd = closest_mean(store, mags, rows1, seg1, keep1, 1, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(g, p) and torch.equal(g, s)
               for g, p, s in zip(got, plain, segd)):
        raise AssertionError("closest_mean one-segment differs at P = 98,304")
    one_k = cuda_ms(lambda: closest_mean(store, mags, rows1, None, keep1, 1,
                                         **kw, **one), reps=50)
    one_p = cuda_ms(lambda: closest_mean_ref(store, mags, rows1, None, keep1, 1,
                                             **kw, **one), reps=10)
    one_s = cuda_ms(lambda: closest_mean(store, mags, rows1, seg1, keep1, 1, **kw),
                    reps=10)
    one_b, one_by = closest_bound(rows1, keep1, tbytes(one["col_sum"]) + 17)
    phase("d3", f"closest_mean one segment P={n_pairs} D=1024 uint8: one-segment "
                f"kernel {one_k:.4f} ms, plain {one_p:.4f} ms, segmented kernel "
                f"{one_s:.4f} ms (median, CUDA events), bound {one_b:.4f} ms "
                f"({one_by}); {card}")

    # (d4) window_absorb at the accumulate scan's shape: W = 2,048
    # candidates of the same store against one center, ~10 % positive
    r_w = torch.arange(3_000, 5_048, device=dev)
    st_w = pair_stats(store, r_w, torch.full_like(r_w, 4_000))
    wa_args = [store, r_w,
               torch.from_numpy(rng.normal(-2.5, 2.0, 2_048)).to(dev),
               torch.from_numpy(rng.random(2_048)).to(dev), st_w, mags,
               *(torch.from_numpy(rng.random(10_000)).to(dev) for _ in range(3))]
    wa_kw = dict(pos_edge=0.0, margin=MARGIN, tie_margin=TIE_MARGIN)
    got = window_absorb(*wa_args, **wa_kw)
    plain = window_absorb_ref(*wa_args, **wa_kw)
    torch.cuda.synchronize()
    if not all(torch.equal(g, p) for g, p in zip(got, plain)):
        raise AssertionError("window_absorb differs at the main-path shape")
    wa_k = cuda_ms(lambda: window_absorb(*wa_args, **wa_kw), reps=50)
    wa_p = cuda_ms(lambda: window_absorb_ref(*wa_args, **wa_kw), reps=10)
    # what this window needs: per candidate its row index, s, dist,
    # statistics and four moments; the positives' rows for the column sums;
    # the pos flags, column sums and info written; ~20 operations a
    # candidate and one add per positive element
    n_pos = int(got[2][1])
    wa_b, wa_by = bound_ms(2_048 * (8 + 8 + 8 + 24 + 4 * 8 + 1)
                           + n_pos * 1024 + 1024 * 8 + 24,
                           20 * 2_048 + n_pos * 1024)
    phase("d4", f"window_absorb W=2048 D=1024 uint8, {n_pos} positive: "
                f"kernel {wa_k:.4f} ms, plain {wa_p:.4f} ms (median, CUDA "
                f"events), bound {wa_b:.6f} ms ({wa_by}); {card}")

    def check_launches(path, counted):
        need = {"default": KERNELS, "no_device_loop": ("pair_stats", "closest_mean"),
                "no_device_loop_no_update_batch": ("pair_stats",)}[path]
        for name in need:
            if counted[name] <= 0:
                raise AssertionError(f"the {path} path launched no {name} kernel")
        if path != "default" and counted["window_absorb"]:
            raise AssertionError(f"the {path} path launched window_absorb")

    def check_accumulator(res, path, want_acc):
        """The default path ran the accumulator: steps, no scorer pairs;
        without aborts, the JAX DeviceAccumulator's counts."""
        acc = res.accumulator
        if path != "default":
            if acc is not None:
                raise AssertionError(f"the {path} path built an accumulator")
            return "no accumulator"
        if acc.total_steps <= 0 or acc.error is not None:
            raise AssertionError(f"accumulator did not run: {acc.total_steps} "
                                 f"steps, error {acc.error!r}")
        if res.scorer.scored_pairs != 0:
            raise AssertionError(f"the default path scored "
                                 f"{res.scorer.scored_pairs} pairs by the scorer")
        if acc.aborts == 0 and acc_counts(res) != want_acc:
            raise AssertionError(f"accumulator (steps, windows, pairs) "
                                 f"{acc_counts(res)} != {want_acc}")
        return (f"accumulator steps {acc.total_steps}, windows "
                f"{acc.last_windows}, pairs {acc.last_pairs}, aborts {acc.aborts}")

    with tempfile.TemporaryDirectory(prefix="mc2_smoke_") as tmp:
        # (e) med2000 through the port's CLI on the card, on its three paths
        # (cli.run is cli.main's body, returning the engine beside the code)
        for path in PATHS:
            out = os.path.join(tmp, f"med2000_{path}.clstr")
            res = run_path(torch_cli, path, [
                "--device", "cuda", "--recover",
                os.path.join(FIX, "med2000_weights.txt"), "--output", out,
                os.path.join(FIX, "med2000.fasta")])
            if res.rc != 0:
                raise AssertionError(f"port CLI exited {res.rc} on med2000 ({path})")
            with open(out) as f, open(os.path.join(FIX, "med2000_ref.clstr")) as g:
                if sorted(f.readlines()) != sorted(g.readlines()):
                    raise AssertionError(f"med2000 CLSTR differs from "
                                         f"med2000_ref.clstr ({path})")
            acc_line = check_accumulator(res, path, MED2000_ACC)
            aborted = res.accumulator is not None and res.accumulator.aborts
            if not aborted and counters(res) != MED2000_COUNTERS[path]:
                raise AssertionError(f"med2000 counters {counters(res)} != "
                                     f"{MED2000_COUNTERS[path]} ({path})")
            upd = "no updater" if res.updater is None else \
                f"updater pairs {res.updater.scored_pairs}"
            if res.updater is not None and \
                    res.updater.scored_pairs != MED2000_UPDATER_PAIRS:
                raise AssertionError(f"med2000 {upd} != {MED2000_UPDATER_PAIRS}")
            phase("e", f"med2000 ({path}): sorted CLSTR == med2000_ref.clstr, "
                       f"counters {counters(res)}, {acc_line}, {upd}, "
                       f"{window_parts(res.clock.stamps, 2000)}")

        # (f) the 10k bench dataset on each path, each one's launches counted
        # from zero; the default path is the slice's main path
        import bench

        fasta = os.path.join(tmp, "bench_10000.fasta")
        if bench.N_SEQS != 10_000 or bench.SEED != 424242:
            raise AssertionError("BENCH_N_SEQS / seed overridden")
        bench.ensure_dataset(fasta)
        weights = os.path.join(FIX, "bench10k_weights.txt")
        ref_path = os.path.join(tmp, "ref.clstr")
        with gzip.open(os.path.join(FIX, "bench10k_ref_t1.clstr.gz"), "rb") as f, \
                open(ref_path, "wb") as g:
            g.write(f.read())
        ref_sig = signature(read_clstr(ref_path))
        argv = ["--device", "cuda", "--recover", weights, "--output", None, fasta]
        launches = {}
        for path in PATHS:
            argv[5] = os.path.join(tmp, f"bench10k_{path}.clstr")
            for fn in wrappers.values():
                fn.launches = 0
            res = run_path(torch_cli, path, argv)
            launches[path] = {name: fn.launches for name, fn in wrappers.items()}
            if res.rc != 0:
                raise AssertionError(f"port CLI exited {res.rc} on the 10k "
                                     f"dataset ({path})")
            check_launches(path, launches[path])
            got = read_clstr(argv[5])
            if len(got) != BENCH10K_CLUSTERS or signature(got) != ref_sig:
                raise AssertionError(f"10k signature differs ({len(got)} "
                                     f"clusters, {path})")
            acc_line = check_accumulator(res, path, BENCH10K_ACC)
            aborted = res.accumulator is not None and res.accumulator.aborts
            if not aborted and counters(res) != BENCH10K_COUNTERS[path]:
                raise AssertionError(f"10k counters {counters(res)} != "
                                     f"{BENCH10K_COUNTERS[path]} ({path})")
            if res.updater is not None:
                if res.updater.scored_pairs != BENCH10K_UPDATER_PAIRS:
                    raise AssertionError(f"10k updater pairs "
                                         f"{res.updater.scored_pairs} != "
                                         f"{BENCH10K_UPDATER_PAIRS}")
                upd = (f"updater pairs {res.updater.scored_pairs}, re-checked "
                       f"{res.updater.rechecked_pairs}")
            else:
                upd = "no updater"
            phase("f", f"bench 10k ({path}): signature == bench10k_ref_t1 "
                       f"({len(got)} clusters), counters {counters(res)}; "
                       f"{window_parts(res.clock.stamps, 10_000)} on {card}; "
                       f"launches {launches[path]}; {acc_line}; scorer pairs "
                       f"{res.scorer.scored_pairs}, re-checked "
                       f"{res.scorer.rechecked_pairs}; {upd}")

        # (g) the JAX package's native host path on the same file, same machine
        host_out = os.path.join(tmp, "host.clstr")
        proc = subprocess.run(
            [sys.executable, "-m", "meshclust2_tpu.cli", "--device", "host",
             "--recover", weights, "--output", host_out, fasta],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"host run exited {proc.returncode}:\n"
                                 f"{proc.stderr[-2000:]}")
        stamps = {m.group(1): float(m.group(2)) for m in re.finditer(
            r"^timestamp (\S+) (\S+)$", proc.stdout, re.M)}
        if signature(read_clstr(host_out)) != signature(got):
            raise AssertionError("host path and port disagree on the 10k run")
        phase("g", f"JAX package --device host, same file: "
                   f"{window_parts(stamps, 10_000)} (host CPU of the {card} "
                   f"machine, {os.cpu_count()} cores)")

        # (t) training on the 10k set at the default flags on the card, then
        # clustering it with the trained model: this slice's main path, its
        # launches counted from zero.  Beside it the JAX package's --device
        # host training of the same command, and its host engine with the
        # port's weights.
        train_dir = os.path.join(tmp, "train")
        os.makedirs(train_dir)
        port_clstr = os.path.join(train_dir, "port.clstr")
        for fn in wrappers.values():
            fn.launches = 0
        cwd = os.getcwd()
        os.chdir(train_dir)   # a training run writes weights.txt here
        try:
            res_t = torch_cli.run(["--device", "cuda", *TRAIN_FLAGS,
                                   "--output", port_clstr, fasta])
        finally:
            os.chdir(cwd)
        launches["train"] = {name: fn.launches for name, fn in wrappers.items()}
        if res_t.rc != 0:
            raise AssertionError(f"port training exited {res_t.rc}")
        check_launches("default", launches["train"])
        tab = res_t.tables
        if tab.tables != 2 or tab.launches < 2 or tab.pairs <= 0:
            raise AssertionError(f"training tables did not run on the card: {tab}")
        port_w = os.path.join(train_dir, "weights.txt")
        host_w = os.path.join(tmp, "host_weights.txt")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "meshclust2_tpu.cli", "--device", "host",
             *TRAIN_FLAGS, "--dump", host_w, fasta],
            cwd=ROOT, capture_output=True, text=True, timeout=900)
        host_wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"host training exited {proc.returncode}:\n"
                                 f"{proc.stderr[-2000:]}")
        host_st = {m.group(1): float(m.group(2)) for m in re.finditer(
            r"^timestamp (\S+) (\S+)$", proc.stdout, re.M)}
        pw = load_weights(port_w).classifier
        hw = load_weights(host_w).classifier
        if pw.combos != hw.combos or pw.singles != hw.singles:
            raise AssertionError(f"trained feature sets differ: {pw.combos} "
                                 f"vs {hw.combos}")
        if not (np.array_equal(pw.mins, hw.mins)
                and np.array_equal(pw.maxs, hw.maxs)):
            raise AssertionError("trained normalization bounds differ")
        if not np.allclose(pw.weights, hw.weights, rtol=1e-7, atol=1e-9):
            raise AssertionError(f"trained weights differ: {pw.weights} vs "
                                 f"{hw.weights}")
        with open(port_w, "rb") as f, open(host_w, "rb") as g:
            same_bytes = f.read() == g.read()
        w_rel = float(np.max(np.abs(np.asarray(pw.weights) - hw.weights)
                             / np.maximum(np.abs(hw.weights), 1e-300)))
        host_t_clstr = os.path.join(tmp, "host_train.clstr")
        proc = subprocess.run(
            [sys.executable, "-m", "meshclust2_tpu.cli", "--device", "host",
             "--recover", port_w, "--output", host_t_clstr, fasta],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"host run with the port's weights exited "
                                 f"{proc.returncode}:\n{proc.stderr[-2000:]}")
        got_t = read_clstr(port_clstr)
        if signature(got_t) != signature(read_clstr(host_t_clstr)):
            raise AssertionError("the port's train-and-cluster run and the host "
                                 "engine with its weights disagree on 10k")
        st = res_t.clock.stamps
        gen = st["data_generation"] - st["read_in_points"]
        glm = st["GLM"] - st["data_generation"] - tab.device_seconds \
            - tab.host_seconds
        phase("t", f"train 10k ({' '.join(TRAIN_FLAGS)}) on the card: weights "
                   f"== JAX --device host --dump (combos {pw.combos}, bounds "
                   f"bit-identical, weights max rel diff {w_rel:.3g}, files "
                   f"byte-identical {same_bytes}); train-and-cluster signature "
                   f"== host engine with the port's weights ({len(got_t)} "
                   f"clusters); launches {launches['train']}")
        phase("t", f"port training split (s): set-up {st['read_in_points']:.3f}, "
                   f"data generation {gen:.3f}, tables on the card "
                   f"{tab.device_seconds:.3f} ({tab.tables} tables, {tab.pairs} "
                   f"pairs, {tab.launches} pair_stats launches) + host re-check "
                   f"{tab.host_seconds:.3f} ({tab.rechecked_rows} rows), GLM "
                   f"selection {glm:.3f}; training {st['GLM'] - st['read_in_points']:.3f}, "
                   f"then clustering {st['done'] - st['GLM']:.3f}; {card}")
        phase("t", f"JAX --device host training split (s), same file and "
                   f"machine: set-up {host_st['read_in_points']:.3f}, data "
                   f"generation {host_st['data_generation'] - host_st['read_in_points']:.3f}, "
                   f"host tables and GLM selection "
                   f"{host_st['GLM'] - host_st['data_generation']:.3f}; training "
                   f"{host_st['GLM'] - host_st['read_in_points']:.3f} (process "
                   f"wall {host_wall:.3f}); host CPU of the {card} machine, "
                   f"{os.cpu_count()} cores")

        # (f2) two more runs of each path, in turns, for the spread
        for path in list(PATHS)[::-1] + list(PATHS):
            argv[5] = os.path.join(tmp, f"bench10k_{path}_again.clstr")
            res = run_path(torch_cli, path, argv)
            if res.rc != 0 or signature(read_clstr(argv[5])) != ref_sig:
                raise AssertionError(f"10k repeat differs ({path})")
            phase("f2", f"bench 10k ({path}) again: "
                        f"{window_parts(res.clock.stamps, 10_000)}")

        # (h) torch.profiler over the clustering window of the default path
        # and of MC2_NO_DEVICE_LOOP=1: device busy share, the port's kernels'
        # device time per launch at the main path's shapes, the busiest names
        for path in ("default", "no_device_loop"):
            argv[5] = os.path.join(tmp, f"bench10k_{path}_profiled.clstr")
            res, wall, by_name, n_by_name = profile_path(torch_cli, path, argv)
            if signature(read_clstr(argv[5])) != ref_sig:
                raise AssertionError(f"10k signature differs under the profiler "
                                     f"({path})")
            busy = sum(by_name.values()) / 1e6
            ours = "; ".join(
                f"{m.group(0)} {by_name[name] / n_by_name[name]:.1f} us x "
                f"{n_by_name[name]}"
                for name in sorted(by_name) for m in [re.search(
                    r"(pair_stats|closest_mean|closest_one_dist|closest_one_final"
                    r"|window_absorb)_kernel(<[^>]*>)?", name)] if m)
            top = "; ".join(f"{name[:48]} {us / 1e3:.1f} ms/{n_by_name[name]}"
                            for name, us in by_name.most_common(6))
            steps = res.accumulator.total_steps if res.accumulator else 0
            phase("h", f"torch.profiler, {path}, 10k: device busy {busy:.4f} s of "
                       f"a {wall:.3f} s profiled engine.run ({100 * busy / wall:.1f} "
                       f"% busy), {sum(n_by_name.values())} device events "
                       f"({steps} accumulator steps); the port's kernels (device "
                       f"time per launch): {ours}; top: {top}")

    if any(m == "jax" or m.startswith(("jax.", "meshclust2_tpu."))
           or m == "meshclust2_tpu" for m in sys.modules):
        raise AssertionError("the port imported jax or the JAX package")
    k_ms, p_ms, b_ms, b_by = timing["pair"]
    # launches: this slice's main path (training, then clustering with the
    # trained model); library_ms: no PyTorch call computes any of these
    # functions (PERF.md)
    print(json.dumps({"kernels": [{
        "name": "pair_stats",
        "route": "cuda",
        "source": "meshclust2_tpu_torch/csrc/pair_stats.cu",
        "replaces": "meshclust2_tpu/ops/pallas_stats.py:39",
        "launches": launches["train"]["pair_stats"],
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    }, {
        "name": "closest_mean",
        "route": "cuda",
        "source": "meshclust2_tpu_torch/csrc/closest_mean.cu",
        "replaces": "meshclust2_tpu/cluster/device_loop.py:1223",
        "launches": launches["train"]["closest_mean"],
        "max_abs_err": cm_err,
        "ms": one_k,
        "plain_ms": one_p,
        "bound_ms": one_b,
        "bound_by": one_by,
        "library_ms": None,
        "segmented_ms": cm_k,
        "segmented_plain_ms": cm_p,
        "segmented_bound_ms": cm_b,
    }, {
        "name": "window_absorb",
        "route": "cuda",
        "source": "meshclust2_tpu_torch/csrc/window_absorb.cu",
        "replaces": "meshclust2_tpu/cluster/device_loop.py:1074",
        "launches": launches["train"]["window_absorb"],
        "max_abs_err": wa_err,
        "ms": wa_k,
        "plain_ms": wa_p,
        "bound_ms": wa_b,
        "bound_by": wa_by,
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
