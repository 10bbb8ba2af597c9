#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from meshclust2_tpu_torch/csrc (one nvcc
per source, in parallel), holds each against its plain PyTorch version and
a numpy reference, times both at the main path's shapes, then clusters
med2000 and the 10,000-sequence bench dataset through
`meshclust2_tpu_torch.cli` on the card, on both update paths (the default
TorchDeviceUpdater and MC2_NO_DEVICE_UPDATE_BATCH=1), and checks each run
against its reference CLSTR and engine counters.  For comparison it runs
the JAX package's native host path (`--device host`) on the same file, in
a subprocess.

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
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(ROOT, "tests", "fixtures")

# engine counters of the recover path (windows scored, pairs scored,
# clusters before the update phase, update iterations) and the updater's
# scored pairs, as the JAX package's sessionless device configuration counts
# them: with its DeviceUpdater (the default path), and under
# MC2_NO_DEVICE_UPDATE_BATCH=1, where every update pair goes through the
# scorer and the engine's memo (the counters of the native host scorer)
MED2000_COUNTERS = {"default": (146, 152_619, 305, 6),
                    "no_update_batch": (146, 62_376, 305, 6)}
MED2000_UPDATER_PAIRS = 116_481
BENCH10K_COUNTERS = {"default": (590, 1_386_736, 1_147, 7),
                     "no_update_batch": (590, 789_698, 1_147, 7)}
BENCH10K_UPDATER_PAIRS = 708_385
BENCH10K_CLUSTERS = 788
NO_UPDATE_BATCH = "MC2_NO_DEVICE_UPDATE_BATCH"
TIE_MARGIN = 1e-12


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


def counters(res):
    s = res.engine.stats
    return (s.windows_scored, s.pairs_scored, s.clusters_before_update,
            s.update_iterations)


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
    """cli.run on one update path: the default, or MC2_NO_DEVICE_UPDATE_BATCH=1."""
    if path == "no_update_batch":
        os.environ[NO_UPDATE_BATCH] = "1"
    try:
        return torch_cli.run(argv)
    finally:
        os.environ.pop(NO_UPDATE_BATCH, None)


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from meshclust2_tpu.cluster.engine import distance_d
    from meshclust2_tpu_torch import cli as torch_cli
    from meshclust2_tpu_torch.ops import _build
    from meshclust2_tpu_torch.ops.closest_mean import closest_mean, closest_mean_ref
    from meshclust2_tpu_torch.ops.pair_stats import (
        center_block_stats, pair_stats, pair_stats_ref)
    from meshclust2_tpu_torch.runtime import card_name_and_power, resolve_device

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
    with ThreadPoolExecutor(2) as pool:
        builds = dict(zip(("pair_stats", "closest_mean"),
                          pool.map(_build.load, ("pair_stats", "closest_mean"))))
    for built in builds.values():
        ptxas = "; ".join(ln.strip() for ln in built.log.splitlines()
                          if "registers" in ln or "spill" in ln)
        phase("b", f"built {os.path.relpath(built.path, ROOT)} (nvcc "
                   f"{built.seconds:.3f} s); ptxas: {ptxas}")
    phase("b", f"both builds in {time.perf_counter() - t0:.3f} s")

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

    # (d) kernel vs plain version at the main path's shapes: a 10,000-row
    # uint8 store at D = 1,024 (k = 5), center form P = 2,048, pair form
    # P = 98,304 (the largest update batch)
    store = torch.from_numpy(
        rng.integers(1, 40, (10_000, 1024)).astype(np.uint8)).to(dev)
    shapes = {
        "center": (torch.arange(3_000, 5_048, device=dev),
                   torch.full((2_048,), 4_000, dtype=torch.int64, device=dev)),
        "pair": (torch.from_numpy(rng.integers(0, 10_000, 98_304)).to(dev),
                 torch.from_numpy(rng.integers(0, 10_000, 98_304)).to(dev)),
    }
    timing = {}
    for form, (a_d, b_d) in shapes.items():
        got = pair_stats(store, a_d, b_d)
        plain = pair_stats_ref(store, a_d, b_d)
        torch.cuda.synchronize()
        if not torch.equal(got, plain):
            raise AssertionError(f"pair_stats differs at the {form} main-path shape")
        max_err = max(max_err, int((got - plain).abs().max()))
        k_ms = cuda_ms(lambda: pair_stats(store, a_d, b_d), reps=50)
        p_ms = cuda_ms(lambda: pair_stats_ref(store, a_d, b_d), reps=10)
        timing[form] = (k_ms, p_ms)
        phase("d", f"{form} form P={len(a_d)} D=1024 uint8: kernel "
                   f"{k_ms:.4f} ms, plain {p_ms:.4f} ms (median, CUDA events; "
                   f"{card})")

    # (d2) closest_mean vs its plain version at the main path's shape: the
    # same store, P = 98,304 pairs (the largest update batch) in 1,000
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
    phase("d2", f"closest_mean P={len(rows)} C={n_segs} D=1024 uint8: kernel "
                f"{cm_k:.4f} ms, plain {cm_p:.4f} ms (median, CUDA events; {card})")

    with tempfile.TemporaryDirectory(prefix="mc2_smoke_") as tmp:
        # (e) med2000 through the port's CLI on the card, on both update paths
        # (cli.run is cli.main's body, returning the engine beside the code)
        for path in ("default", "no_update_batch"):
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
            if counters(res) != MED2000_COUNTERS[path]:
                raise AssertionError(f"med2000 counters {counters(res)} != "
                                     f"{MED2000_COUNTERS[path]} ({path})")
            upd = "no updater" if res.updater is None else \
                f"updater pairs {res.updater.scored_pairs}"
            if path == "default" and res.updater.scored_pairs != MED2000_UPDATER_PAIRS:
                raise AssertionError(f"med2000 {upd} != {MED2000_UPDATER_PAIRS}")
            phase("e", f"med2000 ({path}): sorted CLSTR == med2000_ref.clstr, "
                       f"counters {counters(res)}, {upd}, "
                       f"{window_parts(res.clock.stamps, 2000)}")

        # (f) the 10k bench dataset: the slice's main path, counted
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
        launches = {}
        for path in ("default", "no_update_batch"):
            out = os.path.join(tmp, f"bench10k_{path}.clstr")
            pair_stats.launches = 0
            closest_mean.launches = 0
            res = run_path(torch_cli, path, ["--device", "cuda", "--recover",
                                             weights, "--output", out, fasta])
            launches[path] = {"pair_stats": pair_stats.launches,
                              "closest_mean": closest_mean.launches}
            if res.rc != 0:
                raise AssertionError(f"port CLI exited {res.rc} on the 10k "
                                     f"dataset ({path})")
            need = ("pair_stats", "closest_mean") if path == "default" else ("pair_stats",)
            for name in need:
                if launches[path][name] <= 0:
                    raise AssertionError(f"the {path} path launched no {name} kernel")
            got = read_clstr(out)
            if len(got) != BENCH10K_CLUSTERS or signature(got) != ref_sig:
                raise AssertionError(f"10k signature differs ({len(got)} "
                                     f"clusters, {path})")
            if counters(res) != BENCH10K_COUNTERS[path]:
                raise AssertionError(f"10k counters {counters(res)} != "
                                     f"{BENCH10K_COUNTERS[path]} ({path})")
            if path == "default":
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
                       f"launches {launches[path]}; scorer pairs "
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

    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    k_ms, p_ms = timing["pair"]
    print(json.dumps({"kernels": [{
        "name": "pair_stats",
        "route": "cuda",
        "source": "meshclust2_tpu_torch/csrc/pair_stats.cu",
        "replaces": "meshclust2_tpu/ops/pallas_stats.py:39",
        "launches": launches["default"]["pair_stats"],
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }, {
        "name": "closest_mean",
        "route": "cuda",
        "source": "meshclust2_tpu_torch/csrc/closest_mean.cu",
        "replaces": "meshclust2_tpu/cluster/device_update.py:290",
        "launches": launches["default"]["closest_mean"],
        "max_abs_err": cm_err,
        "ms": cm_k,
        "plain_ms": cm_p,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
