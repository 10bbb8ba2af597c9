#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from meshclust2_tpu_torch/csrc, holds it
against its plain PyTorch version and an int64 numpy oracle, times both at
the main path's shapes, then clusters med2000 and the 10,000-sequence bench
dataset through `meshclust2_tpu_torch.cli` on the card and checks each
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

ROOT = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(ROOT, "tests", "fixtures")

# engine counters of the recover path at the two datasets, equal to a run
# with the native host scorer: windows scored, pairs scored, clusters before
# the update phase, update iterations
MED2000_COUNTERS = (146, 62_376, 305, 6)
BENCH10K_COUNTERS = (590, 789_698, 1_147, 7)
BENCH10K_CLUSTERS = 788


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np

    from meshclust2_tpu_torch import cli as torch_cli
    from meshclust2_tpu_torch.ops import _build
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

    # (b) the build
    t0 = time.perf_counter()
    built = _build.load("pair_stats")
    ptxas = "; ".join(ln.strip() for ln in built.log.splitlines()
                      if "registers" in ln or "spill" in ln)
    phase("b", f"built {os.path.relpath(built.path, ROOT)} in "
               f"{time.perf_counter() - t0:.3f} s (nvcc {built.seconds:.3f} s); "
               f"ptxas: {ptxas}")

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

    with tempfile.TemporaryDirectory(prefix="mc2_smoke_") as tmp:
        # (e) med2000 through the port's CLI on the card
        # (cli.run is cli.main's body, returning the engine beside the code)
        out = os.path.join(tmp, "med2000.clstr")
        res = torch_cli.run(["--device", "cuda", "--recover",
                             os.path.join(FIX, "med2000_weights.txt"),
                             "--output", out, os.path.join(FIX, "med2000.fasta")])
        if res.rc != 0:
            raise AssertionError(f"port CLI exited {res.rc} on med2000")
        with open(out) as f, open(os.path.join(FIX, "med2000_ref.clstr")) as g:
            if sorted(f.readlines()) != sorted(g.readlines()):
                raise AssertionError("med2000 CLSTR differs from med2000_ref.clstr")
        if counters(res) != MED2000_COUNTERS:
            raise AssertionError(f"med2000 counters {counters(res)} != "
                                 f"{MED2000_COUNTERS}")
        phase("e", f"med2000: sorted CLSTR == med2000_ref.clstr, counters "
                   f"{counters(res)}, window {window(res.clock.stamps):.3f} s")

        # (f) the 10k bench dataset: the slice's main path, counted
        import bench

        fasta = os.path.join(tmp, "bench_10000.fasta")
        if bench.N_SEQS != 10_000 or bench.SEED != 424242:
            raise AssertionError("BENCH_N_SEQS / seed overridden")
        bench.ensure_dataset(fasta)
        weights = os.path.join(FIX, "bench10k_weights.txt")
        out = os.path.join(tmp, "bench10k.clstr")
        pair_stats.launches = 0
        res = torch_cli.run(["--device", "cuda", "--recover", weights,
                             "--output", out, fasta])
        launches = pair_stats.launches
        if res.rc != 0:
            raise AssertionError(f"port CLI exited {res.rc} on the 10k dataset")
        if launches <= 0:
            raise AssertionError("the main path launched no pair_stats kernel")
        ref_path = os.path.join(tmp, "ref.clstr")
        with gzip.open(os.path.join(FIX, "bench10k_ref_t1.clstr.gz"), "rb") as f, \
                open(ref_path, "wb") as g:
            g.write(f.read())
        got = read_clstr(out)
        if len(got) != BENCH10K_CLUSTERS or signature(got) != signature(
                read_clstr(ref_path)):
            raise AssertionError(f"10k signature differs ({len(got)} clusters)")
        if counters(res) != BENCH10K_COUNTERS:
            raise AssertionError(f"10k counters {counters(res)} != "
                                 f"{BENCH10K_COUNTERS}")
        port_win = window(res.clock.stamps)
        phase("f", f"bench 10k: signature == bench10k_ref_t1 ({len(got)} "
                   f"clusters), counters {counters(res)}; clustering window "
                   f"{port_win:.3f} s = {10_000 / port_win:.1f} seqs/s on "
                   f"{card}; kernel launches {launches}, scored pairs "
                   f"{res.scorer.scored_pairs}, re-checked pairs "
                   f"{res.scorer.rechecked_pairs}")

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
        host_win = window(stamps)
        phase("g", f"JAX package --device host, same file: clustering window "
                   f"{host_win:.3f} s = {10_000 / host_win:.1f} seqs/s "
                   f"(host CPU of the {card} machine, {os.cpu_count()} cores)")

    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    k_ms, p_ms = timing["pair"]
    print(json.dumps({"kernels": [{
        "name": "pair_stats",
        "route": "cuda",
        "source": "meshclust2_tpu_torch/csrc/pair_stats.cu",
        "replaces": "meshclust2_tpu/ops/pallas_stats.py:39",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
