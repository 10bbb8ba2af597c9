#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --step    # the step kernel's checks alone: (c4), (m4)

Builds the port's CUDA kernels from meshclust2_tpu_torch/csrc (one nvcc
per source, in parallel), holds each against its plain PyTorch version and
a numpy reference (the fused pair-statistics-and-decision kernel bit for bit
on the statistics, s, prob and dist; the accumulate step kernel over a
sweep of step cases, on every state tensor and its trip), times both at the main path's shapes
beside the least time the card could take (its bound) and the profiler's
device time per launch, then clusters med2000 and the
10,000-sequence bench dataset through `meshclust2_tpu_torch.cli` on the
card, on its three paths: the default (TorchDeviceAccumulator, then the
update phase as device-resident iterations, TorchDevicePhaseUpdater, with
TorchDeviceUpdater after a guarded abort), MC2_NO_DEVICE_LOOP=1 (the
accumulate windows through TorchDeviceScorer, the update batches through
TorchDeviceUpdater) and MC2_NO_DEVICE_LOOP=1 MC2_NO_DEVICE_UPDATE_BATCH=1
(both phases through the scorer).  Each run is checked against its
reference CLSTR and engine counters, and each path's kernel launches are
counted from zero; med2000 under MC2_DD_MARGIN=3e-3 aborts the phase and
still gives its reference.  The phase's three kernels (phase_layout,
closest_candidates: its closest-to-mean with the candidates step folded in,
and merge_replay) are held against their plain versions on the 10k default
path's own state after accumulate and timed beside their bounds (d6), and
torch.profiler times the phase alone on that state (h2).  The accumulate
loop's window kernel (window_select: the window, and the seed before it, in
one launch) is held bit for bit against its plain twin on the 10k default
path's loop state before a scan window and before a seed, and on a seeded
100k pool, and timed beside its bound (d7).  The k-mer
histogram kernel (MC2_DEVICE_COUNT's build) is held byte for byte against
its plain version and the native counter on the 10k set, a saturating
record, records with N runs, a 2 Mbp record split at 1 Mbp, a homopolymer
and k = 8, and timed by events beside its bound and torch.bincount (k);
the 10k default path with MC2_DEVICE_COUNT=1 gives the default run's CLSTR
byte for byte, and the set-up of native and device counting is timed
stage by stage, with the garbage collector's pauses, in this process
(device, native, native, device, native, device, device, native) and in
fresh ones (native, device, device, native) (k2).  --multihost clusters
the 10k set as a one-rank NCCL group, plain and under MC2_DEVICE_COUNT=1,
to the reference signature with the scorer-alone path's counters, every
pair scored by the kernel, and parallel/mesh.py's
SPMD functions on the card equal them on the CPU (m); that is the
per-window route (MC2_NO_DEVICE_SESSION=1).  --multihost's default route,
the device session over the row-sharded store, clusters the 10k set as a
one-rank NCCL group to the signature with the default path's counters,
through the block modes of the step kernel and of closest_candidates (m3);
those block modes, with G = 4 row blocks in this process, equal the
one-block kernels and the plain versions bit for bit on a 10k step and on
the 10k phase state, and are timed beside their bounds (m4); the port's
graft_entry runs entry()'s forward on the card and dryrun_multichip(1) as
a one-rank NCCL group (m5); two --multihost processes share the card as a
gloo group and cluster med2000 through the session (m6).  The fused
kernel's FULL instantiation (models with full-vector singles) is held against its plain version and a numpy host
oracle within its error bounds (c5) and timed beside its bound (d4); two
such models, built over each set with the port's host formulas, cluster
med2000 and the 10k set on the three paths byte for byte as the JAX
package's --device host run (e2, f4), and a --feat slow training on the
10k set gives its weights (t2).  The plane-singles kernel and the fused
kernel's PLANE instantiation (models with plane singles) are held against
their plain versions and the numpy host oracle within their bounds (c6) and
timed beside their bounds (d5); three plane models, built over med2000 with
the port's host formulas, cluster it through the device scorer alone byte
for byte as the JAX package's --device host run (e3), and two committed
plane models cluster the 10k set to the signatures of their committed JAX
--device host references (f5), with their host re-checks counted by rule.  Then it trains on the 10k set at the default flags
(the pair tables through the pair-statistics kernel) and clusters it with
the trained model, and holds the weights and the CLSTR against the JAX
package's `--device host` training and host engine.  Then fastcar
(`meshclust2_tpu_torch.fastcar`) on the 10k set: its default training with
--dump, and an all-vs-all --recover search through the fused kernel in
slices, each held byte for byte against the JAX package's fastcar (its
host route), with both programs' search windows and the kernel at the
search's largest slice.  A torch.profiler run of the default path gives
the device's busy share, and the CLI's own `--profile DIR` on the default
path writes a Chrome trace that holds the port's kernels, the run itself
unchanged (r2).  Last, Red, the third program (host code in both
packages): the port's Red on the fixture genome gives the reference
binary's .scr/.rpt, and on a seeded yeast-sized genome (~12.1 Mbp) the JAX
Red's files byte for byte, both timed on the card's machine (r).  The JAX
package runs only as a separate program (the CLI's `--device host`,
fastcar's default, Red; its native host path), on the same file, as the
reference on the same machine.

Each phase prints one line; any failure raises and exits non-zero.  The
line before the last is the kernels' JSON record, and the last line is
{"ok": true, "device": {...}}.  Without a usable CUDA card, or run from a
directory that holds nothing else of the repository, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import contextlib
import gzip
import io
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
from types import SimpleNamespace

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(ROOT, "tests", "fixtures")
# the long-record deployment's model (k = 7, its dist euclidean alone)
K7_WEIGHTS = os.path.join(ROOT, "benchmark", "configs", "mc2-fast-id90-k7.weights.txt")

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
# the engine counters of the JAX package's --device host run of the 10k set
# with the committed plane models (tests/fixtures/bench10k_{markov,plane}_*)
PLANE10K_COUNTERS = {"markov": (561, 747_763, 1_119, 8),
                     "plane": (489, 699_028, 1_098, 7)}
MARGIN, TIE_MARGIN = 1e-8, 1e-12
# the kernel sources, one nvcc each
SOURCES = ("pair_stats", "closest_mean", "window_absorb", "plane_singles", "phase",
           "kmer_count", "window_select")
# the kernels each path must launch (their wrappers' counts), and those it
# must not: the clustering paths take their statistics from the fused
# kernel, training's tables from the statistics alone
# (pair_stats_decision_full counts the fused kernel's FULL launches, those
# of a model with full-vector singles; the fast paths launch none)
NEEDS = {"default": ("pair_stats_decision", "window_absorb", "phase_layout",
                     "closest_candidates", "merge_replay"),
         "no_device_loop": ("pair_stats_decision", "closest_mean"),
         "no_device_loop_no_update_batch": ("pair_stats_decision",),
         "train": ("pair_stats", "pair_stats_decision", "window_absorb",
                   "phase_layout", "closest_candidates", "merge_replay"),
         "fastcar_train": ("pair_stats",),
         "fastcar": ("pair_stats_decision",),
         "full_default": ("pair_stats_decision", "pair_stats_decision_full",
                          "window_absorb", "phase_layout", "closest_candidates",
                          "merge_replay"),
         "full_no_device_loop": ("pair_stats_decision",
                                 "pair_stats_decision_full", "closest_mean"),
         "full_no_device_loop_no_update_batch": ("pair_stats_decision",
                                                 "pair_stats_decision_full"),
         "train_slow": (),
         # a plane model: the scorer alone, the plane kernel before the
         # fused kernel's PLANE instantiation
         "plane": ("plane_singles", "pair_stats_decision",
                   "pair_stats_decision_plane")}
FORBIDS = {"default": ("pair_stats", "pair_stats_decision_full"),
           "no_device_loop": ("pair_stats", "window_absorb",
                              "pair_stats_decision_full"),
           "no_device_loop_no_update_batch": ("pair_stats", "window_absorb",
                                              "pair_stats_decision_full"),
           "train": ("pair_stats_decision_full",),
           "fastcar_train": ("pair_stats_decision", "closest_mean",
                             "window_absorb", "pair_stats_decision_full"),
           "fastcar": ("pair_stats", "closest_mean", "window_absorb",
                       "pair_stats_decision_full"),
           "full_default": ("pair_stats",),
           "full_no_device_loop": ("pair_stats", "window_absorb"),
           "full_no_device_loop_no_update_batch": ("pair_stats", "window_absorb"),
           # its tables come from the host oracle
           "train_slow": ("pair_stats", "pair_stats_decision", "closest_mean",
                          "window_absorb", "pair_stats_decision_full"),
           "plane": ("pair_stats", "closest_mean", "window_absorb",
                     "pair_stats_decision_full")}
# the default path with its counts built on the card (MC2_DEVICE_COUNT=1)
NEEDS["device_count"] = NEEDS["default"] + ("kmer_count",)
FORBIDS["device_count"] = FORBIDS["default"]
# no path but a plane model's launches the plane kernels, none but the
# default path's clustering (training's included) the phase's, and none but
# MC2_DEVICE_COUNT's the k-mer kernel
for _path in FORBIDS:
    if _path != "plane":
        FORBIDS[_path] += ("plane_singles", "pair_stats_decision_plane")
    if _path not in ("default", "train", "full_default", "device_count"):
        FORBIDS[_path] += ("phase_layout", "closest_candidates", "merge_replay")
    if _path != "device_count":
        FORBIDS[_path] += ("kmer_count",)
# --multihost on the card, a one-rank NCCL group, per-window
# (MC2_NO_DEVICE_SESSION=1): MultihostScorer's center and pair forms of the
# fused kernel, the k-mer kernel under MC2_DEVICE_COUNT=1, nothing of the
# device loops
NEEDS["multihost"] = ("pair_stats_decision",)
NEEDS["multihost_device_count"] = ("pair_stats_decision", "kmer_count")
FORBIDS["multihost"] = FORBIDS["no_device_loop_no_update_batch"] + ("closest_mean",)
FORBIDS["multihost_device_count"] = tuple(
    k for k in FORBIDS["multihost"] if k != "kmer_count")
# no path in this process launches the block modes: the multihost session
# launches them only on a mesh of two or more ranks (m6, processes of their
# own); on one rank (m3) it launches the default path's step kernel and
# closest_candidates
for _path in FORBIDS:
    FORBIDS[_path] += ("window_absorb_block", "closest_candidates_block")
NEEDS["multihost_session"] = ("pair_stats_decision", "window_absorb", "closest_candidates",
                              "phase_layout", "merge_replay")
FORBIDS["multihost_session"] = ("pair_stats", "pair_stats_decision_full", "closest_mean",
                                "plane_singles", "pair_stats_decision_plane", "kmer_count",
                                "window_absorb_block", "closest_candidates_block")
# the accumulate loop's window and seed (ops/window_select.py): every path
# that runs the step kernel launches it, no other
for _path in NEEDS:
    if "window_absorb" in NEEDS[_path]:
        NEEDS[_path] += ("window_select",)
    else:
        FORBIDS[_path] += ("window_select",)
# the kernels whose launches the one-rank session (m3) and the default path
# (f) share to the launch; their pair_stats_decision launches differ by their
# warm-ups alone (the default session's scorer and updater, MultihostScorer's)
# (d7): the scan window and the seed of the 10k default path's accumulate
# loop whose loop state window_select is held and timed on
WINDOW_AT = 200
SAME_LAUNCHES = ("window_absorb", "closest_candidates", "phase_layout", "merge_replay",
                 "window_select")
WARM_UP_DIFF = 4
# the training run of this slice: the JAX CLI's default training flags
TRAIN_FLAGS = ["--id", "0.9", "--kmer", "5", "--feat", "fast",
               "--sample", "2000", "--num-templates", "300"]
# the same training with the slow feature set (the log divergences), whose
# tables come from the host oracle
TRAIN_SLOW_FLAGS = [("slow" if f == "fast" else f) for f in TRAIN_FLAGS]
# the slice's models with full-vector singles (smoke_model)
FULL_MODELS = ("slow", "blockwise")
# the slice's models with plane singles (smoke_model): markov and plane at
# k = 5, k2 at k = 2 (afd needs k = 2)
PLANE_MODELS = ("markov", "plane", "k2")
# fastcar's default training (its -m rc and --mut-type single defaults,
# spelled out)
FASTCAR_TRAIN_FLAGS = ["--id", "0.9", "-m", "rc", "--mut-type", "single",
                       "--sample", "300"]
# the JAX package's fastcar as a separate program, its `before loop` and
# `after loop` prints followed by a line with the host clock
JAX_FASTCAR_STAMPED = """
import sys, time
import meshclust2_tpu.fastcar as fc
from meshclust2_tpu.native import NativeScorer
spent = {"search": 0.0, "score": 0.0}
def timed(key, fn):
    def call(*args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            spent[key] += time.perf_counter() - t0
    return call
fc.search = timed("search", fc.search)
NativeScorer.score = timed("score", NativeScorer.score)
printed = fc.mem_used
def stamped(prefix):
    printed(prefix)
    print(f"stamp {prefix}: {time.perf_counter()!r}", flush=True)
    if prefix == "after loop":
        for key, seconds in spent.items():
            print(f"stamp {key} seconds: {seconds!r}", flush=True)
fc.mem_used = stamped
sys.exit(fc.main(sys.argv[1:]))
"""
# the JAX package's CLI as a separate program, its engine counters printed
# after the run
JAX_CLI_COUNTED = """
import sys
import meshclust2_tpu.cli as cli
from meshclust2_tpu.cluster.engine import MeanShiftEngine
real = MeanShiftEngine.run
def run(self, *args, **kw):
    out = real(self, *args, **kw)
    s = self.stats
    print(f"counters {s.windows_scored} {s.pairs_scored} "
          f"{s.clusters_before_update} {s.update_iterations}", flush=True)
    return out
MeanShiftEngine.run = run
sys.exit(cli.main(sys.argv[1:]))
"""
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
# the fused epilogue's float64 operations per pair: the three conversions,
# ap, aq and the norm, the clamp, exp, the logistic and the bias (12); per
# single up to 8 for its formula (euclidean_z's 14 counted as 8 on
# average) and 3 to normalize it; per combo up to 3 products and 2 for the
# GLM sum
EPI_OPS_PAIR = 12
EPI_OPS_SINGLE = 11
EPI_OPS_COMBO = 5
# float64 instructions a second outside the tensor cores, for the FULL
# pass's per-element float64 work: the same data sheet's 34 TFLOP/s counts
# an FMA as two operations, so the card issues 17 T float64 instructions a
# second (the quarter-rate MUFU instructions are charged the same, which
# keeps the bound a lower bound)
F64_INSTR_PER_S = 34e12 / 2
# probe kernels whose float64 instructions give what one log, one division
# and one square root compile to (sass_counts)
PROBE_SRC = r"""
extern "C" __global__ void base(const double* x, double* y) { y[threadIdx.x] = x[threadIdx.x]; }
extern "C" __global__ void f_log(const double* x, double* y) { y[threadIdx.x] = log(x[threadIdx.x]); }
extern "C" __global__ void f_div(const double* x, double* y) {
  y[threadIdx.x] = __ddiv_rn(x[threadIdx.x], x[threadIdx.x + 32]);
}
extern "C" __global__ void f_sqrt(const double* x, double* y) { y[threadIdx.x] = __dsqrt_rn(x[threadIdx.x]); }
"""


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


def cuda_ms(fn, reps: int, warm: int = 3, setup=None) -> float:
    """Median device time of fn() in ms over `reps` runs, by CUDA events;
    setup(), when given, runs before each call outside the events."""
    import torch

    for _ in range(warm):
        if setup:
            setup()
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if setup:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_us(fn, reps: int = 20, setup=None, sleep: int = 2_000_000) -> float:
    """Median device time in us of fn()'s launches: each call is queued
    behind a busy wait on the card (torch.cuda._sleep, `sleep` cycles), so
    the events around it time the card's work and not the wrapper's host
    work; setup(), when given, runs before each call outside the events."""
    import torch

    times = []
    for i in range(reps + 1):
        if setup:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep)   # 2,000,000: ~1 ms of cycles, the host queues meanwhile
        start.record()
        fn()
        end.record()
        end.synchronize()
        if i:   # the first call warms up
            times.append(start.elapsed_time(end) * 1e3)
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


def decision_bound(store, a, b, n_singles: int, n_combos: int,
                   extra_bytes: int = 0):
    """pair_stats_bound's bytes and operations, plus each referenced row's
    four float64 moments read, the parameters read, the float64 (s, prob,
    dist) written, and the epilogue's operations per pair; `extra_bytes`
    (the PLANE instantiation's plane buffer read and its bounds written)
    added to the bytes."""
    rows = int(torch_unique(a, b))
    d = store.shape[1]
    p = len(a)
    nbytes = (rows * (d * store.element_size() + 32) + tbytes(a, b) + 48 * p
              + 8 * (4 + 4 * (n_singles + n_combos)) + extra_bytes)
    ops = (PAIR_OPS * p * d + p * (EPI_OPS_PAIR + EPI_OPS_SINGLE * n_singles
                                  + EPI_OPS_COMBO * n_combos))
    return bound_ms(nbytes, ops)


def same_f64(got, want) -> bool:
    """Equal bit for bit, NaN where the other is NaN."""
    import torch

    nan = torch.isnan(want)
    return (torch.equal(torch.isnan(got), nan)
            and torch.equal(got[~nan].view(torch.int64), want[~nan].view(torch.int64)))


def step_bound_terms(w: int, npos: int, count: int, d: int, elem: int):
    """(bytes, operations) of the step at W candidates, npos positives,
    count members after the absorb: per candidate its index, store row, s,
    dist, their bounds and the statistics read and its alive, assign and
    astep written; the positives' member slots written; per member its
    index, store row, histogram and mags read; msum read and written, the
    trip written.  Operations: ~20 a candidate (gates, maximum, tie guard,
    state), one add per positive element, the mean per element, CLOSEST_OPS
    per member element."""
    nbytes = (w * (8 + 8 + 8 + 8 + 16 + 24 + 1 + 8 + 8) + npos * 8
              + count * (8 + 8 + d * elem + 8) + 2 * 8 * d + 32)
    ops = 20 * w + npos * d + 10 * d + CLOSEST_OPS * count * d
    return nbytes, ops


def step_bound(w: int, npos: int, count: int, d: int, elem: int):
    """The step's bound (step_bound_terms)."""
    return bound_ms(*step_bound_terms(w, npos, count, d, elem))


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


def skewed_segments(rng, n_rows: int, n_pairs: int, n_segs: int):
    """One segment with 90 % of the positions, the rest in one-row segments
    or empty ones, rows repeated (exact ties), 80 % kept, and a few
    segments with nothing kept."""
    big = int(0.9 * n_pairs)
    sizes = np.zeros(n_segs, np.int64)
    sizes[n_segs // 3] = big
    others = np.delete(np.arange(n_segs), n_segs // 3)
    np.add.at(sizes, rng.choice(others, n_pairs - big,
                                replace=n_pairs - big > len(others)), 1)
    seg = np.repeat(np.arange(n_segs), sizes).astype(np.int64)
    rows = rng.integers(0, n_rows, n_pairs).astype(np.int64)
    rows[1::7] = rows[::7][:len(rows[1::7])]
    keep = rng.random(n_pairs) < 0.8
    unkept = rng.choice(np.nonzero(sizes)[0], 3, replace=False)
    keep[np.isin(seg, unkept[unkept != n_segs // 3])] = False
    return rows, seg, keep


STEP_KINDS = ("absorb", "min", "on_edge", "ulp_below", "tie", "near_tie",
              "stage2", "full")


def step_case(rng, n: int, kind: str, w=None, mcnt=None, npos=None,
              edge: float = 0.25):
    """One accumulate step's inputs over a pool of n flat positions (numpy):
    order, candidates, s, dist, the state (alive, assign, astep, members,
    msum left to the caller), cur_d and the tie margin.  `kind` shapes the
    decisions (STEP_KINDS: absorb and min cases, a sum on and one ulp below
    the edge, an exact and a near dist tie of other inputs, an uncertain
    mean with the positives absorbed, a member list that reaches n); w,
    mcnt and npos fix the window, the open cluster and the positives."""
    order = rng.permutation(n).astype(np.int64)
    cid = 3
    flat = rng.permutation(n)
    mcnt = int(rng.integers(1, 12)) if mcnt is None else mcnt
    done = 0 if kind == "full" else min(int(rng.integers(5, 30)), n - mcnt - 1)
    mem, old, free = flat[:mcnt], flat[mcnt:mcnt + done], flat[mcnt + done:]
    alive = np.zeros(n, bool)
    alive[free] = True
    assign = np.full(n, -1, np.int64)
    astep = np.zeros(n, np.int64)
    assign[old] = rng.integers(0, cid, len(old))
    assign[mem] = cid
    astep[mem] = np.arange(mcnt)
    members = rng.integers(0, n, n + 1).astype(np.int64)   # stale beyond mcnt
    members[:mcnt] = mem
    if w is None:
        w = len(free) if kind == "full" else int(rng.integers(1, len(free) + 1))
    cand = np.sort(rng.choice(free, w, replace=False)).astype(np.int64)
    tie_margin = TIE_MARGIN
    s = rng.normal(edge, 2.0, w)
    s[np.abs(s - edge) < 1e-6] += 1e-3
    dist = rng.random(w)
    if kind == "min":
        s = -np.abs(s) - 1.0
    elif kind in ("absorb", "full", "stage2"):
        s = edge + 0.5 + np.abs(s)
        if kind == "absorb":
            k = w // 2 if npos is None else w - npos
            s[rng.choice(w, k, replace=False)] = edge - 0.5 - np.abs(s[:k])
    elif kind == "on_edge":
        s[w // 2] = edge
    elif kind == "ulp_below":
        s[w // 2] = np.nextafter(edge, -np.inf)
    if kind == "stage2":
        # every candidate a copy of one row at one dist: no window tie; a
        # tie margin that takes in every member makes the mean uncertain
        order[cand] = order[cand[0]]
        dist[:] = 0.5
        tie_margin = 1e9
    if kind in ("tie", "near_tie") and w > 1:
        top = int(np.argmax(dist))
        other = (top + 1) % w
        dist[other] = dist[top] if kind == "tie" else \
            dist[top] * (1 - 0.5 * TIE_MARGIN)
    return dict(order=order, cand=cand, s=s, dist=dist, alive=alive,
                assign=assign, astep=astep, members=members, mem=mem,
                cur_d=np.array([mem[0]], np.int64), cid=cid, stepc=n + 7,
                mcnt=mcnt, edge=edge, tie_margin=tie_margin)


def step_inputs(case, counts, moments, dev, tie: int, key_tie: int = 0):
    """A step_case on the card: (args, kw) for window_step under the tie
    guard's keys `tie`.  With key_tie (a mask of the kTie* fields), the
    case's best dist is tied exactly by the next candidate, which shares the
    best's fields in key_tie and differs in every other field."""
    import torch
    from meshclust2_tpu_torch.cluster.device_store import DeviceStore
    from meshclust2_tpu_torch.ops import window_absorb as WA
    from meshclust2_tpu_torch.ops.pair_stats import pair_stats

    c64 = counts.astype(np.int64)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    counts_d = up(counts)
    if counts.dtype == np.uint8 and counts.shape[1] == 256:
        raw = torch.empty(counts.nbytes + 1, dtype=torch.uint8, device=dev)
        counts_d = raw[1:].view(counts.shape).copy_(counts_d)  # off 16 bytes
    lens, stddevs = (m.clone() for m in moments)
    store = DeviceStore(counts=counts_d,
                        mags=up(c64.sum(axis=1).astype(np.float64)),
                        selfdot=up((c64 * c64).sum(axis=1).astype(np.float64)),
                        lens=lens, stddevs=stddevs, maxc=int(counts.max()))
    order, cand = up(case["order"]), up(case["cand"])
    cur_d = up(case["cur_d"])
    center = order[cur_d].expand(len(cand)).contiguous()
    stats = pair_stats(store.counts, order[cand], center)
    dist = case["dist"].copy()
    if key_tie:
        top = int(np.argmax(dist))
        other = (top + 1) % len(dist)
        dist[other] = dist[top]
        rt, ro = order[cand[top]], order[cand[other]]
        stats[other] = stats[top] + torch.tensor([3, 7, 11], device=dev)
        for key, col in ((WA.TIE_SUMMIN, 0), (WA.TIE_DOT, 1), (WA.TIE_EMD, 2)):
            if key_tie & key:
                stats[other, col] = stats[top, col]
        for key, m, off in ((WA.TIE_MAG, store.mags, 5), (WA.TIE_SELFDOT, store.selfdot, 14),
                            (WA.TIE_LEN, lens, 1), (WA.TIE_STD, stddevs, 0.25)):
            m[ro] = m[rt] + (0 if key_tie & key else off)
        # the exact integers: selfdot - 2 dot and mags - 2 summin
        two = lambda col: 2 * (stats[other, col] - stats[top, col]).to(torch.float64)
        if key_tie & WA.TIE_NORM2:
            store.selfdot[ro] = store.selfdot[rt] + two(1)
        if key_tie & WA.TIE_MANH:
            store.mags[ro] = store.mags[rt] + two(0)
    state = WA.StepState(up(case["alive"]), up(case["assign"]), up(case["astep"]),
                         up(case["members"]),
                         up(c64[case["order"][case["mem"]]].sum(axis=0)))
    args = (store, order, cand, up(case["s"]), up(dist), stats, state, cur_d)
    # the fused kernel's bounds of a model without full-vector singles
    zero = torch.zeros(len(cand), dtype=torch.float64, device=dev)
    kw = dict(cid=case["cid"], stepc=case["stepc"], mcnt=case["mcnt"],
              pos_edge=case["edge"], margin=MARGIN, tie_margin=case["tie_margin"],
              s_err=zero, dist_err=zero.clone(), tie=tie)
    return args, kw


def fresh(args):
    """args with a copy of the state (the step updates it in place)."""
    from meshclust2_tpu_torch.ops.window_absorb import StepState

    return args[:6] + (StepState(*(t.clone() for t in args[6])),) + args[7:]


def step_check(args, kw, what, scratch=None):
    """Kernel and plain version on copies of the same state: the kernel's
    trip and their largest difference over every output, or raise."""
    import torch
    from meshclust2_tpu_torch.ops.window_absorb import (StepState, window_step,
                                                        window_step_ref)

    got, plain = fresh(args), fresh(args)
    trip = window_step(*got, **kw, scratch=scratch).clone()
    torch.cuda.synchronize()
    want = window_step_ref(*plain, **kw)
    pairs = [("trip", trip, want)] + [
        (name, g[:-1], w[:-1]) if name == "members" else (name, g, w)
        for name, g, w in zip(StepState._fields, got[6], plain[6])]
    for name, g, w in pairs:
        if not torch.equal(g, w):
            raise AssertionError(f"window_step differs in {name}: {what}")
    return trip, max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                     for _, g, w in pairs)


def step_kernel_checks(rng, dev, tie10k: int) -> int:
    """(c4) the step kernel against its plain version, bit for bit on the
    trip and every state tensor: STEP_KINDS at uint8/uint16 and D in
    16..4096 under `tie10k` (the 10k default path's model's keys), and at
    D = 16,384 uint8 under the keys of the long-record model
    (K7_WEIGHTS: TIE_NORM2); at each shape an exact dist tie whose
    model's keys agree and whose other fields differ, which the model's
    keys take as exact (no bit 2) and TIE_ALL does not (bit 2).  Returns
    the largest difference (0: any other raises)."""
    import torch
    from meshclust2_tpu_torch.model.classifier import CompiledModel
    from meshclust2_tpu_torch.model.weights import load_weights
    from meshclust2_tpu_torch.ops.window_absorb import TIE_ALL, TIE_NORM2, tie_keys

    k7 = CompiledModel(load_weights(K7_WEIGHTS).classifier)
    tie_k7 = tie_keys(k7.singles, k7.combos)
    if tie_k7 != TIE_NORM2 or tie10k == TIE_ALL:
        raise AssertionError(f"the models' keys: 10k {tie10k}, k = 7 {tie_k7}")
    wa_err = 0
    n_cases = 0
    trips = Counter()
    shapes = [(dtype, d, tie10k) for dtype in (np.uint8, np.uint16)
              for d in (16, 256, 1024, 4096)] + [(np.uint8, 16_384, tie_k7)]
    for dtype, d, tie in shapes:
        n = 3_000 if d <= 1024 else 600
        counts = rng.integers(0, np.iinfo(dtype).max + 1, (n, d)).astype(dtype)
        moments = [torch.from_numpy(rng.random(n) * 30).to(dev) for _ in range(2)]
        what = f"{dtype.__name__} D={d} keys {tie}"
        for step_kind in STEP_KINDS:
            args, kw = step_inputs(step_case(rng, n, step_kind), counts, moments, dev, tie)
            trip, err = step_check(args, kw, f"{what} {step_kind}")
            wa_err = max(wa_err, err)
            t = trip.tolist()
            trips["bits %d" % t[0] if t[0] else
                  ("min" if t[1] == 0 else "absorb, unc" if t[2] else "absorb")] += 1
            n_cases += 1
        case = step_case(rng, n, "absorb")
        for keys, want in ((tie, 0), (TIE_ALL, 2)):
            args, kw = step_inputs(case, counts, moments, dev, keys, key_tie=tie)
            trip, err = step_check(args, kw, f"{what} key tie under {keys}")
            if int(trip[0]) & 2 != want:
                raise AssertionError(f"{what}: an exact tie on the keys {tie} under the "
                                     f"keys {keys}: trip {trip.tolist()}")
            wa_err = max(wa_err, err)
            trips[f"key tie, bits {int(trip[0])}"] += 1
            n_cases += 1
    phase("c4", f"window_step kernel == plain (trip, alive, assign, astep, members, "
                f"msum) bit for bit in {n_cases} steps (uint8/uint16, D in "
                f"16/256/1024/4096, pools of 3,000 / 600, {'/'.join(STEP_KINDS)}, "
                f"an unaligned store at D = 256, under the 10k model's tie keys "
                f"{tie10k}; D = 16,384 uint8, pool 600, under the k = 7 model's "
                f"{tie_k7}; at each shape an exact dist tie that shares the model's "
                f"keys, under them and under every field, {TIE_ALL}); cases seen "
                f"{dict(sorted(trips.items()))}")
    return wa_err


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


def check_launches(path: str, counted: dict) -> None:
    """Each kernel NEEDS[path] launched, none of FORBIDS[path]."""
    for name in NEEDS[path]:
        if counted[name] <= 0:
            raise AssertionError(f"the {path} path launched no {name} kernel")
    for name in FORBIDS[path]:
        if counted[name]:
            raise AssertionError(f"the {path} path launched {name} "
                                 f"{counted[name]} times")


def update_line(res, want_pairs: int) -> str:
    """The update phase's part of a run: on the default path the phase
    (iterations, counts, abort, its seconds within the update part), whose
    length-passed pairs equal `want_pairs` (the host-driven update's)
    unless it aborted, and the per-iteration updater's; elsewhere the
    updater's pairs, `want_pairs` too."""
    upd, ph = res.updater, res.phase
    if upd is None:
        return "no updater"
    line = (f"updater pairs {upd.scored_pairs}, re-checked "
            f"{upd.rechecked_pairs}")
    if ph is None:
        if upd.scored_pairs != want_pairs:
            raise AssertionError(f"updater pairs {upd.scored_pairs} != {want_pairs}")
        return line
    if ph.last_abort == 0 and (ph.scored_pairs, upd.scored_pairs) != (want_pairs, 0):
        raise AssertionError(f"phase pairs {ph.scored_pairs}, updater pairs "
                             f"{upd.scored_pairs}: not ({want_pairs}, 0)")
    st = res.clock.stamps
    return (f"phase: it {ph.last_iterations}, hist {ph.last_hist}, abort "
            f"{ph.last_abort}, pairs {ph.scored_pairs}, {ph.last_seconds:.4f} s "
            f"of the update part's {st['update'] - st['accumulate']:.4f} s; {line}")


def phase_kernel_checks(ph, clusters, card: str) -> dict:
    """(d6) phase_layout, closest_candidates and merge_replay at the 10k
    default path's shapes: the state `clusters` after accumulate, the first
    iteration's layout, closest-to-mean and the candidates after its real
    filter, the replay of its real merge decisions; each against its plain
    version on the card (exact), with its time, device time and bound
    (kernel_ab.py:phase_bytes; closest_candidates adds its closest-to-mean
    part, which depends on the kept rows), and closest_mean's device time
    on the same filter (the launch the fold extends)."""
    import torch
    from kernel_ab import phase_bytes
    from meshclust2_tpu_torch.ops import phase as P
    from meshclust2_tpu_torch.ops.closest_mean import closest_mean

    dev, delta = ph.device, ph.delta
    n, S = ph.ps.n, len(clusters)
    rows = ph._phase_rows()
    st = ph.init_arrays([SimpleNamespace(center_row=c, members=m)
                         for c, m in clusters])
    lay, lay_p = (P.new_layout(n, S, delta, dev) for _ in range(2))
    P.phase_layout(st, rows, delta, lay)
    P.phase_layout_ref(st, rows, delta, lay_p)
    torch.cuda.synchronize()
    C, n_pairs = lay_p.hdr.tolist()
    if lay.hdr.tolist() != [C, n_pairs]:
        raise AssertionError(f"phase_layout hdr {lay.hdr.tolist()} != {[C, n_pairs]}")
    for f, k in (("rank", S), ("inv", C), ("moff", C + 1), ("flat", n),
                 ("a_rows", n_pairs), ("b_rows", n_pairs), ("seg", n_pairs)):
        if not torch.equal(getattr(lay, f)[:k], getattr(lay_p, f)[:k]):
            raise AssertionError(f"phase_layout's {f} differs from its plain version")
    keep, _ = ph.updater.filter_keep(lay.a_rows[:n_pairs], lay.b_rows[:n_pairs])
    store = ph.store
    ckw = dict(maxc=store.maxc, tie_margin=ph.tie_margin)
    cargs = (store.counts, store.mags, keep, st, rows, delta, lay, C, n_pairs)
    cand, cand_p = (P.new_candidates(S, delta, dev) for _ in range(2))
    first, unc = P.closest_candidates(*cargs, cand, **ckw)
    p_first, p_unc = P.closest_candidates_ref(*cargs, cand_p, **ckw)
    torch.cuda.synchronize()
    m = delta * C
    if not (torch.equal(first, p_first) and torch.equal(unc, p_unc)):
        raise AssertionError("closest_candidates' first or unc differs from its plain "
                             "version")
    for f in ("a", "b", "seg", "ok"):
        if not torch.equal(getattr(cand, f)[:m], getattr(cand_p, f)[:m]):
            raise AssertionError(f"closest_candidates' {f} differs from its plain version")
    if not torch.equal(cand.cen, cand_p.cen) or cand.arrive.any():
        raise AssertionError("closest_candidates' centers differ from its plain version, "
                             "or its arrival counters are not back at 0")
    block_rec = candidates_block_checks(store, keep, st, rows, delta, lay, C, n_pairs,
                                        cand, first, unc, ph.tie_margin, card)
    _, any_m, best, _ = ph.updater.merge_device(cand.a[:m], cand.b[:m], cand.seg[:m],
                                             C, valid=cand.ok[:m])
    t_dst = ph._targets(any_m, best, lay.inv, C, S)
    out, out_p = (P.new_state(n, S, dev) for _ in range(2))
    P.merge_replay(st, t_dst, out)
    P.merge_replay_ref(st, t_dst, out_p)
    for f in ("assign", "seq", "alive", "clen"):
        if not torch.equal(getattr(out, f), getattr(out_p, f)):
            raise AssertionError(f"merge_replay's {f} differs from its plain version")
    events = int((t_dst >= 0).sum())
    nb = phase_bytes(n, S, C, n_pairs, delta)
    # the closest-to-mean part: the kept rows read once with their mags, the
    # pairs' rows, segments and keep flags, first and unc written
    b, sg = lay.b_rows[:n_pairs], lay.seg[:n_pairs]
    kept = b[keep]
    d = store.counts.shape[1]
    nb["closest_candidates"] += (torch_unique(kept) * (d * store.counts.element_size() + 8)
                                 + tbytes(b, sg, keep) + 9 * C)
    ops = {"closest_candidates": CLOSEST_OPS * len(kept) * d + 2 * d}
    runs = {
        "phase_layout": (lambda: P.phase_layout(st, rows, delta, lay),
                         lambda: P.phase_layout_ref(st, rows, delta, lay_p)),
        "closest_candidates": (lambda: P.closest_candidates(*cargs, cand, **ckw),
                               lambda: P.closest_candidates_ref(*cargs, cand_p, **ckw)),
        "merge_replay": (lambda: P.merge_replay(st, t_dst, out),
                         lambda: P.merge_replay_ref(st, t_dst, out_p)),
    }
    rec = {}
    for name, (kernel, plain) in runs.items():
        nbytes = nb[name]
        b_ms, b_by = bound_ms(nbytes, ops.get(name, 0))
        rec[name] = dict(ms=cuda_ms(kernel, reps=50), plain_ms=cuda_ms(plain, reps=10),
                         device_us=device_us(kernel), bound_ms=b_ms, bound_by=b_by)
        r = rec[name]
        phase("d6", f"{name} at the 10k default path's state after accumulate "
                    f"(n = {n}, S = {S}, C = {C}, P = {n_pairs}, {int(keep.sum())} kept, "
                    f"{m} candidates, {events} events): == plain version; kernel "
                    f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms (median, CUDA "
                    f"events), device {r['device_us']:.2f} us (CUDA events behind a busy "
                    f"wait), bound {b_ms:.6f} ms ({b_by}, {nbytes} bytes); {card}")
    cm = rec["closest_candidates"]["closest_mean_device_us"] = device_us(
        lambda: closest_mean(store.counts, store.mags, b, sg, keep, C, **ckw))
    phase("d6", f"closest_mean alone on the same filter (the per-iteration updater's "
                f"instantiation): device {cm:.2f} us; the folded launch "
                f"{rec['closest_candidates']['device_us']:.2f} us; {card}")
    wide_phase_checks(dev, rec, card)
    rec["closest_candidates_block"] = block_rec
    return rec


def window_cases(acc, recorded: dict, n: int) -> dict:
    """(d7)'s cases over accumulator `acc`: the window and the seed that
    `recorded` holds ({mode: (loop state, call)}, the loop state the
    accumulator's six tensors as they stood before the call)."""
    return {f"{mode} {n // 1000}k": (acc, state, call)
            for mode, (state, call) in recorded.items()}


def window_kernel_checks(cases: dict, card: str) -> dict:
    """(d7) window_select (ops/window_select.py) against its plain twin
    (cluster/device_loop.py: `_window_ops`, after `_seed` in a seed step) on
    the card, each case from copies of one loop state (alive, assign,
    astep, members, msum, and the ranks a seed reads): exact on the read,
    cand[:W], the ranks, and alive, assign, astep, members and msum; then
    the kernel's time (CUDA events), its device time behind a busy wait,
    the twin's time, and the bound: the alive flags read and the n + 1
    ranks written, the window's lengths read and its candidates written,
    and a seed's row read and msum written."""
    import torch

    rec = {}
    for name, (acc, state, call) in cases.items():
        tensors = [acc._alive, acc._assign, acc._astep, acc._members, acc._msum,
                   acc._crank0]

        def restore():
            for t, t0 in zip(tensors, state):
                t.copy_(t0)

        if "trip" in call:
            center, trip = call["center"], call["trip"]

            def kernel():
                return acc._sel.window(center.data_ptr(), trip.data_ptr())

            def plain():
                return torch.cat(acc._window_ops(center, trip))
        else:
            cid, stepc = call["cid"], call["stepc"]

            def kernel():
                return acc._sel.seed(cid, stepc)

            def plain():
                seed = (torch.searchsorted(acc._crank0, 1) - 1).view(1)
                acc._seed(seed, cid, stepc)
                return torch.cat(acc._window_ops(seed, None))

        got = []
        for fn in (kernel, plain):
            restore()
            rd = fn().tolist()
            got.append((rd, acc._cand[:rd[4]].clone(), [t.clone() for t in tensors]))
        (rd, cand, after), (want, cand_p, after_p) = got
        if rd != want or not torch.equal(cand, cand_p):
            raise AssertionError(f"window_select ({name}): read {rd} != {want}, or "
                                 f"cand[:W] differs from its plain twin")
        for f, a, b in zip(("alive", "assign", "astep", "members", "msum", "crank"),
                           after, after_p):
            if not torch.equal(a, b):
                raise AssertionError(f"window_select ({name}): {f} differs from its "
                                     f"plain twin")
        n, W = len(acc._alive), rd[4]
        d = acc.store.counts.shape[1]
        nbytes = n + 8 * (n + 1) + 16 * W
        if "cid" in call:
            nbytes += d * acc.store.counts.element_size() + 8 * d
        b_ms, b_by = bound_ms(nbytes, 0)
        r = rec[name] = dict(ms=cuda_ms(kernel, reps=50, setup=restore),
                             plain_ms=cuda_ms(plain, reps=10, setup=restore),
                             device_us=device_us(kernel, setup=restore), bound_ms=b_ms,
                             bound_by=b_by, n=n, W=W, total=rd[6])
        restore()
        phase("d7", f"window_select, {name} (n = {n}, {rd[6]} alive, W = {W}, center "
                    f"{rd[3]}): == plain twin (read, cand[:W], ranks, loop state); kernel "
                    f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms (median, CUDA events), "
                    f"device {r['device_us']:.2f} us (CUDA events behind a busy wait), bound "
                    f"{b_ms:.6f} ms ({b_by}, {nbytes} bytes); {card}")
    return rec


def wide_phase_checks(dev, rec: dict, card: str) -> None:
    """(d6) the wide instantiations of phase_layout and merge_replay, on
    seeded synthetic states (kernel_ab.py:phase_state) of 1,000 slots more
    than each keeps in shared memory: == plain version, device time."""
    import torch
    from kernel_ab import phase_state
    from meshclust2_tpu_torch.ops import phase as P

    delta = 5
    for name in ("phase_layout", "merge_replay"):
        S = P.smem_slots(name, dev) + 1_000
        arr = {k: torch.from_numpy(v).to(dev) for k, v in phase_state(
            4 * S, S, S // 4, seed=20261017).items()}
        st = P.PhaseState(arr["assign"], arr["seq"], arr["cen"], arr["alive"], arr["clen"])
        n = len(st.assign)
        fn = getattr(P, name)
        fn.wide_launches = 0
        if name == "phase_layout":
            rows = P.PhaseRows(arr["lens"], arr["blen"], arr["elen"])
            got, want = (P.new_layout(n, S, delta, dev) for _ in range(2))
            P.phase_layout(st, rows, delta, got)
            P.phase_layout_ref(st, rows, delta, want)
            C, n_pairs = want.hdr.tolist()
            sizes = (("hdr", 2), ("rank", S), ("inv", C), ("moff", C + 1), ("flat", n),
                     ("a_rows", n_pairs), ("b_rows", n_pairs), ("seg", n_pairs))
            kernel = lambda: P.phase_layout(st, rows, delta, got)   # noqa: E731
        else:
            got, want = (P.new_state(n, S, dev) for _ in range(2))
            P.merge_replay(st, arr["t_dst"], got)
            P.merge_replay_ref(st, arr["t_dst"], want)
            sizes = tuple((f, None) for f in ("assign", "seq", "alive", "clen"))
            kernel = lambda: P.merge_replay(st, arr["t_dst"], got)   # noqa: E731
        torch.cuda.synchronize()
        for f, k in sizes:
            if not torch.equal(getattr(got, f)[:k], getattr(want, f)[:k]):
                raise AssertionError(f"{name}'s wide instantiation: {f} differs from "
                                     f"its plain version")
        if fn.wide_launches != 1:
            raise AssertionError(f"{name} at S = {S} launched {fn.wide_launches} wide")
        us = device_us(kernel)
        rec[name].update(wide_slots=S, wide_device_us=us)
        phase("d6", f"{name}, wide instantiation (S = {S}, n = {n}, above the "
                    f"{S - 1_000} slots a block keeps in shared memory): == plain "
                    f"version; device {us:.2f} us; {card}")


def profile_phase(ph, clusters, card: str) -> None:
    """(h2) torch.profiler over the phase alone from the 10k state after
    accumulate: its device events, busy share and kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cl = [SimpleNamespace(center_row=c, members=list(m)) for c, m in clusters]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = ph.run(cl)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name, n_by_name = Counter(), Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us()
            n_by_name[e.name] += 1
    busy = sum(by_name.values()) / 1e6
    events = sum(n_by_name.values())
    ours = "; ".join(
        f"{m.group(0)} {by_name[name] / n_by_name[name]:.1f} us x {n_by_name[name]}"
        for name in sorted(by_name) for m in [re.search(
            r"(layout|candidates|replay|pair_stats|closest_mean)_kernel(<[^>]*>)?",
            name)] if m)
    top = "; ".join(f"{name[:48]} {us / 1e3:.2f} ms/{n_by_name[name]}"
                    for name, us in by_name.most_common(5))
    phase("h2", f"torch.profiler, the phase alone on the 10k state after accumulate: "
                f"it {res.it}, abort {res.abort}; {events} device events "
                f"({events / (res.it + 1):.1f} a pass, the final pass counted), device "
                f"busy {busy * 1e3:.3f} ms of a {wall * 1e3:.3f} ms run "
                f"({100 * busy / wall:.1f} % busy); the kernels (device time per "
                f"launch): {ours}; top: {top}; {card}")


def kmer_kernel_checks(fasta: str, card: str, dev) -> dict:
    """(k) the k-mer histogram kernel (ops/kmer_count.py, MC2_DEVICE_COUNT's
    build) against its plain version on the card and the native counter,
    byte for byte: the 10k set at k = 5 (uint8), a uint8 saturation record
    (2,000 x A), 37 random records with N runs at k = 4 (uint16), a record
    over 1 Mbp (its 1 Mbp split: a window across it does not count) at k = 3
    (uint32) and at k = 5 (uint8: the 2 Mbp record), a homopolymer of
    999,999 bases at k = 5 (every window in one bin) and 2,000 of the 10k
    records at k = 8 (the global instantiation); then, for the 10k set, the
    homopolymer, the 2 Mbp record and the k = 8 set, the kernel's device
    time (CUDA events behind a busy wait), its bound (the codes, offsets and
    segments read once, the counts and 1-mers written once; k operations a
    window) and torch.bincount over the windows' flat indices (the nearest
    one-call PyTorch counterpart: it leaves out the index sweep and the
    saturation); for the 10k set also the wrapper's time and the plain
    version's."""
    import torch
    from meshclust2_tpu_torch import native
    from meshclust2_tpu_torch.io.fasta import encode_sequence, read_fasta
    from meshclust2_tpu_torch.kmer.counting import DTYPE_MAX
    from meshclust2_tpu_torch.ops.kmer_count import (kmer_count, kmer_count_ref,
                                                     kmer_windows, packed_on)

    rng = np.random.default_rng(20261018)
    bench_recs = read_fasta(fasta)
    n_runs = []
    for i in range(37):
        s = rng.choice(list("ACGT"), int(rng.integers(40, 900)))
        for _ in range(int(rng.integers(0, 4))):
            at = int(rng.integers(0, len(s) - 1))
            s[at:at + int(rng.integers(1, 40))] = "N"
        n_runs.append(encode_sequence(f"r{i}", "".join(s)))
    long_rec = encode_sequence("long", "".join(rng.choice(list("ACGT"), 2_000_050)))
    if long_rec.segments.tolist() != [[0, 999_999], [1_000_000, 2_000_049]]:
        raise AssertionError(f"the long record's segments {long_rec.segments.tolist()}")
    homo = encode_sequence("homo", "A" * 999_999)
    cases = {"10k set, k = 5, uint8": (bench_recs, 5, "uint8_t"),
             "saturation (2,000 x A), k = 5, uint8": (
                 [encode_sequence("sat", "A" * 2000 + "CGTACGT" * 30)], 5, "uint8_t"),
             "37 records with N runs, k = 4, uint16": (n_runs, 4, "uint16_t"),
             "2,000,050 bases, split at 1 Mbp, k = 3, uint32": ([long_rec], 3, "uint32_t"),
             "2,000,050 bases, split at 1 Mbp, k = 5, uint8": ([long_rec], 5, "uint8_t"),
             "a homopolymer of 999,999 bases, k = 5, uint8": ([homo], 5, "uint8_t"),
             "2,000 records of the 10k set, k = 8, uint16": (bench_recs[:2000], 8,
                                                               "uint16_t")}
    timed = {"10k set, k = 5, uint8": "tenk",
             "a homopolymer of 999,999 bases, k = 5, uint8": "homopolymer",
             "2,000,050 bases, split at 1 Mbp, k = 5, uint8": "long",
             "2,000 records of the 10k set, k = 8, uint16": "k8"}
    rec = {"max_abs_err": 0, "shapes": {}}
    for name, (recs, k, datatype) in cases.items():
        dtype_max = DTYPE_MAX[datatype]
        packed = packed_on(native._pack_records(recs), dev)
        wide = kmer_count.global_launches
        counts, ones = kmer_count(*packed, k, dtype_max)
        torch.cuda.synchronize()
        p_counts, p_ones = kmer_count_ref(*packed, k, dtype_max)
        want_c, want_o = native.count_kmers_batch(recs, k, dtype_max)
        got_c = counts.cpu().numpy()
        if not (np.array_equal(got_c, p_counts.cpu().numpy()) and torch.equal(ones, p_ones)
                and got_c.dtype == want_c.dtype and np.array_equal(got_c, want_c)
                and np.array_equal(ones.cpu().numpy().astype(np.uint64), want_o)):
            raise AssertionError(f"kmer_count differs from its plain version or the "
                                 f"native counter ({name})")
        if (kmer_count.global_launches - wide) != int(k >= 8):
            raise AssertionError(f"kmer_count's global instantiation ran "
                                 f"{kmer_count.global_launches - wide} times ({name})")
        if "saturation" in name and got_c.max() != 255:
            raise AssertionError("the saturation record did not saturate")
        phase("k", f"kmer_count {name}: {len(recs)} records, {int(packed[1][-1])} codes: "
                   f"== plain version == native counter byte for byte; {card}")
        if name not in timed:
            continue
        flat, _ = kmer_windows(*packed, k)
        nbytes = tbytes(*packed, counts, ones)
        b_ms, b_by = bound_ms(nbytes, k * len(flat))
        run = lambda: kmer_count(*packed, k, dtype_max)   # noqa: E731
        shape = dict(records=len(recs), k=k, windows=len(flat), bytes=nbytes, bound_ms=b_ms,
                     bound_by=b_by, device_us=device_us(run),
                     library_device_us=device_us(lambda: torch.bincount(
                         flat, minlength=len(recs) * 4 ** k)))
        if timed[name] == "tenk":
            shape.update(ms=cuda_ms(run, reps=50),
                         plain_ms=cuda_ms(lambda: kmer_count_ref(*packed, k, dtype_max),
                                          reps=5),
                         library_ms=cuda_ms(lambda: torch.bincount(
                             flat, minlength=len(recs) * 4 ** k), reps=20))
        rec["shapes"][timed[name]] = shape
        del flat
    t = rec["shapes"]["tenk"]
    rec.update({key: t[key] for key in ("ms", "plain_ms", "library_ms", "device_us",
                                        "bound_ms", "bound_by")})
    phase("k", f"kmer_count, the 10k set ({t['records']} records, {t['windows']} windows, "
               f"k = 5, uint8): kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
               f"torch.bincount over the flat indices {t['library_ms']:.4f} ms (median, "
               f"CUDA events); {card}")
    for key, label in (("tenk", "the 10k set"), ("homopolymer", "a homopolymer of 999,999 "
                                                 "bases"),
                       ("long", "the random record of 2,000,050 bases at k = 5"),
                       ("k8", "2,000 records at k = 8 (global instantiation)")):
        sh = rec["shapes"][key]
        phase("k", f"kmer_count, {label}: device {sh['device_us']:.2f} us (CUDA events "
                   f"behind a busy wait), bound {sh['bound_ms'] * 1e3:.2f} us "
                   f"({sh['bound_by']}, {sh['bytes']} bytes, {sh['windows']} windows), "
                   f"{sh['bound_ms'] * 1e3 / sh['device_us']:.1%} of it; torch.bincount "
                   f"over the flat indices {sh['library_device_us']:.2f} us; {card}")
    return rec


# the stages of the CLI's set-up that (k2) times: reading the FASTA, the
# counting (build_point_set: the native packing, then the native counter or
# the device build's upload and its kernel with the read-back), sorting,
# the device session (store upload, kernel builds, warm-ups) and the first
# CUDA use of the process (torch's lazy initialisation; the CLI's
# resolve_device pays it before the clock starts); "gc" is the time
# Python's garbage collector held the process during the run and "gc_fasta"
# its part inside the FASTA read (both inside the other stages)
# (k2)'s runs in this process, True for MC2_DEVICE_COUNT=1: device, native,
# native, device, native, device, device, native (each mode's mean position
# the same; the first run after (k) a device one, the second a native one)
SETUP_ORDER = (True, False, False, True, False, True, True, False)
SETUP_STAGES = ("fasta", "build_point_set", "pack", "native", "device_build", "upload",
                "sort", "session", "cuda_init", "gc", "gc_fasta")


@contextlib.contextmanager
def setup_stages(torch_cli):
    """Time the stages of SETUP_STAGES in the CLI runs inside the block:
    yields the seconds per stage (host clock; the upload synchronises)."""
    import gc

    import torch
    from meshclust2_tpu_torch import native
    from meshclust2_tpu_torch.ops import kmer_count as K
    from meshclust2_tpu_torch.parallel import mesh as M

    secs = Counter()
    patches = []
    open_stages = []
    gc_start = [0.0]

    def on_gc(phase_, info):
        if phase_ == "start":
            gc_start[0] = time.perf_counter()
            return
        dt = time.perf_counter() - gc_start[0]
        secs["gc"] += dt
        if "fasta" in open_stages:
            secs["gc_fasta"] += dt

    def wrap(obj, name, key, sync=False, first_only=False):
        real = getattr(obj, name)

        def timed(*args, **kwargs):
            if first_only and torch.cuda.is_initialized():
                return real(*args, **kwargs)
            t0 = time.perf_counter()
            open_stages.append(key)
            try:
                out = real(*args, **kwargs)
                if sync and torch.cuda.is_available():
                    torch.cuda.synchronize()
                return out
            finally:
                open_stages.pop()
                secs[key] += time.perf_counter() - t0

        patches.append((obj, name, real))
        setattr(obj, name, timed)

    wrap(torch_cli, "read_fasta", "fasta")
    wrap(torch_cli, "build_point_set", "build_point_set")
    wrap(native, "_pack_records", "pack")
    wrap(native, "count_kmers_batch", "native")
    wrap(M, "device_build_counts", "device_build")
    wrap(K, "packed_on", "upload", sync=True)
    wrap(torch_cli, "sort_points", "sort")
    wrap(torch_cli, "_session", "session")
    wrap(torch.cuda, "_lazy_init", "cuda_init", first_only=True)
    gc.callbacks.append(on_gc)
    try:
        yield secs
    finally:
        gc.callbacks.remove(on_gc)
        for obj, name, real in reversed(patches):
            setattr(obj, name, real)


def stage_line(stamp: float, secs) -> str:
    """A run's set-up stamp and its stages; "kernel and read-back" is the
    device build less its packing and upload, "other" the stamp less the
    stages."""
    parts = {k: secs.get(k, 0.0) for k in SETUP_STAGES}
    parts["kernel and read-back"] = (parts["device_build"] - parts["pack"] - parts["upload"]
                                     if parts["device_build"] else 0.0)
    parts["other"] = stamp - sum(parts[k] for k in ("fasta", "build_point_set", "sort",
                                                    "session"))
    return f"set-up {stamp:.4f} s: " + ", ".join(
        f"{k} {v:.4f}" for k, v in parts.items() if k != "device_build")


def setup_stages_main(argv) -> int:
    """`chip_smoke.py --setup-stages native|device FASTA WEIGHTS OUT`: one
    10k default-path run of the CLI in this fresh process with its set-up
    stages timed; prints {"stamp": s, "stages": {...}} as its last line."""
    mode, fasta, weights, out = argv
    sys.path.insert(0, ROOT)
    from meshclust2_tpu_torch import cli as torch_cli

    if mode == "device":
        os.environ["MC2_DEVICE_COUNT"] = "1"
    with setup_stages(torch_cli) as secs:
        res = torch_cli.run(["--device", "cuda", "--recover", weights, "--output", out,
                             fasta])
    if res.rc != 0 or counters(res) != BENCH10K_COUNTERS["default"]:
        raise AssertionError(f"--setup-stages {mode}: rc {res.rc}, counters "
                             f"{counters(res)}")
    print(json.dumps({"stamp": res.clock.stamps["read_in_points"], "stages": dict(secs)}))
    return 0


def step_main() -> int:
    """`chip_smoke.py --step`: the step kernel's checks alone, (c4) and
    (m4) as the whole smoke makes them, after building the two kernels they
    launch."""
    import torch
    sys.path.insert(0, ROOT)
    from meshclust2_tpu_torch.model.classifier import CompiledModel
    from meshclust2_tpu_torch.model.weights import load_weights
    from meshclust2_tpu_torch.ops import _build
    from meshclust2_tpu_torch.ops.window_absorb import step_scratch, tie_keys
    from meshclust2_tpu_torch.runtime import card_name_and_power, resolve_device

    dev = resolve_device("cuda")
    card = card_name_and_power()
    print(card, flush=True)
    for src in ("pair_stats", "window_absorb"):
        built = _build.load(src)
        phase("b", f"built {os.path.relpath(built.path, ROOT)} (nvcc {built.seconds:.3f} s)")
    model = CompiledModel(load_weights(os.path.join(FIX, "bench10k_weights.txt")).classifier)
    tie10k = tie_keys(model.singles, model.combos)
    rng = np.random.default_rng(20261016)
    step_kernel_checks(rng, dev, tie10k)
    store = rng.integers(1, 40, (10_000, 1024)).astype(np.uint8)
    moments = [torch.from_numpy(rng.random(10_000) * 30).to(dev) for _ in range(2)]
    step_block_checks(step_case(rng, 10_000, "absorb", w=1_571, mcnt=9, npos=15), store,
                      moments, step_scratch(10_000, dev), dev, card, tie10k)
    return 0


def mesh_functions_on_the_card(dev, weights: str, card: str) -> None:
    """(m) parallel/mesh.py's SPMD functions on a one-rank NCCL mesh on the
    card against the same functions on a one-rank gloo mesh on the CPU, on
    the same seeded inputs: sharded_mean_update's rows exact and values
    within rtol 1e-5, sharded_glm_solve within 1e-9, and
    sharded_center_scores behind classify_kernel_factory (the 10k model's
    epilogue) within rtol 1e-5 (float32 sums in another order)."""
    import torch
    import torch.distributed as dist
    from meshclust2_tpu_torch.model.classifier import CompiledModel
    from meshclust2_tpu_torch.model.weights import load_weights
    from meshclust2_tpu_torch.parallel import mesh as M

    rng = np.random.default_rng(2026)
    n, d, C = 4_096, 1_024, 16
    H = rng.integers(1, 40, size=(n, d)).astype(np.float32)
    mask = (rng.random((C, n)) < 0.01).astype(np.float32)
    X = np.concatenate([np.ones((4096, 1)), rng.standard_normal((4096, 7))], axis=1)
    y = X @ rng.standard_normal(8) + 0.01 * rng.standard_normal(4096)
    model = CompiledModel(load_weights(weights).classifier)
    epi = M.classify_kernel_factory(model.weights, model.mins, model.maxs, model.is_sim,
                                    model.combos)

    def singles_fn(H_local, center):
        # raw singles inside the model's bounds, from the rows' manhattan
        # distance to the center
        man = (H_local - center[None]).abs().sum(dim=1)
        mn = torch.as_tensor(model.mins, dtype=torch.float32, device=H_local.device)
        mx = torch.as_tensor(model.maxs, dtype=torch.float32, device=H_local.device)
        return mn + (man / man.max())[:, None] * (mx - mn)

    got = {}
    for name, device in (("cuda", dev), ("cpu", "cpu")):
        # one process holds one default group: a one-rank NCCL group for
        # the card, then a one-rank gloo group for the CPU
        if dist.is_initialized():
            dist.destroy_process_group()
        mesh = M.make_mesh(device)
        t = lambda a: torch.from_numpy(a).to(mesh.device)   # noqa: E731
        gmin, garg = M.sharded_mean_update(mesh)(t(H), t(H.sum(axis=1)), t(mask),
                                                 t(np.arange(n)))
        w = M.sharded_glm_solve(mesh)(t(X), t(y))
        p, dd = M.sharded_center_scores(mesh, singles_fn, epi)(t(H), t(H[17]))
        got[name] = [x.cpu().numpy() for x in (gmin, garg, w, p, dd)]
        if name == "cuda" and (mesh.world, dist.get_backend()) != (1, "nccl"):
            raise AssertionError(f"the card's mesh: {mesh}, {dist.get_backend()}")
    dist.destroy_process_group()
    (gm, ga, w, p, dd), (gm0, ga0, w0, p0, dd0) = got["cuda"], got["cpu"]
    if not (np.array_equal(ga, ga0) and np.allclose(gm, gm0, rtol=1e-5)
            and np.allclose(w, w0, rtol=0, atol=1e-9) and np.allclose(p, p0, rtol=1e-5)
            and np.allclose(dd, dd0, rtol=1e-5)):
        raise AssertionError("parallel/mesh.py's functions on the card differ from the CPU")
    phase("m", f"parallel/mesh.py on a one-rank NCCL mesh == a one-rank gloo mesh on the "
               f"CPU: sharded_mean_update (n = {n}, D = {d}, C = {C}) rows exact, values "
               f"max rel {np.nanmax(np.abs(gm - gm0) / np.abs(gm0)):.2e}; "
               f"sharded_glm_solve max abs {np.abs(w - w0).max():.2e}; "
               f"sharded_center_scores + classify_kernel_factory max rel "
               f"{np.abs(p - p0).max() / np.abs(p0).max():.2e}; {card}")


class DecisionCount:
    """One instantiation's launches of the fused kernel
    (pair_stats_decision.full_launches or .plane_launches), read and reset
    like a wrapper's count."""

    def __init__(self, attr: str):
        self.attr = attr

    @property
    def launches(self) -> int:
        from meshclust2_tpu_torch.ops.pair_stats import pair_stats_decision

        return getattr(pair_stats_decision, self.attr)

    @launches.setter
    def launches(self, value: int) -> None:
        from meshclust2_tpu_torch.ops.pair_stats import pair_stats_decision

        setattr(pair_stats_decision, self.attr, value)


def full_specs() -> dict:
    """FULL_MODELS' (singles, combos)."""
    from meshclust2_tpu_torch.features import flags as F

    return {
        "slow": ([F.FEAT_MANHATTAN, F.FEAT_INTERSECTION, F.FEAT_JEFFEREY_DIV,
                  F.FEAT_JENSEN_SHANNON],
                 [("xy", F.FEAT_INTERSECTION),
                  ("xy", F.FEAT_JEFFEREY_DIV | F.FEAT_MANHATTAN),
                  ("x2y2", F.FEAT_JENSEN_SHANNON)]),
        "blockwise": ([F.FEAT_INTERSECTION, F.FEAT_HELLINGER, F.FEAT_CHI_SQUARED,
                       F.FEAT_KL_COND, F.FEAT_MISMATCH],
                      [("xy", F.FEAT_INTERSECTION),
                       ("xy", F.FEAT_HELLINGER | F.FEAT_CHI_SQUARED),
                       ("xy", F.FEAT_KL_COND | F.FEAT_MISMATCH)]),
    }


def plane_specs() -> dict:
    """PLANE_MODELS' (singles, combos): every plane single once, each model
    with one single the statistics give (combo 0, the dist), as the JAX
    tests' models put intersection first."""
    from meshclust2_tpu_torch.features import flags as F

    return {
        "markov": ([F.FEAT_MARKOV, F.FEAT_INTERSECTION, F.FEAT_RRE_K_R,
                    F.FEAT_SIM_MM],
                   [("xy", F.FEAT_INTERSECTION),
                    ("xy", F.FEAT_MARKOV | F.FEAT_SIM_MM),
                    ("xy", F.FEAT_RRE_K_R)]),
        "plane": ([F.FEAT_SPEARMAN, F.FEAT_D2s, F.FEAT_D2_star, F.FEAT_N2RC],
                  [("xy", F.FEAT_SPEARMAN),
                   ("xy", F.FEAT_D2s | F.FEAT_D2_star),
                   ("xy", F.FEAT_N2RC)]),
        "k2": ([F.FEAT_MANHATTAN, F.FEAT_AFD, F.FEAT_N2R, F.FEAT_N2RRC],
               [("xy", F.FEAT_MANHATTAN),
                ("xy", F.FEAT_AFD | F.FEAT_N2R),
                ("xy", F.FEAT_N2RRC)]),
    }


def smoke_model(ps, name: str, sim: float = 0.9):
    """One of FULL_MODELS or PLANE_MODELS over the port's PointSet `ps`,
    built with the port's host formulas the way
    tests/test_device_slow_feats.py:_slow_model ("slow": manhattan,
    intersection, jefferey, jensen-shannon) and
    tests/test_device_extraslow.py:_extraslow_model ("blockwise":
    intersection, hellinger, chi^2, kl_cond, mismatch) build theirs: seed 0,
    600 random pairs, labels from the template_T headers, a least-squares
    fit of +-4 on the combos.  The plane models' combos are products of
    their singles (plane_specs)."""
    from meshclust2_tpu_torch.features import flags as F
    from meshclust2_tpu_torch.features import host as H
    from meshclust2_tpu_torch.model.weights import ModelBlock, PredictorModel

    if name in FULL_MODELS:
        singles, combos = full_specs()[name]
    else:
        singles, combos = plane_specs()[name]
    if name == "slow":
        cols = lambda z: [z[:, 1], z[:, 2] * z[:, 0], z[:, 3] ** 2]
    elif name == "blockwise":
        cols = lambda z: [z[:, 0], z[:, 1] * z[:, 2], z[:, 3] * z[:, 4]]
    else:
        cols = lambda z: [np.prod([z[:, singles.index(f)]
                                   for f in F.split_flags(fl)], axis=0)
                          for _, fl in combos]
    rng = np.random.default_rng(0)
    a_rows = rng.integers(0, ps.n, 600)
    b_rows = rng.integers(0, ps.n, 600)
    keep = a_rows != b_rows
    a_rows, b_rows = a_rows[keep], b_rows[keep]
    raw = H.compute_singles(singles, H.side_from_pointset(ps, a_rows),
                            H.side_from_pointset(ps, b_rows))
    mins, maxs = raw.min(axis=0), raw.max(axis=0)
    z = (raw - mins) / np.where(maxs > mins, maxs - mins, 1.0)
    is_sim = np.array([bool(F.FEAT_IS_SIM[s]) for s in singles])
    z = np.where(is_sim[None, :], z, 1.0 - z)
    label = lambda rows: np.array([ps.headers[r].split("_")[0] for r in rows])
    y = np.where(label(a_rows) == label(b_rows), 1.0, -1.0)
    w, *_ = np.linalg.lstsq(np.column_stack([np.ones(len(y))] + cols(z)),
                            y * 4.0, rcond=None)
    return PredictorModel(k=ps.k, mode=1, max_features=4, id_cutoff=sim,
                          datatype=f"{ps.counts.dtype}_t",
                          feature_set=int(np.bitwise_or.reduce(singles)),
                          classifier=ModelBlock(combos=combos, weights=w,
                                                singles=singles, mins=mins,
                                                maxs=maxs))


def sass_counts(tmp: str, nvcc: str):
    """({"log", "div", "sqrt"} of the main body, the same of the whole
    function): the float64-pipe instructions (D* and MUFU opcodes) that one
    double log, one __ddiv_rn and one __dsqrt_rn compile to for sm_90a, from
    cuobjdump -sass of PROBE_SRC against its copy kernel.  Static counts;
    the main body ends at the function's first unpredicated EXIT, so the
    slow-path subroutines placed after it (special operands) are left out,
    while inline branches for them are still counted."""
    src = os.path.join(tmp, "probe.cu")
    cubin = os.path.join(tmp, "probe.cubin")
    with open(src, "w") as f:
        f.write(PROBE_SRC)
    subprocess.run([nvcc, "-cubin", "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-o", cubin, src], check=True, capture_output=True)
    sass = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"),
                           "-sass", cubin], check=True, capture_output=True,
                          text=True).stdout
    main, whole, cur, ended = Counter(), Counter(), None, False
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            cur, ended = m.group(1), False
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if not (cur and m):
            continue
        op = m.group(2)
        if op.startswith("D") or op.startswith("MUFU"):
            whole[cur] += 1
            main[cur] += not ended
        ended |= op == "EXIT" and not m.group(1)
    out = tuple({k: per[f"f_{k}"] - per["base"] for k in ("log", "div", "sqrt")}
                for per in (main, whole))
    if min(out[0].values()) <= 0:
        raise AssertionError(f"no float64 instructions found in the probes: {out}")
    return out


def full_element_ops(singles, c: dict) -> float:
    """float64 instructions per element of the FULL pass for a model's
    singles, counted from csrc/pair_stats.cu:full_group (the shared
    products once; each log, division and square root as `c` gives it)."""
    from meshclust2_tpu_torch.features import flags as F

    s = set(singles)
    lg, dv, sq = c["log"], c["div"], c["sqrt"]
    ops = 2.0   # the two counts to float64
    if s & {F.FEAT_JEFFEREY_DIV, F.FEAT_JENSEN_SHANNON, F.FEAT_K_DIV}:
        ops += 2                                  # a mB, b mA
    if F.FEAT_JEFFEREY_DIV in s:
        ops += 1 + dv + lg + 1 + 2 + 5            # difference, log, term, sums
    if s & {F.FEAT_JENSEN_SHANNON, F.FEAT_K_DIV}:
        ops += 2 + dv + lg + 1 + 3
    if F.FEAT_JENSEN_SHANNON in s:
        ops += 1 + dv + lg + 1 + 3
    if F.FEAT_KL_COND in s:
        ops += 2 + dv + lg + 2 + 6 + 1            # group sums, a quarter each
    if F.FEAT_HELLINGER in s:
        ops += 2 * (1 + dv + sq) + 1 + 2 + 4
    if F.FEAT_SQCHORD in s:
        ops += 4 + sq
    ops += sum(3 + dv for f in (F.FEAT_CHI_SQUARED, F.FEAT_CANBERRA,
                                F.FEAT_KULCZYNSKI1, F.FEAT_HARMONIC_MEAN)
               if f in s)
    ops += sum(2 for f in (F.FEAT_MISMATCH, F.FEAT_JACCARD) if f in s)
    return ops


def full_bound(store, a, b, singles, n_combos: int, c: dict):
    """The FULL kernel's least time: decision_bound's bytes with the two
    bounds also written (40 bytes a pair out), and its operations: the
    statistics' at OPS_PER_S plus the FULL pass's float64 instructions at
    F64_INSTR_PER_S, each element once."""
    rows = int(torch_unique(a, b))
    d = store.shape[1]
    p = len(a)
    nbytes = (rows * (d * store.element_size() + 32) + tbytes(a, b) + 64 * p
              + 8 * (4 + 4 * (len(singles) + n_combos)))
    t_ops = ((PAIR_OPS * p * d + p * (EPI_OPS_PAIR + EPI_OPS_SINGLE * len(singles)
                                      + EPI_OPS_COMBO * n_combos)) / OPS_PER_S
             + full_element_ops(singles, c) * p * d / F64_INSTR_PER_S) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def full_kernel_checks(dev, rng) -> float:
    """(c5) The fused kernel's FULL instantiation on random rows with eight
    near-identical pairs, uint8 and uint16, the register and the loop paths,
    both forms: its statistics bit for bit the plain version's; each
    full-vector single, through a probe model whose dist is the single
    itself, and s and dist of the two FULL_MODELS, within their bounds of
    the plain version (the sum of both bounds) and of the port's numpy host
    oracle (features/host.py; the kernel's bound).  Returns the largest
    |kernel - plain| over s and dist."""
    import dataclasses

    import torch
    from meshclust2_tpu_torch.cluster.device_store import DeviceStore
    from meshclust2_tpu_torch.features import flags as F
    from meshclust2_tpu_torch.features import host as H
    from meshclust2_tpu_torch.model.classifier import (
        PARAM_HEAD, VECTOR_SINGLES, CompiledModel, model_to_torch)
    from meshclust2_tpu_torch.model.weights import ModelBlock
    from meshclust2_tpu_torch.ops.pair_stats import (
        pair_stats_decision, pair_stats_decision_ref)

    def probe(flag):
        """dist = the single's raw value, dist_err its bound: min 0, max 1,
        read as a similarity."""
        params = model_to_torch(CompiledModel(ModelBlock(
            combos=[("xy", flag)], weights=[0.0, 1.0], singles=[flag],
            mins=[0.0], maxs=[1.0])), dev)
        pk = params.packed.clone()
        pk[PARAM_HEAD + 3] = 1.0
        return dataclasses.replace(params, packed=pk,
                                   is_sim=torch.ones_like(params.is_sim))

    def side(counts, mags, idx):
        return H.PairSide(counts=counts[idx].astype(np.float64), mags=mags[idx],
                          one_mers=np.zeros((len(idx), 4)),
                          stddevs=np.ones(len(idx)), lengths=np.ones(len(idx)),
                          k=1)

    worst, n_cases = 0.0, 0
    for dtype, d, high in ((np.uint8, 16, 60), (np.uint8, 512, 60),
                           (np.uint8, 1024, 60), (np.uint8, 4096, 60),
                           (np.uint16, 16, 3000), (np.uint16, 256, 3000),
                           (np.uint16, 1024, 3000)):
        n = 300
        counts = rng.integers(1, high, (n, d))
        counts[8:16] = counts[:8]
        counts[8:16, : max(2, d // 100)] += 1
        counts = counts.astype(dtype)
        c64 = counts.astype(np.int64)
        mags = c64.sum(axis=1).astype(np.float64)
        up = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        st = DeviceStore(counts=up(counts), mags=up(mags),
                         selfdot=up((c64 * c64).sum(axis=1).astype(np.float64)),
                         lens=up(rng.integers(700, 1500, n).astype(np.float64)),
                         stddevs=up(rng.random(n) * 3 + 0.5), maxc=int(counts.max()))
        a = np.concatenate([np.arange(8), rng.integers(0, n, 400)])
        forms = {"pair": (a, np.concatenate([np.arange(8, 16),
                                              rng.integers(0, n, 400)])),
                 "center": (a, np.full(len(a), 8))}
        if d == 1024:   # one pair, and a window no multiple of the split
            forms.update({"center W=1": (a[:1], np.full(1, 8)),
                          "center W=37": (a[:37], np.full(37, 8))})
        for form, (a_np, b_np) in forms.items():
            a_d = up(a_np)
            b_d = up(b_np[:1] if form.startswith("center") else b_np)
            A, B = side(counts, mags, a_np), side(counts, mags, b_np)
            models = {H_name: probe(f) for f, H_name in
                      ((f, F.FEAT_NAMES[f]) for f in VECTOR_SINGLES)}
            host = {F.FEAT_NAMES[f]: H.compute_singles([f], A, B)[:, 0]
                    for f in VECTOR_SINGLES}
            for name, (singles, combos) in full_specs().items():
                raw = H.compute_singles(singles, A, B)
                lo, hi = raw.min(axis=0), raw.max(axis=0)
                cm = CompiledModel(ModelBlock(
                    combos=combos, weights=rng.normal(0.0, 2.0, len(combos) + 1),
                    singles=singles, mins=lo, maxs=np.where(hi > lo, hi, lo + 1.0)))
                models[name] = model_to_torch(cm, dev)
                host[name] = cm.decision_from_raw(raw)
            for name, params in models.items():
                what = f"{np.dtype(dtype).name} D={d} {form} form, {name}"
                stats, dec = pair_stats_decision(st, params, a_d, b_d)
                torch.cuda.synchronize()
                p_stats, p_dec = pair_stats_decision_ref(st, params, a_d, b_d)
                if not torch.equal(stats, p_stats):
                    raise AssertionError(f"FULL statistics differ: {what}")
                k, pl = dec.cpu().numpy(), p_dec.cpu().numpy()
                for r, e in ((0, 3), (2, 4)):
                    diff = np.abs(k[r] - pl[r])
                    if not (diff <= k[e] + pl[e]).all():
                        raise AssertionError(f"FULL kernel and plain differ beyond "
                                             f"their bounds (row {r}): {what}")
                    worst = max(worst, float(diff.max()))
                want = host[name]
                if isinstance(want, tuple):   # (s, prob, dist) of a model
                    ok = ((np.abs(k[0] - want[0]) <= k[3]).all()
                          and (np.abs(k[2] - want[2]) <= k[4]).all())
                else:                         # a probe: dist is the single
                    ok = (np.abs(k[2] - want) <= k[4]).all()
                if not ok:
                    raise AssertionError(f"FULL kernel beyond its bound of the "
                                         f"host oracle: {what}")
                n_cases += 1
        # an index outside the store: -1 statistics and NaN decisions
        stats, dec = pair_stats_decision(st, models["slow"], up(np.array([3, n, 4])),
                                         up(np.array([9, 10, -1])))
        _, bad = pair_stats_decision(st, models["slow"], up(np.array([3])),
                                     up(np.array([n])))
        torch.cuda.synchronize()
        if not (bool((stats[1:] == -1).all()) and bool(torch.isnan(dec[:, 1:]).all())
                and bool(torch.isfinite(dec[:, 0]).all()) and bool(torch.isnan(bad).all())):
            raise AssertionError(f"FULL kernel at an invalid index: {stats}, {dec}")
    phase("c5", f"pair_stats_decision FULL kernel: statistics == plain bit for bit, "
                f"each of the 12 full-vector singles (probe models) and s, dist of "
                f"the slow and blockwise models within their bounds of the plain "
                f"version and of the numpy host oracle, in {n_cases} cases "
                f"(uint8 D 16/512/1024/4096, uint16 D 16/256/1024, eight "
                f"near-identical pairs among 408, center and pair forms, at D = "
                f"1024 also a center window of 1 and of 37 pairs); an invalid "
                f"index gives -1 and NaN; largest |kernel - plain| {worst:.3g}")
    return worst


def full_model_phase(tag: str, torch_cli, fasta: str, n_seqs: int, tmp: str,
                     card: str, wrappers: dict, launches: dict) -> None:
    """(e2) / (f4): both FULL_MODELS, built over `fasta`'s pool, on the
    port's three paths on the card, each held against the JAX package's
    --device host run of the same weights on the same machine: the whole
    CLSTR byte for byte, the clusters before update and update
    iterations, and the windows but the one the host scans again after
    each abort at a window's decisions (pairs scored differ by path: the
    accumulator scores whole windows, the scorer path reuses its cache);
    each run's launches counted from zero into
    `launches`, its host re-checks and accumulator aborts printed."""
    from meshclust2_tpu_torch.model.weights import save_weights

    _, ps = torch_cli.load_sorted_points([fasta], [], 5, "uint8_t", False,
                                         keep_seqs_train=False)
    for name in FULL_MODELS:
        w = os.path.join(tmp, f"{tag}_{name}_weights.txt")
        save_weights(w, smoke_model(ps, name))
        host_out = os.path.join(tmp, f"{tag}_{name}_host.clstr")
        proc = subprocess.run(
            [sys.executable, "-c", JAX_CLI_COUNTED, "--device", "host",
             "--recover", w, "--output", host_out, fasta],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"JAX host run ({tag} {name}) exited "
                                 f"{proc.returncode}:\n{proc.stderr[-2000:]}")
        host_c = tuple(int(x) for x in re.search(
            r"^counters (\d+) (\d+) (\d+) (\d+)$", proc.stdout, re.M).groups())
        host_st = {m.group(1): float(m.group(2)) for m in re.finditer(
            r"^timestamp (\S+) (\S+)$", proc.stdout, re.M)}
        with open(host_out, "rb") as f:
            want = f.read()
        for path in PATHS:
            out = os.path.join(tmp, f"{tag}_{name}_{path}.clstr")
            for fn in wrappers.values():
                fn.launches = 0
            res = run_path(torch_cli, path, ["--device", "cuda", "--recover", w,
                                             "--output", out, fasta])
            counted = {k: fn.launches for k, fn in wrappers.items()}
            launches[f"{tag}_{name}_{path}"] = counted
            if res.rc != 0:
                raise AssertionError(f"port CLI exited {res.rc} ({tag} {name} {path})")
            check_launches("full_" + path, counted)
            with open(out, "rb") as f:
                if f.read() != want:
                    raise AssertionError(f"{tag} {name} CLSTR differs from the "
                                         f"JAX --device host run ({path})")
            c = counters(res)
            acc = res.accumulator
            # a window the accumulator aborted at its decisions is counted
            # again when the host scans it (the JAX DeviceAccumulator counts
            # it too): exactly one window each
            redone = c[0] - host_c[0]
            if ((c[2], c[3]) != (host_c[2], host_c[3])
                    or redone != (acc.window_aborts if acc is not None else 0)):
                raise AssertionError(f"{tag} {name} counters {c} vs the JAX "
                                     f"host run's {host_c} ({path})")
            acc_line = ("no accumulator" if acc is None else
                        f"accumulator steps {acc.total_steps}, aborts {acc.aborts} "
                        f"({acc.window_aborts} at a window's decisions)")
            if acc is not None and acc.error is not None:
                raise AssertionError(f"accumulator failed: {acc.error!r}")
            upd = ("no updater" if res.updater is None else
                   f"updater pairs {res.updater.scored_pairs}, re-checked "
                   f"{res.updater.rechecked_pairs}")
            if res.phase is not None:
                ph = res.phase
                upd = (f"phase it {ph.last_iterations}, hist {ph.last_hist}, abort "
                       f"{ph.last_abort}, pairs {ph.scored_pairs}, "
                       f"{ph.last_seconds:.4f} s; {upd}")
            phase(tag, f"{os.path.basename(fasta)}, {name} model ({path}): CLSTR "
                       f"== JAX --device host byte for byte, counters {c} (JAX "
                       f"host {host_c}); scorer pairs {res.scorer.scored_pairs}, "
                       f"re-checked {res.scorer.rechecked_pairs}; {upd}; "
                       f"{acc_line}; {window_parts(res.clock.stamps, n_seqs)}; "
                       f"launches {counted}; {card}")
        phase(tag, f"{os.path.basename(fasta)}, {name} model: JAX package "
                   f"--device host, same file and machine: "
                   f"{window_parts(host_st, n_seqs)}")


def plane_flags(k: int):
    """Every plane single a pool of k takes (afd needs k = 2)."""
    from meshclust2_tpu_torch.features import flags as F
    from meshclust2_tpu_torch.model.classifier import PLANE_SINGLES

    return [f for f in PLANE_SINGLES if k == 2 or f != F.FEAT_AFD]


def synthetic_pool(counts, rng, k: int):
    """A port PointSet over the count rows `counts` (pseudocounted, >= 1)
    with random one-mers, lengths and stddevs."""
    from meshclust2_tpu_torch.kmer.counting import PointSet

    n = len(counts)
    return PointSet(k=k, headers=[f"s{i}" for i in range(n)], counts=counts,
                    one_mers=rng.integers(1, 400, (n, 4)).astype(np.uint64),
                    lengths=rng.integers(700, 1500, n).astype(np.int64),
                    mags=counts.astype(np.int64).sum(axis=1),
                    stddevs=rng.random(n) * 3 + 0.5, ids=np.arange(n))


# float64 instructions per element of each plane single in
# csrc/plane_singles.cu:lane_sums, beside its logs, divisions and square
# roots (pow counted as two logs, hypot as a square root and a division);
# the two counts' conversions are shared
PLANE_OPS = {"markov": (14, 0, 0, 0), "rre_k_r": (21, 2, 4, 0),
             "spearman": (2, 0, 0, 0), "d2s": (9, 0, 2, 1),
             "afd": (8, 2, 2, 0), "n2": (4, 0, 0, 0)}


def plane_element_ops(flags, c: dict, k: int) -> float:
    """float64 instructions per element of the plane kernel for the plane
    singles `flags`, each log, division and square root as `c` gives them
    (sass_counts)."""
    from meshclust2_tpu_torch.features import flags as F

    s = set(flags)
    parts = []
    if s & {F.FEAT_MARKOV, F.FEAT_SIM_MM}:
        parts.append(PLANE_OPS["markov"])
    if F.FEAT_RRE_K_R in s:
        parts.append(PLANE_OPS["rre_k_r"])
    if F.FEAT_SPEARMAN in s:
        parts.append(PLANE_OPS["spearman"])
    if F.FEAT_D2s in s:
        parts.append(PLANE_OPS["d2s"])
    if F.FEAT_D2_star in s:
        parts.append((k + 6 + (F.FEAT_D2s not in s), 0, 1, 0))
    if F.FEAT_AFD in s:
        parts.append(PLANE_OPS["afd"])
    parts += [PLANE_OPS["n2"]] * len(s & {F.FEAT_N2R, F.FEAT_N2RC, F.FEAT_N2RRC})
    return 2.0 + sum(o + lg * c["log"] + dv * c["div"] + sq * c["sqrt"]
                     for o, lg, dv, sq in parts)


def plane_bound(planes, a, b, flags, c: dict):
    """The plane kernel's least time: each referenced row's plane rows that
    `flags` read, its counts and scalars read once, the log tables read
    once, the indices read and [2, S, P] float64 written, at
    HBM_BYTES_PER_S; or its float64 instructions (plane_element_ops) at
    F64_INSTR_PER_S, each element of each pair once; the larger."""
    from meshclust2_tpu_torch.ops.plane_singles import NEEDS

    rows = int(torch_unique(a, b))
    n = planes.counts.shape[0]
    names = set().union(*(NEEDS[f] for f in flags))
    per_row = (planes.counts.shape[1] * planes.counts.element_size() + 7 * 8
               + sum(getattr(planes, m)[0].numel() * getattr(planes, m).element_size()
                     for m in names if getattr(planes, m).shape[0] == n))
    tables = sum(tbytes(getattr(planes, m)) for m in names
                 if getattr(planes, m).shape[0] != n)
    nbytes = rows * per_row + tables + tbytes(a, b) + 16 * len(flags) * len(a)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (plane_element_ops(flags, c, planes.k) * len(a)
             * planes.counts.shape[1] / F64_INSTR_PER_S * 1e3)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def plane_decision_specs():
    """The plane models' (singles, combos) and one with a full-vector single
    beside plane singles (the FULL and PLANE epilogue), each with its k."""
    from meshclust2_tpu_torch.features import flags as F

    out = {name: (2 if name == "k2" else 5,) + spec
           for name, spec in plane_specs().items()}
    out["full_plane"] = (5, [F.FEAT_HELLINGER, F.FEAT_MARKOV, F.FEAT_INTERSECTION,
                             F.FEAT_SPEARMAN],
                         [("xy", F.FEAT_INTERSECTION),
                          ("xy2", F.FEAT_HELLINGER | F.FEAT_MARKOV),
                          ("x2y2", F.FEAT_SPEARMAN)])
    return out


def plane_kernel_checks(dev, rng) -> float:
    """(c6) The plane-singles kernel on random pools with eight
    near-identical pairs, k = 5 (uint8, uint16) and k = 2 (D = 16, uint8,
    uint16), both forms: every plane single the k takes within the sum of
    both bounds of its plain version and within the kernel's bound of the
    port's numpy host oracle (features/host.py); then the fused kernel's
    PLANE instantiation on the same pairs, for the three plane models and
    one with full-vector and plane singles: statistics bit for bit the
    plain version's, s and dist within both bounds of it and within the
    kernel's bounds of the host CompiledModel; an index outside the pool
    gives NaN.  Returns the largest |kernel - plain| over the singles and
    over s and dist."""
    import torch
    from meshclust2_tpu_torch.cluster.device_store import DeviceStore
    from meshclust2_tpu_torch.features import flags as F
    from meshclust2_tpu_torch.features import host as H
    from meshclust2_tpu_torch.model.classifier import (
        PLANE_SINGLES, CompiledModel, model_to_torch)
    from meshclust2_tpu_torch.model.weights import ModelBlock
    from meshclust2_tpu_torch.ops.device_features import TorchDeviceFeatureEngine
    from meshclust2_tpu_torch.ops.pair_stats import (
        pair_stats_decision, pair_stats_decision_ref)
    from meshclust2_tpu_torch.ops.plane_singles import (
        plane_singles, plane_singles_ref)

    worst, dworst, n_cases = 0.0, 0.0, 0
    for k, dtype, high in ((5, np.uint8, 60), (5, np.uint16, 1000),
                           (2, np.uint8, 60), (2, np.uint16, 1000), (6, np.uint8, 60)):
        n, d = 300, 4 ** k
        counts = rng.integers(1, high, (n, d))
        counts[8:16] = counts[:8]
        counts[8:16, : max(2, d // 100)] += 1
        ps = synthetic_pool(counts.astype(dtype), rng, k)
        store = DeviceStore.from_pointset(ps, dev)
        flags = plane_flags(k)
        eng = TorchDeviceFeatureEngine(ps, flags, store)
        a_all = np.concatenate([np.arange(8), rng.integers(0, n, 400)])
        forms = {"pair": np.concatenate([np.arange(8, 16), rng.integers(0, n, 400)]),
                 "center": np.full(len(a_all), 8)}
        if k == 5:   # one pair, and a window no multiple of the split
            forms.update({"center W=1": np.full(1, 8), "center W=37": np.full(37, 8)})
        for form, b in forms.items():
            what = f"k={k} {np.dtype(dtype).name} {form} form"
            a = a_all[:len(b)]
            a_d = torch.from_numpy(a).to(dev)
            b_d = torch.from_numpy(b[:1] if form.startswith("center") else b).to(dev)
            got = plane_singles(eng.planes, a_d, b_d, flags)
            torch.cuda.synchronize()
            plain = plane_singles_ref(eng.planes, a_d, b_d, flags)
            if not (torch.isfinite(got).all() and bool(
                    ((got[0] - plain[0]).abs() <= got[1] + plain[1]).all())):
                raise AssertionError(f"plane_singles kernel and plain differ "
                                     f"beyond their bounds: {what}")
            worst = max(worst, float((got[0] - plain[0]).abs().max()))
            A, B = H.side_from_pointset(ps, a), H.side_from_pointset(ps, b)
            host = H.compute_singles(flags, A, B)
            k_np = got.cpu().numpy()
            for j, flag in enumerate(flags):
                if not (np.abs(k_np[0, j] - host[:, j]) <= k_np[1, j]).all():
                    raise AssertionError(f"plane_singles beyond its bound of the "
                                         f"host oracle ({F.FEAT_NAMES[flag]}): {what}")
            n_cases += 1
            for name, (mk, singles, combos) in plane_decision_specs().items():
                if mk != k:
                    continue
                raw = H.compute_singles(singles, A, B)
                lo, hi = raw.min(axis=0), raw.max(axis=0)
                cm = CompiledModel(ModelBlock(
                    combos=combos, weights=rng.normal(0.0, 2.0, len(combos) + 1),
                    singles=singles, mins=lo, maxs=np.where(hi > lo, hi, lo + 1.0)))
                params = model_to_torch(cm, dev)
                pl = plane_singles(eng.planes, a_d, b_d,
                                   [f for f in singles if f in PLANE_SINGLES])
                stats, dec = pair_stats_decision(store, params, a_d, b_d, pl)
                torch.cuda.synchronize()
                p_stats, p_dec = pair_stats_decision_ref(store, params, a_d, b_d, pl)
                if not torch.equal(stats, p_stats):
                    raise AssertionError(f"PLANE statistics differ: {what}, {name}")
                kd, pd = dec.cpu().numpy(), p_dec.cpu().numpy()
                want = cm.decision_from_raw(raw)
                for r, e in ((0, 3), (2, 4)):
                    if not ((np.abs(kd[r] - pd[r]) <= kd[e] + pd[e]).all()
                            and (np.abs(kd[r] - want[r]) <= kd[e]).all()):
                        i = int(np.argmax(np.abs(kd[r] - want[r]) - kd[e]))
                        raise AssertionError(
                            f"PLANE kernel beyond its bounds (row {r}): {what}, "
                            f"{name}: pair {i} ({a[i]}, {b[i if len(b) > 1 else 0]}): "
                            f"kernel {kd[r][i]!r} +- {kd[e][i]!r}, plain {pd[r][i]!r} "
                            f"+- {pd[e][i]!r}, host {want[r][i]!r}")
                    dworst = max(dworst, float(np.abs(kd[r] - pd[r]).max()))
                n_cases += 1
        bad = torch.tensor([3, n], device=dev)
        got = plane_singles(eng.planes, bad, torch.tensor([5, 6], device=dev), flags)
        torch.cuda.synchronize()
        if not (torch.isfinite(got[:, :, 0]).all() and torch.isnan(got[:, :, 1]).all()):
            raise AssertionError(f"plane_singles at an invalid index: {got}")
    phase("c6", f"plane_singles kernel: each plane single within both bounds of "
                f"the plain version and within its bound of the numpy host "
                f"oracle, and the PLANE instantiation's statistics bit for bit, "
                f"s and dist within bounds of the plain version and the host "
                f"model (markov, plane, k2 and a FULL and PLANE model), in "
                f"{n_cases} cases (k = 5 uint8/uint16 D = 1024, k = 2 uint8/uint16 "
                f"D = 16, k = 6 uint8 D = 4096, eight near-identical pairs among "
                f"408, center and pair forms, at k = 5 also a center window of 1 "
                f"and of 37 pairs); an invalid index gives NaN; largest "
                f"|kernel - plain| "
                f"{worst:.3g} (singles), {dworst:.3g} (s, dist)")
    return worst, dworst


def plane_model_run(torch_cli, tag: str, name: str, fasta: str, weights: str,
                    tmp: str, wrappers: dict, launches: dict):
    """One run of the port's CLI on the card with a plane model: its
    launches counted from zero into `launches`, checked against
    NEEDS["plane"] and FORBIDS["plane"], and the scorer alone (no
    accumulator or updater).  Returns (ClusterRun, CLSTR path)."""
    out = os.path.join(tmp, f"{tag}_{name}.clstr")
    for fn in wrappers.values():
        fn.launches = 0
    res = torch_cli.run(["--device", "cuda", "--recover", weights, "--output",
                         out, fasta])
    counted = {k: fn.launches for k, fn in wrappers.items()}
    launches[f"{tag}_{name}"] = counted
    if res.rc != 0:
        raise AssertionError(f"port CLI exited {res.rc} ({tag} {name})")
    check_launches("plane", counted)
    if (res.accumulator is not None or res.updater is not None
            or res.scorer.engine is None):
        raise AssertionError(f"{tag} {name}: not the device scorer alone")
    return res, out


def plane_line(res, n_seqs: int, counted: dict) -> str:
    """A plane-model run's window, re-checks by rule and launches."""
    sc = res.scorer
    i, ii, iii = (int(x) for x in sc.rechecked_by_rule)
    return (f"{window_parts(res.clock.stamps, n_seqs)}; plane store built in "
            f"{sc.engine.seconds:.3f} s (set-up); scorer pairs {sc.scored_pairs}, "
            f"re-checked {sc.rechecked_pairs} (rule (i) {i}, (ii) {ii}, (iii) "
            f"{iii}) in {sc.recheck_seconds:.3f} s on the host; launches {counted}")


def plane_model_phase(torch_cli, fasta: str, tmp: str, card: str,
                      wrappers: dict, launches: dict) -> None:
    """(e3): the three PLANE_MODELS, each built over `fasta`'s pool at its k
    (smoke_model), through the port's CLI on the card (the scorer alone),
    each held against the JAX package's --device host run of the same
    weights on the same machine, a separate program: the CLSTR byte for
    byte and the engine counters (both drive the engine's host loops)."""
    from meshclust2_tpu_torch.model.weights import save_weights

    for name in PLANE_MODELS:
        k, datatype = (2, "uint16_t") if name == "k2" else (5, "uint8_t")
        _, ps = torch_cli.load_sorted_points([fasta], [], k, datatype, False,
                                             keep_seqs_train=False)
        w = os.path.join(tmp, f"e3_{name}_weights.txt")
        save_weights(w, smoke_model(ps, name))
        host_out = os.path.join(tmp, f"e3_{name}_host.clstr")
        proc = subprocess.run(
            [sys.executable, "-c", JAX_CLI_COUNTED, "--device", "host",
             "--recover", w, "--output", host_out, fasta],
            cwd=ROOT, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise AssertionError(f"JAX host run (e3 {name}) exited "
                                 f"{proc.returncode}:\n{proc.stderr[-2000:]}")
        host_c = tuple(int(x) for x in re.search(
            r"^counters (\d+) (\d+) (\d+) (\d+)$", proc.stdout, re.M).groups())
        host_st = {m.group(1): float(m.group(2)) for m in re.finditer(
            r"^timestamp (\S+) (\S+)$", proc.stdout, re.M)}
        res, out = plane_model_run(torch_cli, "e3", name, fasta, w, tmp, wrappers,
                                   launches)
        with open(out, "rb") as f, open(host_out, "rb") as g:
            if f.read() != g.read():
                raise AssertionError(f"e3 {name} CLSTR differs from the JAX "
                                     f"--device host run")
        if counters(res) != host_c:
            raise AssertionError(f"e3 {name} counters {counters(res)} vs the JAX "
                                 f"host run's {host_c}")
        phase("e3", f"med2000, {name} model (k = {k}): CLSTR == JAX --device host "
                    f"byte for byte, counters {host_c}; "
                    f"{plane_line(res, 2000, launches[f'e3_{name}'])}; JAX --device "
                    f"host, same file and machine: {window_parts(host_st, 2000)}; "
                    f"{card}")


def fastcar_phase(fasta: str, tmp: str, card: str, wrappers: dict,
                  launches: dict) -> dict:
    """(fc) fastcar on the 10k set `fasta`.  Its default training with
    --dump on the card (the pair tables through the statistics-only
    kernel), held byte for byte against the JAX fastcar's --dump; then an
    all-vs-all --recover search (db = queries = the 10k file: one block)
    through the fused kernel in slices, held byte for byte against the JAX
    fastcar's default host route; each run's launches counted from zero
    into `launches`; the kernel against its plain version, timed and
    bounded at the search's largest slice.  Returns the kernels line's
    record of that slice."""
    import torch
    from meshclust2_tpu_torch.cluster import device_update
    from meshclust2_tpu_torch.model.weights import load_weights
    from meshclust2_tpu_torch.ops.pair_stats import (
        pair_stats_decision, pair_stats_decision_ref)
    from meshclust2_tpu_torch import fastcar as torch_fastcar

    fc_dir = os.path.join(tmp, "fastcar")
    os.makedirs(fc_dir)
    jax_env = {k: v for k, v in os.environ.items() if k != "MC2_FASTCAR_DEVICE"}
    port_fw = os.path.join(fc_dir, "port_weights.txt")
    host_fw = os.path.join(fc_dir, "host_weights.txt")
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res_ft = torch_fastcar.run(["--device", "cuda", fasta, "-q", fasta,
                                *FASTCAR_TRAIN_FLAGS, "--dump", port_fw])
    port_train_wall = time.perf_counter() - t0
    launches["fastcar_train"] = {name: fn.launches for name, fn in wrappers.items()}
    if res_ft.rc != 0:
        raise AssertionError(f"port fastcar training exited {res_ft.rc}")
    check_launches("fastcar_train", launches["fastcar_train"])
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "meshclust2_tpu.fastcar", fasta, "-q", fasta,
         *FASTCAR_TRAIN_FLAGS, "--dump", host_fw],
        cwd=ROOT, env=jax_env, capture_output=True, text=True, timeout=900)
    host_train_wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"JAX fastcar training exited {proc.returncode}:\n"
                             f"{proc.stderr[-2000:]}")
    with open(port_fw, "rb") as f, open(host_fw, "rb") as g:
        if f.read() != g.read():
            raise AssertionError("fastcar weights differ from the JAX fastcar's")
    fw = load_weights(port_fw)
    phase("fc", f"fastcar training, 10k ({' '.join(FASTCAR_TRAIN_FLAGS)}) on "
                f"the card: weights == JAX fastcar --dump byte for byte "
                f"(classifier {fw.classifier.combos}, regressor "
                f"{fw.regressor.combos}); launches {launches['fastcar_train']}; "
                f"process wall: port (in process) {port_train_wall:.3f} s, "
                f"JAX {host_train_wall:.3f} s; {card}")

    port_fo = os.path.join(fc_dir, "port.search")
    host_fo = os.path.join(fc_dir, "host.search")
    fc_slices = []

    def recording_decision(store_, params_, a_, b_):
        """pair_stats_decision, keeping the largest call's inputs."""
        if not fc_slices or len(a_) > len(fc_slices[-1][2]):
            fc_slices.append((store_, params_, a_, b_))
        return pair_stats_decision(store_, params_, a_, b_)

    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    device_update.pair_stats_decision = recording_decision
    try:
        res_fs = torch_fastcar.run(["--device", "cuda", fasta, "-q", fasta,
                                    "--recover", port_fw, "-o", port_fo])
    finally:
        device_update.pair_stats_decision = pair_stats_decision
    launches["fastcar"] = {name: fn.launches for name, fn in wrappers.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if res_fs.rc != 0:
        raise AssertionError(f"port fastcar search exited {res_fs.rc}")
    check_launches("fastcar", launches["fastcar"])
    fst = res_fs.stats
    if (fst.blocks, fst.device_blocks, fst.host_reasons) != (1, 1, []):
        raise AssertionError(f"the fastcar search did not run on the card: {fst}")
    proc = subprocess.run(
        [sys.executable, "-c", JAX_FASTCAR_STAMPED, fasta, "-q", fasta,
         "--recover", port_fw, "-o", host_fo],
        cwd=ROOT, env=jax_env, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"JAX fastcar search exited {proc.returncode}:\n"
                             f"{proc.stderr[-2000:]}")
    host_st = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^stamp ([a-z ]+): (\S+)$", proc.stdout, re.M)}
    host_pos = re.findall(r"^# of predicted positive: \d+$", proc.stdout, re.M)
    if host_pos != [f"# of predicted positive: {res_fs.positives}"]:
        raise AssertionError(f"predicted positives differ: {host_pos} vs "
                             f"{res_fs.positives}")
    with open(port_fo + "0", "rb") as f, open(host_fo + "0", "rb") as g:
        port_bytes = f.read()
        if port_bytes != g.read():
            raise AssertionError("fastcar <output>0 differs from the JAX host run")
    fc_lines = port_bytes.count(b"\n")
    host_s = host_st["after loop"] - host_st["before loop"]
    port_s = res_fs.search_seconds
    phase("fc", f"fastcar all-vs-all --recover search, 10k: {fst.pairs} window "
                f"pairs in {fst.blocks} block, {res_fs.positives} predicted "
                f"positive, <output>0 == JAX host run byte for byte "
                f"({fc_lines} lines); search window (before "
                f"loop to after loop): port --device cuda {port_s:.3f} s = "
                f"{fst.pairs / port_s:.1f} pairs/s, JAX host route "
                f"{host_s:.3f} s = {fst.pairs / host_s:.1f} pairs/s; host "
                f"re-checks {fst.rechecked_c} classifier, {fst.rechecked_r} "
                f"regression; launches {launches['fastcar']}; peak device memory "
                f"{peak_gb:.3f} GB allocated (the largest slice's inputs kept "
                f"for the check below included); {card}, host {os.cpu_count()} "
                f"cores")
    in_search = fst.pairs_seconds + fst.score_seconds + fst.write_seconds
    phase("fc", f"search window split (s): port: reading and counting the chunks "
                f"{port_s - in_search:.3f}, window pairs {fst.pairs_seconds:.3f}, "
                f"scoring on the card with host re-checks {fst.score_seconds:.3f}, "
                f"output lines {fst.write_seconds:.3f}; JAX host route: reading and "
                f"counting {host_s - host_st['search seconds']:.3f}, search "
                f"{host_st['search seconds']:.3f} of it native scoring "
                f"{host_st['score seconds']:.3f}")

    st_f, prm_f, a_f, b_f = fc_slices[-1]
    stats_k, dec_k = pair_stats_decision(st_f, prm_f, a_f, b_f)
    torch.cuda.synchronize()
    stats_p, dec_p = pair_stats_decision_ref(st_f, prm_f, a_f, b_f)
    if not (torch.equal(stats_k, stats_p)
            and all(same_f64(dec_k[r], dec_p[r]) for r in range(3))):
        raise AssertionError("pair_stats_decision differs at the search slice")
    fin = torch.isfinite(dec_p)
    fc_err = max(float((stats_k - stats_p).abs().max()),
                 float((dec_k[fin] - dec_p[fin]).abs().max()))
    del stats_k, dec_k, stats_p, dec_p, fin
    fc_ms = cuda_ms(lambda: pair_stats_decision(st_f, prm_f, a_f, b_f), reps=10)
    fc_plain_ms = cuda_ms(lambda: pair_stats_decision_ref(st_f, prm_f, a_f, b_f),
                          reps=3, warm=1)
    fc_dev_us = device_us(lambda: pair_stats_decision(st_f, prm_f, a_f, b_f),
                          reps=10)
    fc_ns, fc_nc = len(prm_f.singles), len(prm_f.combos)
    fc_bound, fc_by = decision_bound(st_f.counts, a_f, b_f, fc_ns, fc_nc)
    phase("fc", f"pair_stats_decision at the search's largest slice, P={len(a_f)} "
                f"pairs, N={len(st_f.counts)} D={st_f.counts.shape[1]} "
                f"{st_f.counts.dtype}, the fastcar classifier ({fc_ns} singles, "
                f"{fc_nc} combos): kernel == plain bit for bit; kernel "
                f"{fc_ms:.4f} ms, plain {fc_plain_ms:.4f} ms (median, CUDA "
                f"events), device {fc_dev_us:.2f} us (CUDA events behind a "
                f"busy wait), bound {fc_bound:.4f} ms ({fc_by}); {card}")
    fc_pairs = len(a_f)
    del fc_slices, st_f, prm_f, a_f, b_f
    return {
        "name": "pair_stats_decision",
        "path": "fastcar search",
        "route": "cuda",
        "source": "meshclust2_tpu_torch/csrc/pair_stats.cu",
        "replaces": "meshclust2_tpu/ops/pallas_stats.py:39, "
                    "meshclust2_tpu/cluster/device_update.py:159",
        "launches": launches["fastcar"]["pair_stats_decision"],
        "max_abs_err": fc_err,
        "ms": fc_ms,
        "plain_ms": fc_plain_ms,
        "bound_ms": fc_bound,
        "bound_by": fc_by,
        "library_ms": None,
        "device_us": fc_dev_us,
        "pairs": fc_pairs,
    }


def row_blocks(store, G: int):
    """G RowBlocks of a DeviceStore's rows (mesh.py:block_bounds), every
    block with the whole store's moments, as the ranks of a row-sharded
    store hold them."""
    from meshclust2_tpu_torch.ops.closest_mean import RowBlock
    from meshclust2_tpu_torch.parallel.mesh import block_bounds

    n = store.counts.shape[0]
    out = []
    for g in range(G):
        lo, hi, _ = block_bounds(n, G, g)
        out.append(RowBlock(store.counts[lo:hi].contiguous(), store.mags, store.selfdot,
                            store.lens, store.stddevs, store.maxc, lo, hi))
    return out


def step_block_run(blocks, args, kw, fresh, step) -> dict:
    """The step's block mode over G = len(blocks) row blocks in this process,
    phase by phase through `step` (window_step_block or a plain stand-in of
    its signature): each block's exchange from its own candidates, the
    exchanges summed (the all-reduce), each block's phase 2 on its own state
    copy, the partials stacked (the all-gather), each block's phase 3.
    Returns every intermediate: the blocks' exchanges, the sum, the states,
    partials and trips after phase 2, the trips after phase 3."""
    import torch
    from meshclust2_tpu_torch.ops.closest_mean import PART
    from meshclust2_tpu_torch.ops.window_absorb import (own_candidates, step_scratch,
                                                        step_xbuf_len)

    G = len(blocks)
    store, order, cand, s, dist, stats, _, cur_d = args
    kw = dict(kw)
    dec = torch.stack([s, torch.zeros_like(s), dist, kw.pop("s_err"), kw.pop("dist_err")])
    dev, n, d = s.device, len(order), store.counts.shape[1]
    L = step_xbuf_len(len(cand), d, store.counts.element_size(), G)
    states = [fresh(args)[6] for _ in blocks]
    curs = [cur_d.clone() for _ in blocks]
    scratches = [step_scratch(n, dev) for _ in blocks]
    xbufs = [torch.zeros(L, dtype=torch.int64, device=dev) for _ in blocks]
    rank_parts = [torch.zeros(PART, dtype=torch.int64, device=dev) for _ in blocks]
    out = {"x": [], "state2": [], "part": [], "trip2": []}
    for g, blk in enumerate(blocks):
        pos, rows, st, dc = own_candidates(blk, order, cand, stats, dec)
        step(1, blk, order, cand, states[g], curs[g], scratch=scratches[g], xbuf=xbufs[g],
             rank=g, n_ranks=G, own_pos=pos, own_rows=rows, own_stats=st, own_dec=dc, **kw)
        out["x"].append(xbufs[g].clone())
    total = torch.stack(xbufs).sum(dim=0)
    out["sum"] = total
    for g, blk in enumerate(blocks):
        trip = step(2, blk, order, cand, states[g], curs[g], scratch=scratches[g],
                    xbuf=total, rank=g, n_ranks=G, rank_part=rank_parts[g], **kw)
        out["state2"].append([t.clone() for t in states[g]])
        out["part"].append(rank_parts[g].clone())
        out["trip2"].append(trip.clone())
    parts = torch.stack(rank_parts)
    out["trip"] = [step(3, blk, order, cand, states[g], curs[g], scratch=scratches[g],
                        rank=g, n_ranks=G, parts=parts, **kw).clone()
                   for g, blk in enumerate(blocks)]
    out["state"] = states
    return out


def plain_step_block(phase_, blk, order, cand, state, cur_d, *, scratch, own_pos=None,
                     own_rows=None, own_stats=None, own_dec=None, **kw):
    """window_step_block's signature over its plain version, on any device."""
    from meshclust2_tpu_torch.ops.window_absorb import window_step_block_ref

    window_step_block_ref(phase_, blk, order, cand, state, cur_d, trip=scratch[:4],
                          own=(own_pos, own_rows, own_stats, own_dec), **kw)
    return scratch[:4]


def step_block_checks(case, counts, moments, scratch, dev, card: str, tie: int) -> dict:
    """(m4) the step kernel's block mode at a 10k accumulate shape, G = 4 and
    G = 1 row blocks in this process (step_block_run): every phase's kernel
    against its plain version on the same inputs (each block's exchange,
    the summed exchange, each block's state, trip and partial after phase 2,
    each trip after phase 3), and the trips and states against the one-block
    kernel and the plain one-launch step, bit for bit, under the tie
    guard's keys `tie`, on the case and on the case with an exact dist tie
    that shares those keys (step_inputs' key_tie).  Timed: the fused
    phase 2 alone (one rank of 4), and the sequence of 4 ranks in this
    process beside its plain version and the bound of the work of the 4
    ranks' phases (the step's bytes once, each rank's exchange written and
    the sum read by each, the partials)."""
    import torch
    from meshclust2_tpu_torch.ops.closest_mean import PART
    from meshclust2_tpu_torch.ops.window_absorb import (
        StepState, seed_slot, step_xbuf_len, window_step, window_step_block,
        window_step_ref)

    runs = {}
    for key_tie in (tie, 0):   # the plain case last: it is timed
        args, kw = step_inputs(case, counts, moments, dev, tie, key_tie=key_tie)
        one, plain = fresh(args), fresh(args)
        trip = window_step(*one, **kw, scratch=scratch).clone()
        want = window_step_ref(*plain, **kw)
        torch.cuda.synchronize()
        if not torch.equal(trip, want) or trip.tolist()[:2] != [0, 15]:
            raise AssertionError(f"the one-block step {trip} != plain {want}, or no absorb of 15")
        for G in (4, 1):
            blocks = row_blocks(args[0], G)
            got = step_block_run(blocks, args, kw, fresh, window_step_block)
            ref = step_block_run(blocks, args, kw, fresh, plain_step_block)
            torch.cuda.synchronize()
            for key in ("x", "part", "trip2", "trip"):
                for g, (a, b) in enumerate(zip(got[key], ref[key])):
                    if not torch.equal(a, b):
                        raise AssertionError(f"step block mode, G = {G}, block {g}: {key} of "
                                             f"the kernel != its plain version")
            if not torch.equal(got["sum"], ref["sum"]):
                raise AssertionError(f"step block mode, G = {G}: the summed exchanges differ")
            for g in range(G):
                for name, a, b, c, e in zip(StepState._fields, got["state2"][g],
                                            ref["state2"][g], one[6], plain[6]):
                    k = slice(0, -1) if name == "members" else slice(None)
                    if not (torch.equal(a[k], b[k]) and torch.equal(a[k], c[k])
                            and torch.equal(a[k], e[k])):
                        raise AssertionError(f"step block mode, G = {G}, block {g}: {name} "
                                             f"differs from the plain version's or the "
                                             f"one-block kernel's")
                if not (torch.equal(got["trip"][g], trip) and torch.equal(got["trip"][g], want)):
                    raise AssertionError(f"step block mode, G = {G}, block {g}: trip "
                                         f"{got['trip'][g]} != {trip}")
            runs[G] = got
    # timing: the 4 ranks' sequence in this process, and phase 2 alone
    G = 4
    blocks = row_blocks(args[0], G)
    store, order, cand, s, dist, stats, _, cur_d = args
    from meshclust2_tpu_torch.ops.window_absorb import own_candidates, step_scratch
    kw2 = dict(kw)
    dec = torch.stack([s, torch.zeros_like(s), dist, kw2.pop("s_err"), kw2.pop("dist_err")])
    n, d = len(order), store.counts.shape[1]
    L = step_xbuf_len(len(cand), d, store.counts.element_size(), G)
    runs_state = [fresh(args)[6] for _ in blocks]
    saved = [StepState(*(t.clone() for t in st)) for st in runs_state]
    owns = [own_candidates(blk, order, cand, stats, dec) for blk in blocks]
    scr = [step_scratch(n, dev) for _ in blocks]
    xs = [torch.zeros(L, dtype=torch.int64, device=dev) for _ in blocks]
    rps = [torch.zeros(PART, dtype=torch.int64, device=dev) for _ in blocks]
    curs = [cur_d.clone() for _ in blocks]
    total = [None]

    def restore():
        for st, st0 in zip(runs_state, saved):
            for t, t0 in zip(st, st0):
                t.copy_(t0)

    def seq(step):
        for g, blk in enumerate(blocks):
            pos, rows, st, dc = owns[g]
            step(1, blk, order, cand, runs_state[g], curs[g], scratch=scr[g], xbuf=xs[g],
                 rank=g, n_ranks=G, own_pos=pos, own_rows=rows, own_stats=st, own_dec=dc,
                 **kw2)
        total[0] = torch.stack(xs).sum(dim=0)
        for g, blk in enumerate(blocks):
            step(2, blk, order, cand, runs_state[g], curs[g], scratch=scr[g],
                 xbuf=total[0], rank=g, n_ranks=G, rank_part=rps[g], **kw2)
        parts = torch.stack(rps)
        for g, blk in enumerate(blocks):
            step(3, blk, order, cand, runs_state[g], curs[g], scratch=scr[g], rank=g,
                 n_ranks=G, parts=parts, **kw2)

    kernel = lambda: seq(window_step_block)
    # the busy wait outlasts the ~30 launches the host queues (~10 ms)
    rec = dict(ms=cuda_ms(kernel, reps=50, setup=restore),
               plain_ms=cuda_ms(lambda: seq(plain_step_block), reps=5, setup=restore),
               device_us=device_us(kernel, setup=restore, sleep=20_000_000))
    restore()
    kernel()   # total[0]: the summed exchange of this step
    fused = lambda: window_step_block(2, blocks[0], order, cand, runs_state[0], curs[0],
                                      scratch=scr[0], xbuf=total[0], rank=0, n_ranks=G,
                                      rank_part=rps[0], **kw2)
    rec["phase2_device_us"] = device_us(fused, setup=restore)
    rec["exchange_bytes"] = 8 * L
    w, mcnt = len(cand), kw["mcnt"]
    nbytes, ops = step_bound_terms(w, 15, mcnt + 15, d, 1)
    # the 4 ranks' exchanges written and their sum read by each, the partials
    nbytes += 2 * G * 8 * L + 2 * G * 8 * PART
    rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, ops)
    rec["max_abs_err"] = 0
    phase("m4", f"window_step block mode, W={w}, 15 positive, {mcnt} + 15 members, D={d} "
                f"uint8, pool {n}: G = 4 and G = 1 row blocks (the exchanges summed and "
                f"the partials stacked as the collectives combine them), under the 10k "
                f"model's tie keys {tie}, as drawn and with an exact dist tie that shares "
                f"them: each phase == its plain version (exchanges, states, partials, trips), trip and state == "
                f"the one-block kernel == plain, bit for bit; exchange {rec['exchange_bytes']}"
                f" bytes a rank (int64: statistics, decisions, column sums, {G} seed slots "
                f"of {seed_slot(d, 1)} words); the 4 ranks' sequence in this process: "
                f"kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms (median, CUDA "
                f"events), device {rec['device_us']:.2f} us (CUDA events behind a busy "
                f"wait), bound {rec['bound_ms']:.6f} ms ({rec['bound_by']}); the fused "
                f"phase 2, one rank: device {rec['phase2_device_us']:.2f} us; the "
                f"one-launch kernel at this shape: (d3); {card}")
    return rec


def candidates_block_run(blocks, keep, unc, st, rows, delta, lay, C, n_pairs, tie_margin,
                         block_fn) -> dict:
    """closest_candidates' block mode over G = len(blocks) row blocks in this
    process through `block_fn` (closest_candidates_block or a plain
    stand-in of its signature): each block's exchange from the filter's bits
    of its own pairs, the sum (the all-reduce), each block's partials, the
    stack (the all-gather), each block's phase 3.  Returns every
    intermediate."""
    import torch
    from meshclust2_tpu_torch.ops import phase as P
    from meshclust2_tpu_torch.ops.closest_mean import PART

    G, dev = len(blocks), st.cen.device
    d, S = blocks[0].counts.shape[1], len(st.cen)
    dtype = P.exchange_dtype(n_pairs, blocks[0].maxc)
    L = P.exchange_words(n_pairs, C, d)
    outs = [P.new_candidates(S, delta, dev) for _ in blocks]
    xs = [torch.zeros(L, dtype=dtype, device=dev) for _ in blocks]
    rps = [torch.zeros((C, PART), dtype=torch.int64, device=dev) for _ in blocks]
    args = (st, rows, delta, lay, C, n_pairs)
    kw = dict(tie_margin=tie_margin)
    b = lay.b_rows[:n_pairs]
    for g, blk in enumerate(blocks):
        cs, k, u = P.own_pairs(blk, b, keep, unc)
        block_fn(1, blk, *args, outs[g], xbuf=xs[g], own_cs=cs, own_keep=k, own_unc=u, **kw)
    total = torch.stack(xs).sum(dim=0, dtype=dtype)
    for g, blk in enumerate(blocks):
        block_fn(2, blk, *args, outs[g], xbuf=total, rank_part=rps[g], **kw)
    parts = torch.stack(rps)
    got = [block_fn(3, blk, *args, outs[g], parts=parts, **kw) for g, blk in enumerate(blocks)]
    return dict(x=xs, sum=total, part=rps, first=[f for f, _ in got], unc=[u for _, u in got],
                out=outs)


def plain_candidates_block(phase_, blk, st, rows, delta, lay, C, n_pairs, out, *, tie_margin,
                           final=False, xbuf=None, own_cs=None, own_keep=None, own_unc=None,
                           rank_part=None, parts=None):
    """closest_candidates_block's signature over its plain versions, on any
    device."""
    from meshclust2_tpu_torch.ops import phase as P

    b, sg = lay.b_rows[:n_pairs], lay.seg[:n_pairs]
    if phase_ == 1:
        P.candidates_exchange_ref(blk, b, sg, C, own_cs, own_keep, own_unc, xbuf)
        return None
    if phase_ == 2:
        rank_part[:C] = P.candidates_partials_ref(blk, b, sg, C, xbuf)
        return None
    first, unc = P.pick_ref(parts, n_pairs, tie_margin)
    P.phase_candidates_ref(st, rows, delta, lay, first, C, n_pairs, out, final)
    return first, unc


def candidates_block_checks(store, keep, st, rows, delta, lay, C, n_pairs, cand, first,
                            unc, tie_margin: float, card: str) -> dict:
    """(m4) closest_candidates' block mode on the 10k phase state of (d6),
    G = 4 and G = 1 row blocks (candidates_block_run, the filter's
    uncertainty bits on every seventh pair): every phase's kernel against
    its plain version (each block's exchange, the sum, each block's
    partials, first, unc and the candidates) and first, unc and the
    candidates against the one-block kernel (which (d6) holds against the
    plain version), bit for bit.  Timed: the 4 ranks' sequence in this
    process beside its plain version and the bound of their work (the
    one-block kernel's bytes, each rank's exchange written and the sum read
    by each, in the exchange's word: int32 where the sums fit; the
    partials)."""
    import torch
    from kernel_ab import phase_bytes
    from meshclust2_tpu_torch.ops import phase as P
    from meshclust2_tpu_torch.ops.closest_mean import PART

    dev = st.cen.device
    S, d, m = len(st.cen), store.counts.shape[1], delta * C
    func = torch.arange(n_pairs, device=dev) % 7 == 3
    for G in (4, 1):
        blocks = row_blocks(store, G)
        got = candidates_block_run(blocks, keep, func, st, rows, delta, lay, C, n_pairs,
                                   tie_margin, P.closest_candidates_block)
        ref = candidates_block_run(blocks, keep, func, st, rows, delta, lay, C, n_pairs,
                                   tie_margin, plain_candidates_block)
        torch.cuda.synchronize()
        same = torch.equal(got["sum"], ref["sum"])
        for key in ("x", "part", "first", "unc"):
            same &= all(torch.equal(a, b) for a, b in zip(got[key], ref[key]))
        for g, out in enumerate(got["out"]):
            same &= (torch.equal(got["first"][g], first) and torch.equal(got["unc"][g], unc)
                     and torch.equal(out.cen, cand.cen) and not out.arrive.any()
                     and torch.equal(out.cen, ref["out"][g].cen))
            for fld in ("a", "b", "seg", "ok"):
                same &= torch.equal(getattr(out, fld)[:m], getattr(cand, fld)[:m])
        if not same:
            raise AssertionError(f"closest_candidates block mode, G = {G}: a phase differs "
                                 f"from its plain version or the one-block kernel")
    G = 4
    blocks = row_blocks(store, G)
    dtype = P.exchange_dtype(n_pairs, store.maxc)
    L = P.exchange_words(n_pairs, C, d)
    b = lay.b_rows[:n_pairs]
    owns = [P.own_pairs(blk, b, keep, func) for blk in blocks]
    xs = [torch.zeros(L, dtype=dtype, device=dev) for _ in blocks]
    rps = [torch.zeros((C, PART), dtype=torch.int64, device=dev) for _ in blocks]
    outs = [P.new_candidates(S, delta, dev) for _ in blocks]
    args = (st, rows, delta, lay, C, n_pairs)
    nw = -(-n_pairs // 32)

    def seq(fn):
        for g, blk in enumerate(blocks):
            cs, k, u = owns[g]
            fn(1, blk, *args, outs[g], xbuf=xs[g], own_cs=cs, own_keep=k, own_unc=u,
               tie_margin=tie_margin)
        total = torch.stack(xs).sum(dim=0, dtype=dtype)
        total[nw:2 * nw].any()   # the filter's uncertainty
        for g, blk in enumerate(blocks):
            fn(2, blk, *args, outs[g], xbuf=total, rank_part=rps[g], tie_margin=tie_margin)
        parts = torch.stack(rps)
        for g, blk in enumerate(blocks):
            fn(3, blk, *args, outs[g], parts=parts, tie_margin=tie_margin)

    kernel = lambda: seq(P.closest_candidates_block)
    rec = dict(ms=cuda_ms(kernel, reps=50), plain_ms=cuda_ms(
        lambda: seq(plain_candidates_block), reps=3),
        device_us=device_us(kernel, sleep=20_000_000))
    esize = torch.zeros(0, dtype=dtype).element_size()
    rec["exchange_bytes"] = L * esize
    rec["exchange_dtype"] = str(dtype).replace("torch.", "")
    kept = b[keep]
    nbytes = (phase_bytes(len(st.assign), S, C, n_pairs, delta)["closest_candidates"]
              + torch_unique(kept) * (d * store.counts.element_size() + 8)
              + tbytes(b, lay.seg[:n_pairs]) + 10 * n_pairs + 9 * C
              + 2 * G * rec["exchange_bytes"] + 2 * G * 8 * C * PART)
    rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, CLOSEST_OPS * len(kept) * d + 2 * d)
    rec["max_abs_err"] = 0
    phase("m4", f"closest_candidates block mode at the 10k state after accumulate "
                f"(S = {S}, C = {C}, P = {n_pairs}, {len(kept)} kept): G = 4 and G = 1 row "
                f"blocks: each phase == its plain version (exchanges, partials, first, unc, "
                f"candidates), first, unc and the candidates == the one-block kernel, bit "
                f"for bit; exchange {rec['exchange_bytes']} bytes a rank "
                f"({rec['exchange_dtype']}: keep and uncertainty bits, column sums; with int64 "
                f"sums and uint8 bits it would be {8 * C * d + 2 * n_pairs}); the 4 ranks' "
                f"sequence in this process: kernel {rec['ms']:.4f} ms, plain "
                f"{rec['plain_ms']:.4f} ms (median, CUDA events), device "
                f"{rec['device_us']:.2f} us (CUDA events behind a busy wait), bound "
                f"{rec['bound_ms']:.6f} ms ({rec['bound_by']}, {nbytes} bytes); {card}")
    return rec


def multihost_session_phase(torch_cli, wrappers, launches, weights, fasta, tmp, ref_sig,
                            path_stamps, per_window_stamps, card: str) -> dict:
    """(m3) --multihost's default route on the 10k set, a one-rank NCCL
    group: the device session over the row-sharded store gives the
    reference signature with the default path's counters, accumulator and
    phase counters, and launches what the default path launches (counted
    from zero): its step kernel and closest_candidates as often, no
    block-mode phase, pair_stats_decision as often but for the warm-ups;
    its window beside the default path's (f) and the per-window route's
    (m)."""
    out_m = os.path.join(tmp, "bench10k_multihost_session.clstr")
    for fn in wrappers.values():
        fn.launches = 0
    res = torch_cli.run(["--multihost", "--device", "cuda", "--recover", weights,
                         "--output", out_m, fasta])
    launches["multihost_session"] = {k: fn.launches for k, fn in wrappers.items()}
    if res.rc != 0:
        raise AssertionError(f"--multihost (the session) exited {res.rc}")
    check_launches("multihost_session", launches["multihost_session"])
    got = read_clstr(out_m)
    if len(got) != BENCH10K_CLUSTERS or signature(got) != ref_sig:
        raise AssertionError(f"--multihost session: 10k signature differs ({len(got)} "
                             f"clusters)")
    if counters(res) != BENCH10K_COUNTERS["default"]:
        raise AssertionError(f"--multihost session counters {counters(res)} != "
                             f"{BENCH10K_COUNTERS['default']}")
    acc, ph = res.accumulator, res.phase
    got_acc = (acc.total_steps, acc.last_windows, acc.last_pairs, acc.aborts)
    got_ph = (ph.last_iterations, ph.scored_pairs, ph.last_abort)
    want_ph = (BENCH10K_COUNTERS["default"][3], BENCH10K_UPDATER_PAIRS, 0)
    if got_acc != BENCH10K_ACC + (0,) or got_ph != want_ph:
        raise AssertionError(f"--multihost session: accumulator {got_acc}, phase {got_ph}")
    counted = launches["multihost_session"]
    default = launches["default"]
    diff = {k: counted[k] - default[k] for k in SAME_LAUNCHES if counted[k] != default[k]}
    psd = counted["pair_stats_decision"] - default["pair_stats_decision"]
    if diff or abs(psd) > WARM_UP_DIFF:
        raise AssertionError(f"--multihost session: launches {counted} != the default "
                             f"path's {default} (differences {diff}, pair_stats_decision "
                             f"{psd})")
    if hasattr(acc, "block_steps") or hasattr(ph, "block_passes"):
        raise AssertionError(f"--multihost session on one rank: {type(acc).__name__} and "
                             f"{type(ph).__name__}, not the single-device step and phase")
    phase("m3", f"bench 10k --multihost, the device session over the row-sharded store "
                f"(one-rank NCCL group, world {res.scorer.mesh.world}): signature == "
                f"bench10k_ref_t1 ({len(got)} clusters), counters {counters(res)} (the "
                f"default path's), accumulator {got_acc[0]} steps / {got_acc[1]} windows / "
                f"{got_acc[2]} pairs / {got_acc[3]} aborts, phase {got_ph[0]} iterations / "
                f"{got_ph[1]} pairs / abort {got_ph[2]}; launches window_absorb "
                f"{counted['window_absorb']}, closest_candidates "
                f"{counted['closest_candidates']}, phase_layout {counted['phase_layout']}, "
                f"merge_replay {counted['merge_replay']} (the default path's to the "
                f"launch), window_absorb_block {counted['window_absorb_block']}, "
                f"closest_candidates_block {counted['closest_candidates_block']}, "
                f"pair_stats_decision {counted['pair_stats_decision']} (the default "
                f"path's {default['pair_stats_decision']}: {psd:+d} in the warm-ups); "
                f"{window_parts(res.clock.stamps, 10_000)}; the default path (f): "
                f"{window_parts(path_stamps['default'], 10_000)}; per-window (m): "
                f"{window_parts(per_window_stamps, 10_000)}; {card}")
    return dict(res.clock.stamps)


def graft_entry_phase(dev, card: str) -> None:
    """(m5) the port's graft_entry on the card: entry()'s forward (the
    fused kernel's center form, the float32 epilogue beside it) against
    its CPU run, and dryrun_multichip(1) as a one-rank NCCL group (its
    seven sections, a process of its own)."""
    import torch
    from meshclust2_tpu_torch.graft_entry import dryrun_multichip, entry

    forward, example = entry()
    got = [t.cpu() for t in forward(*example)]
    cpu_forward, cpu_example = entry("cpu")
    want = cpu_forward(*cpu_example)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError("entry()'s fused decisions on the card differ from the CPU's")
    err32 = max(float((g - w).abs().max()) for g, w in zip(got[2:], want[2:]))
    if not all(bool(torch.isfinite(t).all()) for t in got) or err32 > 1e-4:
        raise AssertionError(f"entry()'s float32 epilogue: not finite or off by {err32}")
    t0 = time.perf_counter()
    dryrun_multichip(1)
    secs = time.perf_counter() - t0
    phase("m5", f"graft_entry: entry()'s forward on {dev} ({len(got[0])} candidates "
                f"against one center): the fused kernel's prob and dist == its CPU run bit "
                f"for bit, the float32 epilogue within {err32:.3g} of the CPU's; "
                f"dryrun_multichip(1), a one-rank NCCL group, its seven sections passed "
                f"in {secs:.1f} s; {card}")


def shared_card_phase(tmp: str, card: str) -> dict:
    """(m6) --multihost with two processes on the one card: NCCL refuses two
    ranks on one device, so they form a gloo group over CUDA tensors
    (parallel/mesh.py:backend_for); the device session on med2000 gives the
    sorted reference CLSTR, and both ranks the default path's counters and
    the same clustering digest, through the block modes: every scan step
    with candidates and every pass of the phase on each rank, 2 collectives
    a step and 3 a pass, three launches each.  Returns rank 0's block-mode
    launches."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    out = os.path.join(tmp, "med2000_shared_card.clstr")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "meshclust2_tpu_torch.cli", "--multihost", "--device", "cuda",
         "--recover", os.path.join(FIX, "med2000_weights.txt"), "--output", out,
         os.path.join(FIX, "med2000.fasta")],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONPATH=ROOT, MC2_NPROCS="2", MC2_PROC_ID=str(i),
                 MC2_COORD=f"localhost:{port}", MC2_DEVICE_PROF="1"))
        for i in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    ranks = []
    for p, log in zip(procs, logs):
        m = re.search(r"multihost rank (\d) of 2: windows (\d+), pairs (\d+), clusters "
                      r"(\d+) -> \d+, iterations (\d+), .*output (\w+), accumulator steps "
                      r"(\d+), windows (\d+), pairs (\d+), aborts (\d+); phase iterations "
                      r"(\d+), pairs (\d+), abort (\d+)", log)
        if p.returncode != 0 or m is None:
            raise AssertionError(f"--multihost on a shared card: rank exited "
                                 f"{p.returncode}:\n{log[-3000:]}")
        b = re.search(r"block mode: steps (\d+), collectives a step \{([^}]*)\}, passes "
                      r"(\d+), collectives a pass \{([^}]*)\}, launches window_absorb_block "
                      r"(\d+), closest_candidates_block (\d+)", log)
        if b is None:
            raise AssertionError(f"--multihost on a shared card: no block-mode line:\n"
                                 f"{log[-3000:]}")
        steps, passes, wl, cl = (int(b.group(i)) for i in (1, 3, 5, 6))
        if (steps != int(m.group(8)) or passes == 0 or b.group(2) != f"2: {steps}"
                or b.group(4) != f"3: {passes}" or wl < 3 * steps or cl < 3 * passes):
            raise AssertionError(f"--multihost on a shared card: rank {m.group(1)} block "
                                 f"mode {b.group(0)} (windows {m.group(8)})")
        ranks.append(m.groups() + (steps, passes, wl, cl))
    if sorted(open(out).read().splitlines()) != sorted(
            open(os.path.join(FIX, "med2000_ref.clstr")).read().splitlines()):
        raise AssertionError("--multihost on a shared card: med2000 CLSTR != med2000_ref")
    want = tuple(str(v) for v in MED2000_COUNTERS["default"] + MED2000_ACC
                 + (0, MED2000_COUNTERS["default"][3], MED2000_UPDATER_PAIRS, 0))
    for r in ranks:
        got = r[1:5] + r[6:13]
        if got != want or r[5] != ranks[0][5]:
            raise AssertionError(f"--multihost on a shared card: rank {r[0]} counters "
                                 f"{got} != {want}, or digests differ")
    stamps = dict(re.findall(r"timestamp (\w+) ([\d.]+)", logs[0]))
    win = float(stamps["done"]) - float(stamps["read_in_points"])
    phase("m6", f"--multihost, 2 processes on the one card (a gloo group over CUDA "
                f"tensors; NCCL refuses two ranks on one device): med2000 through the "
                f"device session, sorted CLSTR == med2000_ref, both ranks' counters the "
                f"default path's {MED2000_COUNTERS['default']}, accumulator "
                f"{MED2000_ACC}, phase {MED2000_COUNTERS['default'][3]} iterations / "
                f"{MED2000_UPDATER_PAIRS} pairs, the same digest; block modes on each "
                f"rank: {ranks[0][13]} steps with 2 collectives each, {ranks[0][14]} passes "
                f"with 3 each; launches window_absorb_block {ranks[0][15]}, "
                f"closest_candidates_block {ranks[0][16]} (rank 0, the warm-ups "
                f"included); rank 0's window {win:.3f} s; {card}")
    return {"window_absorb_block": ranks[0][15], "closest_candidates_block": ranks[0][16]}


# Red as a program of its own: the package's red/cli.py main, its stage
# lines stamped on the process clock, then whether the native library
# loaded
RED_TIMED = """
import importlib, sys, time
cli = importlib.import_module(sys.argv[1] + ".red.cli")
native = importlib.import_module(sys.argv[1] + ".native")
t0 = time.perf_counter()
def stamped(*args, **kw):
    print(*args, **kw)
    if args and str(args[0]).startswith("Stage"):
        print(f"stamp {str(args[0])[:7]} {time.perf_counter() - t0!r}", flush=True)
cli.print = stamped
rc = cli.main(sys.argv[2:])
print(f"stamp done {time.perf_counter() - t0!r}", flush=True)
print(f"native {native._get_lib() is not None}", flush=True)
sys.exit(rc)
"""
# its launcher, a small process that runs RED_TIMED as its child and
# prints the child's peak resident set (KiB): the maxrss of a process
# started from this large one would carry over this one's at the exec, and
# the card's machine has no VmHWM in /proc/self/status
RED_LAUNCH = """
import resource, subprocess, sys
rc = subprocess.run([sys.executable, "-c", *sys.argv[1:]]).returncode
print(f"peak_rss_kib {resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss}", flush=True)
sys.exit(rc)
"""
# the yeast-sized synthetic genome of (r): S. cerevisiae's ~12.1 Mbp in 16
# nuclear chromosomes at ~38 % GC, repeats (~6 %) planted as families
RED_GENOME = dict(seed=2024, total_bp=12_100_000, n_records=16, n_files=2,
                  gc=0.38, repeat_share=0.06, n_families=24, max_divergence=0.15,
                  n_runs=3)


def red_run(pkg: str, args, out: str) -> dict:
    """One Red run as a program of its own into `out`: its stdout without
    the stamp lines, its stage times, native, peak RSS and wall seconds."""
    os.makedirs(out)
    flags = [x for flag in ("-rpt", "-msk", "-sco") for x in (flag, out)]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", RED_LAUNCH, RED_TIMED, pkg, *args,
                           *flags], cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{pkg} Red exited {proc.returncode}:\n{proc.stderr[-2000:]}")
    lines = proc.stdout.splitlines()
    info = dict(ln.split(" ", 1) for ln in lines
                if ln.startswith(("native ", "peak_rss_kib ")))
    stamps = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^stamp (.+) (\S+)$", proc.stdout, re.M)}
    return {"stdout": [ln for ln in lines if not ln.startswith(
                ("stamp ", "native ", "peak_rss_kib "))],
            "stamps": stamps, "native": info["native"] == "True",
            "rss_mib": int(info["peak_rss_kib"]) / 1024, "wall": wall, "out": out}


def same_tree(a: str, b: str) -> list:
    """The file names of two output folders, which must hold the same files
    byte for byte."""
    names = sorted(os.listdir(a))
    if not names or names != sorted(os.listdir(b)):
        raise AssertionError(f"Red outputs differ in their files: {names} vs "
                             f"{sorted(os.listdir(b))}")
    for name in names:
        with open(os.path.join(a, name), "rb") as f, open(os.path.join(b, name), "rb") as g:
            if f.read() != g.read():
                raise AssertionError(f"Red output {name} differs between the "
                                     f"packages")
    return names


def red_phase(tmp: str, card: str) -> None:
    """(r) Red, the third program, on the card's machine: host code in both
    packages (numpy and the native library's Red helpers; no device path).
    The port's Red on the fixture genome gives the reference binary's
    .scr/.rpt; on a seeded yeast-sized genome at the default k it writes
    the JAX Red's files byte for byte.  Both run through the native
    library, each as a program of its own."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from red_genome import write_genome

    runs = {}
    for pkg in ("meshclust2_tpu", "meshclust2_tpu_torch"):
        runs[pkg] = red_run(pkg, ["-gnm", os.path.join(FIX, "red_genome"), "-len", "8"],
                            os.path.join(tmp, "red_fixture", pkg))
    port = runs["meshclust2_tpu_torch"]
    for ext in ("scr", "rpt"):
        with open(os.path.join(FIX, f"red_ref_chr1.{ext}"), "rb") as f, \
                open(os.path.join(port["out"], f"chr1.{ext}"), "rb") as g:
            if f.read() != g.read():
                raise AssertionError(f"the port's Red chr1.{ext} differs from "
                                     f"red_ref_chr1.{ext}")
    same_tree(runs["meshclust2_tpu"]["out"], port["out"])
    phase("r", f"Red, tests/fixtures/red_genome -len 8: the port's chr1.scr and "
               f"chr1.rpt == red_ref_chr1 byte for byte, .msk == the JAX Red's")

    t0 = time.perf_counter()
    gdir = os.path.join(tmp, "red_genome_12m")
    files = write_genome(gdir, **RED_GENOME)
    made = time.perf_counter() - t0
    # in turns: JAX, port, port, JAX, every run's files those of the first
    order = ("meshclust2_tpu", "meshclust2_tpu_torch", "meshclust2_tpu_torch",
             "meshclust2_tpu")
    turns = []
    for i, pkg in enumerate(order):
        run = red_run(pkg, ["-gnm", gdir], os.path.join(tmp, "red_12m", f"{i}_{pkg}"))
        if not run["native"]:
            raise AssertionError(f"{pkg}'s native library did not load: its Red "
                                 f"ran the numpy fallbacks")
        if turns and run["stdout"] != turns[0]["stdout"]:
            raise AssertionError(f"Red's printed lines differ: {run['stdout']} vs "
                                 f"{turns[0]['stdout']}")
        names = same_tree(turns[0]["out"] if turns else run["out"], run["out"])
        turns.append(run)
    out = turns[1]["out"]
    rpt = sum(1 for name in names if name.endswith(".rpt")
              for _ in open(os.path.join(out, name)))
    masked = bases = 0
    for name in names:
        if name.endswith(".msk"):
            with open(os.path.join(out, name), "rb") as f:
                seq = b"".join(ln.rstrip(b"\n") for ln in f if not ln.startswith(b">"))
            codes = np.frombuffer(seq, dtype=np.uint8)
            masked += int(((codes >= ord("a")) & (codes <= ord("z"))).sum())
            bases += len(codes)

    def line(run):
        st = run["stamps"]
        keys = ["Stage 1", "Stage 2", "Stage 3", "Stage 4", "done"]
        parts = ", ".join(f"{i + 1}: {st[b] - st[a]:.3f}"
                          for i, (a, b) in enumerate(zip(keys, keys[1:])))
        return (f"{st['done']:.3f} s in main (stages {parts}), process wall "
                f"{run['wall']:.3f} s, peak RSS {run['rss_mib']:.1f} MiB")

    size = sum(os.path.getsize(f) for f in files)
    phase("r", f"Red, a seeded yeast-sized genome ({RED_GENOME['total_bp']:,} bp, "
               f"{RED_GENOME['n_records']} records in {len(files)} files, {size:,} "
               f"bytes, made in {made:.3f} s), default k, -rpt -msk -sco: {names} "
               f"byte for byte the JAX Red's in all four runs ({rpt} repeat regions, "
               f"{100 * masked / bases:.2f} % of the bases masked); "
               f"{turns[0]['stdout'][0]!r}")
    mean = {pkg: statistics.mean(r["stamps"]["done"] for r, q in zip(turns, order)
                                 if q == pkg) for pkg in order}
    phase("r", f"Red times in turns (host time on the machine of the card, {card}; "
               f"{os.cpu_count()} cores): "
               + "; ".join(f"{'port' if q.endswith('torch') else 'JAX'} {line(r)}"
                           for r, q in zip(turns, order))
               + f"; mean in main: port {mean['meshclust2_tpu_torch']:.3f} s, JAX "
                 f"{mean['meshclust2_tpu']:.3f} s, port / JAX "
                 f"{mean['meshclust2_tpu_torch'] / mean['meshclust2_tpu']:.3f}")


def profile_flag_phase(torch_cli, wrappers, launches, weights, fasta, tmp, ref_sig,
                       plain_stamps, card: str) -> None:
    """(r2) the CLI's --profile DIR on the 10k default path on the card:
    CUDA kernel events under the port's kernel names in the Chrome trace,
    the reference signature and the default path's counters and launches,
    and the clustering window beside the unprofiled run's (f)."""
    prof_dir = os.path.join(tmp, "profile")
    out = os.path.join(tmp, "bench10k_profile.clstr")
    for fn in wrappers.values():
        fn.launches = 0
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        res = torch_cli.run(["--profile", prof_dir, "--device", "cuda", "--recover",
                             weights, "--output", out, fasta])
    wall = time.perf_counter() - t0
    launches["profile"] = {k: fn.launches for k, fn in wrappers.items()}
    if res.rc != 0:
        raise AssertionError(f"--profile run exited {res.rc}")
    check_launches("default", launches["profile"])
    closing = printed.getvalue().splitlines()[-1]
    if closing != f"profile trace written to {prof_dir}":
        raise AssertionError(f"--profile's last line is {closing!r}")
    got = read_clstr(out)
    if signature(got) != ref_sig:
        raise AssertionError("10k signature differs under --profile")
    aborted = res.accumulator is not None and res.accumulator.aborts
    if not aborted and counters(res) != BENCH10K_COUNTERS["default"]:
        raise AssertionError(f"--profile counters {counters(res)} != "
                             f"{BENCH10K_COUNTERS['default']}")
    traces = [os.path.join(prof_dir, n) for n in os.listdir(prof_dir)
              if n.endswith(".pt.trace.json")]
    if len(traces) != 1:
        raise AssertionError(f"--profile wrote {traces}")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = Counter(e["name"] for e in events if e.get("cat") == "kernel")
    by_kernel = {k: sum(n for name, n in kernels.items() if k in name)
                 for k in ("pair_stats_kernel", "window_step_kernel", "layout_kernel",
                           "replay_kernel", "window_select_kernel")}
    missing = [k for k, n in by_kernel.items() if n == 0]
    if missing:
        raise AssertionError(f"--profile's trace holds no CUDA events of {missing}; "
                             f"its kernels: {kernels.most_common(8)}")
    phase("r2", f"--profile on the 10k default path (--device cuda): signature == "
                f"bench10k_ref_t1 ({len(got)} clusters), counters {counters(res)}, "
                f"launches {launches['profile']}; the trace "
                f"({os.path.getsize(traces[0]):,} bytes, {len(events)} events, "
                f"{sum(kernels.values())} CUDA kernel events) holds {by_kernel}; "
                f"{window_parts(res.clock.stamps, 10_000)} with the profiler, "
                f"{window_parts(plain_stamps, 10_000)} without it (f); set-up "
                f"{res.clock.stamps['read_in_points']:.3f} s against "
                f"{plain_stamps['read_in_points']:.3f} s; the run with the trace's "
                f"export {wall:.3f} s; {card}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--setup-stages"]:
        return setup_stages_main(sys.argv[2:])
    if sys.argv[1:2] == ["--step"]:
        return step_main()
    sys.path.insert(0, ROOT)
    from meshclust2_tpu_torch import cli as torch_cli
    from meshclust2_tpu_torch.cluster.engine import distance_d
    from meshclust2_tpu_torch.model.weights import load_weights
    from meshclust2_tpu_torch.ops import _build
    from meshclust2_tpu_torch.ops.closest_mean import (
        closest_mean, closest_mean_ref)
    from meshclust2_tpu_torch.features import flags as F
    from meshclust2_tpu_torch.model.classifier import (
        STATS_SINGLES, CompiledModel, model_to_torch)
    from meshclust2_tpu_torch.model.weights import ModelBlock
    from meshclust2_tpu_torch.ops.pair_stats import (
        center_block_stats, derive_singles, narrow_sums, pair_stats,
        pair_stats_decision, pair_stats_decision_ref, pair_stats_ref)
    from meshclust2_tpu_torch.ops.window_absorb import (
        StepState, step_scratch, tie_keys, window_step, window_step_block,
        window_step_blocks, window_step_ref)
    from meshclust2_tpu_torch.ops.plane_singles import plane_singles, plane_singles_ref
    from meshclust2_tpu_torch.ops.phase import (closest_candidates,
                                                closest_candidates_block, merge_replay,
                                                phase_layout)
    from meshclust2_tpu_torch.ops.kmer_count import kmer_count
    from meshclust2_tpu_torch.ops.window_select import WindowSelect
    from meshclust2_tpu_torch.cluster import device_phase
    from meshclust2_tpu_torch.cluster.device_loop import TorchDeviceAccumulator
    from meshclust2_tpu_torch.cluster.device_phase import TorchDevicePhaseUpdater
    from meshclust2_tpu_torch.cluster.device_store import DeviceStore
    from meshclust2_tpu_torch.runtime import card_name_and_power, resolve_device

    wrappers = {"pair_stats": pair_stats, "pair_stats_decision": pair_stats_decision,
                "closest_mean": closest_mean, "window_absorb": window_step,
                "pair_stats_decision_full": DecisionCount("full_launches"),
                "plane_singles": plane_singles,
                "pair_stats_decision_plane": DecisionCount("plane_launches"),
                "phase_layout": phase_layout, "closest_candidates": closest_candidates,
                "merge_replay": merge_replay, "kmer_count": kmer_count,
                "window_absorb_block": window_step_block,
                "closest_candidates_block": closest_candidates_block,
                "window_select": WindowSelect}
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
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        builds = dict(zip(SOURCES, pool.map(_build.load, SOURCES)))
    for built in builds.values():
        ptxas = "; ".join(ln.strip() for ln in built.log.splitlines()
                          if "registers" in ln or "spill" in ln)
        phase("b", f"built {os.path.relpath(built.path, ROOT)} (nvcc "
                   f"{built.seconds:.3f} s); ptxas: {ptxas}")
    phase("b", f"{len(builds)} builds in {time.perf_counter() - t0:.3f} s")
    from kernel_ab import fast_kernels

    fast = fast_kernels(builds["pair_stats"])
    phase("b", f"pair_stats_kernel's fast instantiations (neither FULL nor PLANE; "
               f"count type, NV, NARROW), ptxas: " + "; ".join(
                   f"{k}: {v[0]}" for k, v in sorted(fast.items())))

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
            for (form, (a, b)), maxc in ((f, m) for f in forms.items()
                                         for m in (None, int(counts.max()))):
                a_d = torch.from_numpy(a).to(dev)
                b_d = torch.from_numpy(b).to(dev)
                got = pair_stats(c_d, a_d, b_d, maxc=maxc)
                torch.cuda.synchronize()
                plain = pair_stats_ref(c_d, a_d, b_d)
                want = torch.from_numpy(oracle(counts, a, b))
                if not (torch.equal(got, plain) and torch.equal(got.cpu(), want)):
                    raise AssertionError(f"pair_stats differs: {dtype.__name__} "
                                         f"D={d} {form} form, maxc {maxc}")
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
               f"forms, ragged P, with and without the store's largest count)")

    # (c1) the fused kernel = its plain sequence (pair_stats_ref, the
    # moments, derive_singles, decision_from_raw) bit for bit on stats, s,
    # prob and dist, and its stats = the int64 oracle: uint8/uint16, D in
    # 16..4096, both forms, the 32-bit (counts < 40, largest count known)
    # and 64-bit sums (full range, unknown), the 10k model and a synthetic
    # one with every derivable single and every combo kind
    all_singles = list(STATS_SINGLES)
    synth_combos = [(F.COMBO_XY, F.FEAT_MANHATTAN | F.FEAT_EMD),
                    (F.COMBO_XY2, F.FEAT_EUCLIDEAN | F.FEAT_INTERSECTION),
                    (F.COMBO_X2Y, F.FEAT_KULCZYNSKI2 | F.FEAT_SIMRATIO),
                    (F.COMBO_X2Y2, F.FEAT_NORMALIZED_VECTORS | F.FEAT_PEARSON_COEFF),
                    (F.COMBO_XY, F.FEAT_D2z), (F.COMBO_X2Y2, F.FEAT_EUCLIDEAN_Z),
                    (F.COMBO_X2Y, F.FEAT_LENGTHD | F.FEAT_EMD),
                    (F.COMBO_XY2, F.FEAT_PEARSON_COEFF | F.FEAT_D2z)]
    bench_model = CompiledModel(load_weights(
        os.path.join(FIX, "bench10k_weights.txt")).classifier)

    def moment_store(counts, known_max=True):
        c64 = counts.astype(np.int64)
        up = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        return DeviceStore(counts=up(counts),
                           mags=up(c64.sum(axis=1).astype(np.float64)),
                           selfdot=up((c64 * c64).sum(axis=1).astype(np.float64)),
                           lens=up(rng.integers(700, 1500, len(counts)).astype(np.float64)),
                           stddevs=up(rng.random(len(counts)) * 3 + 0.5),
                           maxc=int(counts.max()) if known_max else None)

    def synthetic_model(st, a_d, b_d):
        """All 11 derivable singles, every combo kind; bounds from the
        singles' range over these pairs."""
        b_d = b_d.expand(len(a_d))
        raw = derive_singles(pair_stats_ref(st.counts, a_d, b_d),
                             *(getattr(st, m)[i] for m in ("mags", "selfdot", "stddevs")
                               for i in (a_d, b_d)), st.lens[a_d], st.lens[b_d],
                             st.counts.shape[1], all_singles).cpu().numpy()
        lo, hi = np.nanmin(raw, axis=0), np.nanmax(raw, axis=0)
        return CompiledModel(ModelBlock(
            combos=synth_combos, weights=rng.normal(0.0, 2.0, len(synth_combos) + 1),
            singles=all_singles, mins=lo, maxs=np.where(hi > lo, hi, lo + 1.0)))

    def decision_check(st, a_d, b_d, model, what):
        """The fused kernel against its plain sequence; the largest
        difference over stats and (s, prob, dist), or raise."""
        params = model_to_torch(model, dev)
        stats, dec = pair_stats_decision(st, params, a_d, b_d)
        torch.cuda.synchronize()
        p_stats, p_dec = pair_stats_decision_ref(st, params, a_d, b_d)
        if not (torch.equal(stats, p_stats)
                and all(same_f64(dec[r], p_dec[r]) for r in range(3))):
            raise AssertionError(f"pair_stats_decision differs: {what}")
        if torch.count_nonzero(dec[3:][torch.isfinite(p_dec[3:])]):
            raise AssertionError(f"a model without full-vector singles got "
                                 f"bounds: {what}")
        fin = torch.isfinite(p_dec)
        return max(float((stats - p_stats).abs().max()),
                   float((dec[fin] - p_dec[fin]).abs().max()) if fin.any() else 0.0)

    dec_err = 0.0
    n_cases = 0
    for dtype in (np.uint8, np.uint16):
        for d in (16, 64, 256, 1024, 4096):
            for sums in ("32-bit", "64-bit"):
                high = 40 if sums == "32-bit" else np.iinfo(dtype).max + 1
                counts = rng.integers(0, high, (300, d)).astype(dtype)
                st = moment_store(counts, known_max=sums == "32-bit")
                if narrow_sums(d, st.maxc) != (sums == "32-bit"):
                    raise AssertionError(f"{sums} case does not take that path")
                a = rng.integers(0, 300, 1001)
                for form, b in (("center", np.array([int(rng.integers(0, 300))])),
                                ("pair", rng.integers(0, 300, 1001))):
                    a_d, b_d = (torch.from_numpy(x).to(dev) for x in (a, b))
                    for name, model in (("10k model", bench_model),
                                        ("synthetic", synthetic_model(st, a_d, b_d))):
                        what = f"{dtype.__name__} D={d} {sums} {form} form, {name}"
                        dec_err = max(dec_err, decision_check(st, a_d, b_d, model, what))
                        stats, _ = pair_stats_decision(st, model_to_torch(model, dev),
                                                       a_d, b_d)
                        if not np.array_equal(stats.cpu().numpy(), oracle(
                                counts, a, np.broadcast_to(b, a.shape))):
                            raise AssertionError(f"stats differ from the oracle: {what}")
                        n_cases += 1
    # a store off a 16-byte boundary (the element loop), and indices outside
    # [0, N): -1 statistics, NaN decisions, in both forms
    counts = rng.integers(0, 50, (200, 1024)).astype(np.uint8)
    st = moment_store(counts)
    raw_buf = torch.empty(counts.nbytes + 1, dtype=torch.uint8, device=dev)
    st = DeviceStore(**{**st.__dict__, "counts": raw_buf[1:].view(200, 1024).copy_(st.counts)})
    a_d = torch.from_numpy(rng.integers(0, 200, 777)).to(dev)
    b_d = torch.from_numpy(rng.integers(0, 200, 777)).to(dev)
    dec_err = max(dec_err, decision_check(st, a_d, b_d, bench_model, "unaligned store"))
    n_cases += 1
    params = model_to_torch(bench_model, dev)
    for b_bad in ([-1, 200, 5], [200]):
        stats, dec = pair_stats_decision(st, params, torch.tensor([3, 4, 200], device=dev),
                                         torch.tensor(b_bad, device=dev))
        torch.cuda.synchronize()
        if not ((stats == -1).all() and torch.isnan(dec).all()):
            raise AssertionError(f"invalid indices {b_bad}: {stats}, {dec}")
        n_cases += 1
    phase("c1", f"pair_stats_decision kernel == plain (stats, s, prob, dist bit for "
                f"bit) == int64 oracle (stats) in {n_cases} cases (uint8/uint16, D in "
                f"16/64/256/1024/4096, 32- and 64-bit sums, center and pair forms, "
                f"the 10k model and a synthetic one with all 11 derivable singles "
                f"and every combo kind; an unaligned store; invalid indices)")

    # (c2) closest_mean kernel = plain version (first, unc) = a numpy
    # reference (distance_d over each segment's kept rows, first strict
    # minimum) wherever unc is False; ragged and skewed segments
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
            for layout in ("ragged", "skewed"):
                if layout == "ragged":
                    rows, seg, keep = segments(rng, 300, 77, 20)
                else:
                    rows, seg, keep = skewed_segments(rng, 300, 3_000, 77)
                args = closest_args(counts, rows, seg, keep)
                if dtype == np.uint8 and d == 256:
                    # a store off a 16-byte boundary: the bin-wise path
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
                    raise AssertionError(f"closest_mean differs: {dtype.__name__} "
                                         f"D={d} {layout}")
                cm_err = max(cm_err, int((first - p_first).abs().max()))
                n_cases += 1
                n_unc += int(u.sum())
    phase("c2", f"closest_mean kernel == plain (first, unc) == numpy distance_d "
                f"argmin in {n_cases} cases (uint8/uint16, D in 16/256/1024/4096, "
                f"77 ragged segments with empty, one-row and duplicated rows, and "
                f"77 skewed segments of 3,000 positions, 90 % in one, a few with "
                f"nothing kept; an unaligned store); {n_unc} segments uncertain")

    # (c4) the step kernel = its plain version on every output (the trip,
    # alive, assign, astep, members but the plain version's sink, msum),
    # under the tie guard's keys of the 10k default path's model, and at
    # D = 16,384 under those of the long-record model
    tie10k = tie_keys(bench_model.singles, bench_model.combos)
    wa_err = step_kernel_checks(rng, dev, tie10k)

    # (c5) the FULL instantiation against its plain version and the port's
    # numpy host oracle
    full_err = full_kernel_checks(dev, rng)

    # (c6) the plane-singles kernel against its plain version and the port's
    # numpy host oracle, and the PLANE instantiation of the fused kernel
    plane_err, plane_dec_err = plane_kernel_checks(dev, rng)

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
        maxc = int(st_d.max())   # the stores' largest count, as training passes it
        got = pair_stats(st_d, a_d, b_d, maxc=maxc)
        plain = pair_stats_ref(st_d, a_d, b_d)
        torch.cuda.synchronize()
        if not torch.equal(got, plain):
            raise AssertionError(f"pair_stats differs at the {form} main-path shape")
        max_err = max(max_err, int((got - plain).abs().max()))
        k_ms = cuda_ms(lambda: pair_stats(st_d, a_d, b_d, maxc=maxc), reps=50)
        p_ms = cuda_ms(lambda: pair_stats_ref(st_d, a_d, b_d), reps=10)
        b_ms, b_by = pair_stats_bound(st_d, a_d, b_d)
        timing[form] = (k_ms, p_ms, b_ms, b_by)
        phase("d", f"{form} form P={len(a_d)} N={len(st_d)} D=1024 uint8: "
                   f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms (median, CUDA "
                   f"events), bound {b_ms:.4f} ms ({b_by}); {card}")

    # (d1) the fused kernel at the main path's shapes, with the 10k model:
    # the center form at W = 1,571 (the 10k mean window) and 2,048, the pair
    # form at P = 98,304; against its plain sequence and the statistics-only
    # kernel on the same pairs
    c64 = store.cpu().numpy().astype(np.int64)
    st10k = DeviceStore(
        counts=store, mags=torch.from_numpy(c64.sum(axis=1).astype(np.float64)).to(dev),
        selfdot=torch.from_numpy((c64 * c64).sum(axis=1).astype(np.float64)).to(dev),
        lens=torch.from_numpy(rng.integers(800, 1500, 10_000).astype(np.float64)).to(dev),
        stddevs=torch.from_numpy(rng.random(10_000) * 3 + 0.5).to(dev),
        maxc=int(store.max()))
    params10k = model_to_torch(bench_model, dev)
    n_s, n_c = len(bench_model.singles), len(bench_model.combos)
    center_row = torch.tensor([4_000], device=dev)
    dshapes = {
        "center W=1571": (torch.arange(3_000, 4_571, device=dev), center_row),
        "center W=2048": (torch.arange(3_000, 5_048, device=dev), center_row),
        "pair P=98304": shapes["pair"][1:],
    }
    dec_timing = {}
    for form, (a_d, b_d) in dshapes.items():
        decision_check(st10k, a_d, b_d, bench_model, f"10k shape {form}")
        k_ms = cuda_ms(lambda: pair_stats_decision(st10k, params10k, a_d, b_d), reps=50)
        p_ms = cuda_ms(lambda: pair_stats_decision_ref(st10k, params10k, a_d, b_d),
                       reps=10)
        s_ms = cuda_ms(lambda: pair_stats(store, a_d, b_d, maxc=st10k.maxc), reps=50)
        dev_us = device_us(lambda: pair_stats_decision(st10k, params10k, a_d, b_d))
        s_us = device_us(lambda: pair_stats(store, a_d, b_d, maxc=st10k.maxc))
        b_ms, b_by = decision_bound(store, a_d, b_d, n_s, n_c)
        dec_timing[form] = dict(ms=k_ms, plain_ms=p_ms, stats_ms=s_ms, device_us=dev_us,
                                stats_device_us=s_us, bound_ms=b_ms, bound_by=b_by)
        phase("d1", f"pair_stats_decision {form}, N=10,000 D=1024 uint8, the 10k "
                    f"model ({n_s} singles, {n_c} combos): kernel {k_ms:.4f} ms, plain "
                    f"{p_ms:.4f} ms, statistics-only kernel {s_ms:.4f} ms (median, CUDA "
                    f"events); device {dev_us:.2f} us, statistics-only {s_us:.2f} us "
                    f"(CUDA events behind a busy wait); bound {b_ms:.6f} ms ({b_by}); "
                    f"{card}")

    # (d2) closest_mean against its plain version on the same store:
    # P = 98,304 pairs in 1,000 uneven segments, 80 % kept, and the same P
    # and C with one segment of 90 % (the launch's tail); the update phase's
    # own batches follow in (f3)
    mags = store.sum(dim=1, dtype=torch.int64).to(torch.float64)
    kw = dict(maxc=int(store.max()), tie_margin=TIE_MARGIN)

    def closest_bound(args, n_segs):
        """The kept rows read once with their mags, the row list, segment
        ids and keep flags read, first and unc written; CLOSEST_OPS per
        kept row and element, plus the mean."""
        counts, rows_d, seg_d, keep_d = args[0], args[2], args[3], args[4]
        kept = rows_d[keep_d]
        d = counts.shape[1]
        return bound_ms(torch_unique(kept) * (d * counts.element_size() + 8)
                        + tbytes(rows_d, seg_d, keep_d) + 9 * n_segs,
                        CLOSEST_OPS * len(kept) * d + 2 * d)

    def closest_case(args, n_segs, what, timed=True, kw=kw):
        """The kernel == the plain version on args, and its device us; when
        timed, also its and the plain version's ms and the bound."""
        plain = closest_mean_ref(*args, n_segs, **kw)
        got = closest_mean(*args, n_segs, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])):
            raise AssertionError(f"closest_mean differs ({what})")
        out = dict(largest=int(torch.bincount(args[3], minlength=n_segs).max()),
                   largest_kept=int(torch.bincount(
                       args[3], weights=args[4].to(torch.float64),
                       minlength=n_segs).max()),
                   device_us=device_us(lambda: closest_mean(*args, n_segs, **kw)))
        if timed:
            out["ms"] = cuda_ms(lambda: closest_mean(*args, n_segs, **kw), reps=50)
            out["plain_ms"] = cuda_ms(lambda: closest_mean_ref(*args, n_segs, **kw),
                                      reps=10)
            out["bound_ms"], out["bound_by"] = closest_bound(args, n_segs)
        return out

    def closest_line(r):
        timed = (f", kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms "
                 f"(median, CUDA events), bound {r['bound_ms']:.4f} ms "
                 f"({r['bound_by']})") if "ms" in r else ""
        return (f"largest segment {r['largest']} positions, {r['largest_kept']} "
                f"kept: device {r['device_us']:.2f} us "
                f"(CUDA events behind a busy wait){timed}; {card}")

    def on_card(*arrays):
        return [store, mags] + [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                                for a in arrays]

    n_pairs, n_segs = 98_304, 1_000
    cuts = np.sort(rng.integers(0, n_pairs + 1, n_segs - 1))
    seg = np.searchsorted(cuts, np.arange(n_pairs), side="right").astype(np.int64)
    cm_cut = closest_case(on_card(rng.integers(0, 10_000, n_pairs), seg,
                                  rng.random(n_pairs) < 0.8), n_segs, "random cuts")
    phase("d2", f"closest_mean P={n_pairs} C={n_segs} random cuts, 80 % kept, "
                f"D=1024 uint8: {closest_line(cm_cut)}")
    cm_skew = closest_case(on_card(*skewed_segments(rng, 10_000, n_pairs, n_segs)),
                           n_segs, "skewed")
    phase("d2", f"closest_mean skewed P={n_pairs} C={n_segs}, 80 % kept, D=1024 "
                f"uint8: {closest_line(cm_skew)}")

    # (d3) the step kernel at the 10k accumulate shapes: a pool of the
    # 10,000 rows of the same store, W = 1,571 (the mean window) and 2,048,
    # 15 positives, an open cluster of 9 and of 2,000 members
    store_np = store.cpu().numpy()
    st_moments = [torch.from_numpy(rng.random(10_000) * 30).to(dev) for _ in range(2)]
    # allocated once, as the accumulator does in ensure_ready
    scratch = step_scratch(10_000, dev)
    step_timing = {}
    for w, mcnt in ((1_571, 9), (2_048, 9), (1_571, 2_000), (2_048, 2_000)):
        case = step_case(rng, 10_000, "absorb", w=w, mcnt=mcnt, npos=15)
        args, skw = step_inputs(case, store_np, st_moments, dev, tie10k)
        trip, _ = step_check(args, skw, f"10k shape W={w} members={mcnt}", scratch)
        if trip.tolist()[:2] != [0, 15]:
            raise AssertionError(f"the timed step is no absorb of 15: {trip}")
        run_args = fresh(args)
        saved = StepState(*(t.clone() for t in run_args[6]))

        def restore():
            for t, t0 in zip(run_args[6], saved):
                t.copy_(t0)

        k_ms = cuda_ms(lambda: window_step(*run_args, **skw, scratch=scratch), reps=50,
                       setup=restore)
        p_ms = cuda_ms(lambda: window_step_ref(*run_args, **skw), reps=10,
                       setup=restore)
        dev_us = device_us(lambda: window_step(*run_args, **skw, scratch=scratch),
                           setup=restore)
        b_ms, b_by = step_bound(w, 15, mcnt + 15, 1024, 1)
        step_timing[w, mcnt] = (k_ms, p_ms, b_ms, b_by, dev_us)
        phase("d3", f"window_step W={w}, 15 positive, {mcnt} + 15 members, "
                    f"D=1024 uint8, pool 10,000: kernel {k_ms:.4f} ms, plain "
                    f"{p_ms:.4f} ms (median, CUDA events), device {dev_us:.2f} us "
                    f"(CUDA events behind a busy wait), bound {b_ms:.6f} ms ({b_by}); "
                    f"{card}")

    # (m4) the step kernel's block mode at the same 10k shape, G = 4 row
    # blocks in this process and G = 1, against the one-block kernel and the
    # plain version; the one-rank session's three launches timed
    step_block = step_block_checks(step_case(rng, 10_000, "absorb", w=1_571, mcnt=9,
                                             npos=15), store_np, st_moments, scratch,
                                   dev, card, tie10k)

    # (d4) the FULL kernel at the main path's shapes, on the same store: the
    # 10k mean window (center form, W = 1,571) and P = 98,304, for both
    # FULL_MODELS (bounds from the store's own singles), against its plain
    # version, its bound and the fast 10k model's time at the same shape (d1)
    from meshclust2_tpu_torch.model.classifier import VECTOR_SINGLES
    from meshclust2_tpu_torch.ops.pair_stats import vector_singles_ref

    with tempfile.TemporaryDirectory(prefix="mc2_probe_") as ptmp:
        sass, sass_all = sass_counts(ptmp, _build.nvcc_path())
    phase("d4", f"float64 instructions a call compiles to for sm_90a (cuobjdump "
                f"-sass of probe kernels, static, the main body before the first "
                f"EXIT): log {sass['log']}, division {sass['div']}, square root "
                f"{sass['sqrt']} (with the slow-path subroutines: "
                f"{sass_all['log']}, {sass_all['div']}, {sass_all['sqrt']})")
    full_timing = {}
    for name, (singles, combos) in full_specs().items():
        a_s, b_s = dshapes["pair P=98304"]
        a_s, b_s = a_s[:2_000], b_s[:2_000]
        vf = [f for f in singles if f in VECTOR_SINGLES]
        vals, _ = vector_singles_ref(store, a_s, b_s, st10k.mags, vf)
        raw = derive_singles(
            pair_stats_ref(store, a_s, b_s),
            *(getattr(st10k, m)[i] for m in ("mags", "selfdot", "stddevs")
              for i in (a_s, b_s)), st10k.lens[a_s], st10k.lens[b_s], 1024,
            singles, dict(zip(vf, vals.T))).cpu().numpy()
        lo, hi = raw.min(axis=0), raw.max(axis=0)
        fmodel = CompiledModel(ModelBlock(
            combos=combos, weights=rng.normal(0.0, 2.0, len(combos) + 1),
            singles=singles, mins=lo, maxs=np.where(hi > lo, hi, lo + 1.0)))
        fparams = model_to_torch(fmodel, dev)
        for form in ("center W=1571", "pair P=98304"):
            a_d, b_d = dshapes[form]
            stats, dec = pair_stats_decision(st10k, fparams, a_d, b_d)
            torch.cuda.synchronize()
            p_stats, p_dec = pair_stats_decision_ref(st10k, fparams, a_d, b_d)
            if not (torch.equal(stats, p_stats)
                    and bool(((dec[0] - p_dec[0]).abs() <= dec[3] + p_dec[3]).all())
                    and bool(((dec[2] - p_dec[2]).abs() <= dec[4] + p_dec[4]).all())):
                raise AssertionError(f"FULL kernel beyond its bounds at the 10k "
                                     f"shape {form} ({name})")
            k_ms = cuda_ms(lambda: pair_stats_decision(st10k, fparams, a_d, b_d),
                           reps=30)
            p_ms = cuda_ms(lambda: pair_stats_decision_ref(st10k, fparams, a_d, b_d),
                           reps=3, warm=1)
            dev_us = device_us(lambda: pair_stats_decision(st10k, fparams, a_d, b_d))
            b_ms, b_by = full_bound(store, a_d, b_d, singles, len(combos), sass)
            full_timing[name, form] = dict(ms=k_ms, plain_ms=p_ms, device_us=dev_us,
                                           bound_ms=b_ms, bound_by=b_by)
            phase("d4", f"pair_stats_decision FULL {form}, N=10,000 D=1024 uint8, the "
                        f"{name} model ({len(singles)} singles, {len(combos)} combos): "
                        f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms (median, CUDA "
                        f"events); device {dev_us:.2f} us (CUDA events behind a busy "
                        f"wait); bound {b_ms:.6f} ms ({b_by}, "
                        f"{full_element_ops(singles, sass):.0f} float64 instructions "
                        f"an element at 17 T/s); the fast 10k model here: device "
                        f"{dec_timing[form]['device_us']:.2f} us; {card}")

    # (d5) the plane-singles kernel at the 10k shapes: a pool over the same
    # random store (one-mers, lengths at random) and its plane store of every
    # plane single at k = 5; the center form at W = 1,571 (the 10k mean
    # window) and the pair form at P = 98,304, with the plane singles of the
    # markov and the plane model, against its plain version and its bound;
    # then the fused kernel's PLANE instantiation on the same pairs, with a
    # model over the store's own singles
    from meshclust2_tpu_torch.model.classifier import PLANE_SINGLES
    from meshclust2_tpu_torch.ops.device_features import TorchDeviceFeatureEngine

    ps10k = synthetic_pool(store.cpu().numpy(), rng, 5)
    eng10k = TorchDeviceFeatureEngine(ps10k, plane_flags(5), st10k)
    phase("d5", f"plane store of the 10k-row pool, 9 plane singles: built and "
                f"uploaded in {eng10k.seconds:.3f} s, {eng10k.planes.nbytes():,} "
                f"bytes on the card (the markov model's store alone: "
                f"{TorchDeviceFeatureEngine(ps10k, plane_specs()['markov'][0], st10k).planes.nbytes():,}; "
                f"the plane model's: "
                f"{TorchDeviceFeatureEngine(ps10k, plane_specs()['plane'][0], st10k).planes.nbytes():,})")
    plane_timing = {}
    for name in ("markov", "plane"):
        singles, combos = plane_specs()[name]
        pflags = [f for f in singles if f in PLANE_SINGLES]
        a_s, b_s = (t[:2_000] for t in dshapes["pair P=98304"])
        pv = plane_singles_ref(eng10k.planes, a_s, b_s, pflags)
        raw = derive_singles(
            pair_stats_ref(store, a_s, b_s),
            *(getattr(st10k, m)[i] for m in ("mags", "selfdot", "stddevs")
              for i in (a_s, b_s)), st10k.lens[a_s], st10k.lens[b_s], 1024,
            singles, dict(zip(pflags, pv[0]))).cpu().numpy()
        lo, hi = raw.min(axis=0), raw.max(axis=0)
        pparams = model_to_torch(CompiledModel(ModelBlock(
            combos=combos, weights=rng.normal(0.0, 2.0, len(combos) + 1),
            singles=singles, mins=lo, maxs=np.where(hi > lo, hi, lo + 1.0))), dev)
        for form in ("center W=1571", "pair P=98304"):
            a_d, b_d = dshapes[form]
            got = plane_singles(eng10k.planes, a_d, b_d, pflags)
            torch.cuda.synchronize()
            plain = plane_singles_ref(eng10k.planes, a_d, b_d, pflags)
            if not (torch.isfinite(got).all() and bool(
                    ((got[0] - plain[0]).abs() <= got[1] + plain[1]).all())):
                raise AssertionError(f"plane_singles beyond its bounds at the 10k "
                                     f"shape {form} ({name})")
            err = float((got[0] - plain[0]).abs().max())
            k_ms = cuda_ms(lambda: plane_singles(eng10k.planes, a_d, b_d, pflags),
                           reps=20)
            p_ms = cuda_ms(lambda: plane_singles_ref(eng10k.planes, a_d, b_d, pflags),
                           reps=3, warm=1)
            dev_us = device_us(lambda: plane_singles(eng10k.planes, a_d, b_d, pflags))
            b_ms, b_by = plane_bound(eng10k.planes, a_d, b_d, pflags, sass)
            stats, dec = pair_stats_decision(st10k, pparams, a_d, b_d, got)
            torch.cuda.synchronize()
            p_stats, p_dec = pair_stats_decision_ref(st10k, pparams, a_d, b_d, got)
            if not (torch.equal(stats, p_stats)
                    and bool(((dec[0] - p_dec[0]).abs() <= dec[3] + p_dec[3]).all())
                    and bool(((dec[2] - p_dec[2]).abs() <= dec[4] + p_dec[4]).all())):
                raise AssertionError(f"PLANE kernel beyond its bounds at the 10k "
                                     f"shape {form} ({name})")
            d_ms = cuda_ms(lambda: pair_stats_decision(st10k, pparams, a_d, b_d, got),
                           reps=20)
            dp_ms = cuda_ms(lambda: pair_stats_decision_ref(st10k, pparams, a_d, b_d,
                                                            got), reps=3, warm=1)
            d_us = device_us(lambda: pair_stats_decision(st10k, pparams, a_d, b_d, got))
            db_ms, db_by = decision_bound(store, a_d, b_d, len(singles), len(combos),
                                          extra_bytes=16 * (len(pflags) + 1) * len(a_d))
            plane_timing[name, form] = dict(
                ms=k_ms, plain_ms=p_ms, device_us=dev_us, bound_ms=b_ms, bound_by=b_by,
                err=err, dec_ms=d_ms, dec_plain_ms=dp_ms, dec_device_us=d_us,
                dec_bound_ms=db_ms, dec_bound_by=db_by)
            phase("d5", f"plane_singles {form}, N=10,000 D=1024 uint8, the {name} "
                        f"model's {len(pflags)} plane singles: kernel {k_ms:.4f} ms, "
                        f"plain {p_ms:.4f} ms (median, CUDA events); device "
                        f"{dev_us:.2f} us (CUDA events behind a busy wait); bound "
                        f"{b_ms:.6f} ms ({b_by}, "
                        f"{plane_element_ops(pflags, sass, 5):.0f} float64 "
                        f"instructions an element at 17 T/s); |kernel - plain| "
                        f"{err:.3g}; then the PLANE decision ({len(singles)} singles, "
                        f"{len(combos)} combos): kernel {d_ms:.4f} ms, plain "
                        f"{dp_ms:.4f} ms, device {d_us:.2f} us, bound {db_ms:.6f} ms "
                        f"({db_by}); {card}")
    del eng10k, ps10k

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
        launches = {}
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
            upd = update_line(res, MED2000_UPDATER_PAIRS)
            phase("e", f"med2000 ({path}): sorted CLSTR == med2000_ref.clstr, "
                       f"counters {counters(res)}, {acc_line}, {upd}, "
                       f"{window_parts(res.clock.stamps, 2000)}")
        # a forced decision margin aborts the phase; the engine resumes on
        # the per-iteration updater and still gives the reference
        out = os.path.join(tmp, "med2000_margin.clstr")
        printed = io.StringIO()
        os.environ["MC2_DD_MARGIN"] = "3e-3"
        try:
            with contextlib.redirect_stdout(printed):
                res = run_path(torch_cli, "default", [
                    "--device", "cuda", "--recover",
                    os.path.join(FIX, "med2000_weights.txt"), "--output", out,
                    os.path.join(FIX, "med2000.fasta")])
        finally:
            os.environ.pop("MC2_DD_MARGIN")
        abort_lines = [ln for ln in printed.getvalue().splitlines()
                       if ln.startswith("device update phase: guarded abort")]
        with open(out) as f, open(os.path.join(FIX, "med2000_ref.clstr")) as g:
            same = sorted(f.readlines()) == sorted(g.readlines())
        if res.rc != 0 or not same or not abort_lines or res.phase.last_abort == 0:
            raise AssertionError(f"med2000 under MC2_DD_MARGIN=3e-3: rc {res.rc}, "
                                 f"CLSTR == reference {same}, abort lines "
                                 f"{abort_lines}")
        phase("e", f"med2000 (default, MC2_DD_MARGIN=3e-3): sorted CLSTR == "
                   f"med2000_ref.clstr; printed \"{abort_lines[0]}\"; "
                   f"{update_line(res, MED2000_UPDATER_PAIRS)}; accumulator aborts "
                   f"{res.accumulator.aborts}")

        # (e2) med2000 with the two full-vector models on the three paths
        full_model_phase("e2", torch_cli, os.path.join(FIX, "med2000.fasta"), 2000,
                         tmp, card, wrappers, launches)

        # (e3) med2000 with the three plane models: the scorer alone on the
        # card, each held byte for byte against the JAX --device host run
        plane_model_phase(torch_cli, os.path.join(FIX, "med2000.fasta"), tmp, card,
                          wrappers, launches)

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
        # the default path's update batches, those of its phase's run (not
        # of the warm-ups), kept for (f3) as closest_mean's arguments (copies:
        # the phase's batches are views of buffers that the next iteration
        # overwrites), and the state its phase starts from, for (d6), (h2)
        batches = []
        phase_runs = []
        real_run = TorchDevicePhaseUpdater.run

        def recording(counts, mags, keep, st, rows, delta, lay, n_alive, n_pairs,
                      out, **kwargs):
            if phase_runs:
                batches.append(((counts, mags, lay.b_rows[:n_pairs].clone(),
                                 lay.seg[:n_pairs].clone(), keep.clone(), n_alive),
                                kwargs))
            return closest_candidates(counts, mags, keep, st, rows, delta, lay, n_alive,
                                      n_pairs, out, **kwargs)

        def recording_run(self, clusters, *args, **kwargs):
            phase_runs.append((self, [(c.center_row, list(c.members))
                                      for c in clusters]))
            return real_run(self, clusters, *args, **kwargs)

        # the loop state before the WINDOW_AT-th scan window and seed of the
        # default path's accumulate loop, for (d7)
        win10k, win_calls = {}, Counter()
        real_window = TorchDeviceAccumulator._window
        real_seed_window = TorchDeviceAccumulator._seed_window

        def loop_state(acc):
            return [t.clone() for t in (acc._alive, acc._assign, acc._astep, acc._members,
                                        acc._msum, acc._crank0)]

        def recording_window(self, cur_d, trip):
            if trip is not None:
                win_calls["window"] += 1
                if win_calls["window"] == WINDOW_AT:
                    win10k["acc"] = self
                    win10k["window"] = (loop_state(self), dict(center=cur_d.clone(),
                                                               trip=trip.clone()))
            return real_window(self, cur_d, trip)

        def recording_seed_window(self, cid, stepc):
            win_calls["seed"] += 1
            if win_calls["seed"] == WINDOW_AT:
                win10k["seed"] = (loop_state(self), dict(cid=cid, stepc=stepc))
            return real_seed_window(self, cid, stepc)

        # the counting part of set-up (the CLI's build_point_set calls)
        count_s = []
        real_bps = torch_cli.build_point_set

        def timed_bps(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return real_bps(*args, **kwargs)
            finally:
                count_s.append(time.perf_counter() - t0)

        torch_cli.build_point_set = timed_bps
        path_stamps = {}
        for path in PATHS:
            argv[5] = os.path.join(tmp, f"bench10k_{path}.clstr")
            for fn in wrappers.values():
                fn.launches = 0
            count_s.clear()
            default = path == "default"
            device_phase.closest_candidates = recording if default else closest_candidates
            TorchDevicePhaseUpdater.run = recording_run if default else real_run
            TorchDeviceAccumulator._window = recording_window if default else real_window
            TorchDeviceAccumulator._seed_window = (recording_seed_window if default
                                                   else real_seed_window)
            try:
                res = run_path(torch_cli, path, argv)
            finally:
                device_phase.closest_candidates = closest_candidates
                TorchDevicePhaseUpdater.run = real_run
                TorchDeviceAccumulator._window = real_window
                TorchDeviceAccumulator._seed_window = real_seed_window
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
            path_stamps[path] = dict(res.clock.stamps)
            upd = update_line(res, BENCH10K_UPDATER_PAIRS)
            phase("f", f"bench 10k ({path}): signature == bench10k_ref_t1 "
                       f"({len(got)} clusters), counters {counters(res)}; "
                       f"{window_parts(res.clock.stamps, 10_000)} on {card}; "
                       f"launches {launches[path]}; {acc_line}; scorer pairs "
                       f"{res.scorer.scored_pairs}, re-checked "
                       f"{res.scorer.rechecked_pairs}; {upd}")

        # (f3) closest_mean on the default path's own update batches (the
        # closest-to-mean of its phase's folded launches): equal to the plain
        # version, its device time per batch
        real = []
        for args, kwargs in batches:
            if len(args[2]) > 1:
                ckw = {k: kwargs[k] for k in ("maxc", "tie_margin")}
                r = closest_case(list(args[:5]), args[5], "10k update batch",
                                 timed=not real, kw=ckw)
                r.update(P=len(args[2]), C=args[5], kept=int(args[4].sum()))
                real.append(r)
                phase("f3", f"10k update batch {len(real)}: P={r['P']} C={r['C']} "
                            f"kept {r['kept']}, {closest_line(r)}")
        # 7 iterations and the final pass; an aborted pass is redone on the
        # host
        want_batches = 8 + bool(phase_runs and phase_runs[0][0].last_abort)
        if len(real) != want_batches:
            raise AssertionError(f"the 10k update phase ran {len(real)} batches")
        phase("f3", f"10k update batches, sum of device time "
                    f"{sum(r['device_us'] for r in real):.2f} us; {card}")

        # (d6) the phase's kernels on the 10k default path's own state after
        # accumulate (C = 1,147)
        if (len(phase_runs) != 1
                or len(phase_runs[0][1]) != BENCH10K_COUNTERS["default"][2]):
            raise AssertionError(f"the 10k default path ran the phase "
                                 f"{len(phase_runs)} times")
        ph10k, state10k = phase_runs[0]
        phase_timing = phase_kernel_checks(ph10k, state10k, card)
        phase("d6", f"launches of the 10k default path (f), its warm-up "
                    f"included: " + ", ".join(
                        f"{k} {launches['default'][k]}" for k in (
                            "phase_layout", "closest_candidates", "merge_replay",
                            "closest_mean")))

        # (d7) window_select against its plain twin on the 10k default path's
        # loop state before its WINDOW_AT-th scan window and seed, and on
        # kernel_ab.py's seeded 100k pool (half alive) at its center, and
        # its seed with the first half of the pool gone
        if set(win10k) != {"acc", "window", "seed"}:
            raise AssertionError(f"the 10k default path's accumulate loop ran "
                                 f"{dict(win_calls)} scan windows and seeds")
        from kernel_ab import window_pool

        acc100k, carry100k = window_pool(np, torch, dev, 100_000)

        def state100k(alive):   # the loop state and its ranks
            acc100k._window(acc100k._upload(dict(carry100k, alive0=alive), 100_000)[-1],
                            None)
            return loop_state(acc100k)

        trip100k = torch.tensor([0, 2, 0, carry100k["cur0"]], dtype=torch.int64, device=dev)
        alive100k = carry100k["alive0"]
        win100k = {"window": (state100k(alive100k), dict(center=trip100k[3:].clone(),
                                                         trip=trip100k)),
                   "seed": (state100k(alive100k & (np.arange(100_000) >= 50_000)),
                            dict(cid=7, stepc=100_009))}
        win_timing = window_kernel_checks(
            {**window_cases(win10k.pop("acc"), win10k, 10_000),
             **window_cases(acc100k, win100k, 100_000)}, card)
        del acc100k, win100k

        # (k) the k-mer histogram kernel against its plain version and the
        # native counter, and its time on the 10k set's records
        kmer_timing = kmer_kernel_checks(fasta, card, dev)

        # (k2) the 10k default path with its counts built on the card
        # (MC2_DEVICE_COUNT=1), its launches counted from zero: the CLSTR
        # byte for byte that of (f)'s default run, the same counters.  The
        # set-up of both modes, stage by stage (setup_stages), with the
        # garbage collector's pauses: in this process (CUDA long
        # initialised) in SETUP_ORDER, then each run in a fresh process
        # (the first CUDA use included)
        torch_cli.build_point_set = real_bps

        def count_run(device_count: bool, name: str):
            argv[5] = os.path.join(tmp, f"bench10k_{name}.clstr")
            if device_count:
                os.environ["MC2_DEVICE_COUNT"] = "1"
            try:
                with setup_stages(torch_cli) as secs:
                    res = run_path(torch_cli, "default", argv)
            finally:
                os.environ.pop("MC2_DEVICE_COUNT", None)
            tag = "MC2_DEVICE_COUNT=1" if device_count else "native counter"
            if res.rc != 0:
                raise AssertionError(f"{tag}: the port CLI exited {res.rc}")
            with open(argv[5], "rb") as f, \
                    open(os.path.join(tmp, "bench10k_default.clstr"), "rb") as g:
                if f.read() != g.read():
                    raise AssertionError(f"{tag}: the 10k CLSTR differs from the "
                                         f"default run's")
            if counters(res) != BENCH10K_COUNTERS["default"]:
                raise AssertionError(f"{tag}: counters {counters(res)}")
            return res, (res.clock.stamps["read_in_points"], dict(secs))

        order = []
        for i, device_count in enumerate(SETUP_ORDER):
            if i == 0:
                # the first run, a device one, has its launches counted
                for fn in wrappers.values():
                    fn.launches = 0
            res_i, rec = count_run(device_count, f"setup{i}")
            if i == 0:
                res = res_i
                launches["device_count"] = {name: fn.launches
                                            for name, fn in wrappers.items()}
                check_launches("device_count", launches["device_count"])
            order.append(("MC2_DEVICE_COUNT=1" if device_count else "native counter", rec))
        fresh = []
        for mode in ("native", "device", "device", "native"):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--setup-stages", mode, fasta,
                 weights, os.path.join(tmp, f"bench10k_fresh_{len(fresh)}.clstr")],
                cwd=ROOT, capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"--setup-stages {mode} exited {proc.returncode}:\n"
                                     f"{proc.stderr[-3000:]}")
            got_f = json.loads(proc.stdout.strip().splitlines()[-1])
            fresh.append(("MC2_DEVICE_COUNT=1" if mode == "device" else "native counter",
                          (got_f["stamp"], got_f["stages"])))
        phase("k2", f"bench 10k (default, MC2_DEVICE_COUNT=1): CLSTR == the default "
                    f"run's byte for byte, counters {counters(res)}, "
                    f"{update_line(res, BENCH10K_UPDATER_PAIRS)}; kmer_count launches "
                    f"{launches['device_count']['kmer_count']}; "
                    f"{window_parts(res.clock.stamps, 10_000)}; {card}")
        setup_means = {}
        for where, runs_ in (("one process", order), ("fresh processes", fresh)):
            for i, (k, (stamp, secs)) in enumerate(runs_):
                phase("k2", f"set-up, {where}, run {i + 1} ({k}): "
                            f"{stage_line(stamp, Counter(secs))}")
            for k in ("native counter", "MC2_DEVICE_COUNT=1"):
                mine = [(a, Counter(b)) for kk, (a, b) in runs_ if kk == k]
                mean = Counter({st: statistics.mean(b.get(st, 0.0) for _, b in mine)
                                for st in SETUP_STAGES})
                stamp = statistics.mean(a for a, _ in mine)
                setup_means[f"{where}, {k}"] = (stamp, dict(mean))
                phase("k2", f"set-up, {where}, mean of {k} (order balanced): "
                            f"{stage_line(stamp, mean)}")
        kmer_timing["setup"] = {"one_process": order, "fresh_processes": fresh,
                                "means": setup_means}

        # (m) --multihost through the port's CLI on the card, a one-rank
        # NCCL group: the 10k set on the recover path through
        # MultihostScorer's per-window scoring (the engine flow of the
        # scorer-alone path), then again under MC2_DEVICE_COUNT=1; its
        # launches counted from zero; the signature of bench10k_ref_t1 and
        # the scorer-alone path's counters
        mh_stamps = {}
        for name, env in (("multihost", {"MC2_NO_DEVICE_SESSION": "1"}),
                          ("multihost_device_count", {"MC2_NO_DEVICE_SESSION": "1",
                                                      "MC2_DEVICE_COUNT": "1"})):
            out_m = os.path.join(tmp, f"bench10k_{name}.clstr")
            for fn in wrappers.values():
                fn.launches = 0
            os.environ.update(env)
            try:
                res = torch_cli.run(["--multihost", "--device", "cuda", "--recover", weights,
                                     "--output", out_m, fasta])
            finally:
                for k in env:
                    os.environ.pop(k, None)
            launches[name] = {k: fn.launches for k, fn in wrappers.items()}
            if res.rc != 0:
                raise AssertionError(f"--multihost exited {res.rc} ({name})")
            check_launches(name, launches[name])
            got = read_clstr(out_m)
            if len(got) != BENCH10K_CLUSTERS or signature(got) != ref_sig:
                raise AssertionError(f"--multihost: 10k signature differs ({len(got)} "
                                     f"clusters, {name})")
            want = BENCH10K_COUNTERS["no_device_loop_no_update_batch"]
            if counters(res) != want:
                raise AssertionError(f"--multihost counters {counters(res)} != {want}")
            mh_stamps[name] = dict(res.clock.stamps)
            sc = res.scorer
            if sc.scored_pairs != counters(res)[1]:
                raise AssertionError(f"--multihost: the scorer's kernels scored "
                                     f"{sc.scored_pairs} of {counters(res)[1]} pairs")
            phase("m", f"bench 10k --multihost{' MC2_DEVICE_COUNT=1' if env else ''} "
                       f"(one-rank NCCL group, world {sc.mesh.world}): signature == "
                       f"bench10k_ref_t1 ({len(got)} clusters), {want[2]} clusters before "
                       f"update, {want[3]} iterations; windows {counters(res)[0]}, pairs "
                       f"{counters(res)[1]} (the scorer-alone path's "
                       f"{want[0]} / {want[1]}); scorer pairs {sc.scored_pairs} (mixed "
                       f"batches halved to fit the unique-row bound: "
                       f"{sc.split_batches}), "
                       f"re-checked {sc.rechecked_pairs} by rule "
                       f"{sc.rechecked_by_rule.tolist()}; fetches {sc._fetch.calls} "
                       f"({sc._fetch.rows} rows); launches pair_stats_decision "
                       f"{launches[name]['pair_stats_decision']}, kmer_count "
                       f"{launches[name]['kmer_count']}; "
                       f"{window_parts(res.clock.stamps, 10_000)} (the scorer-alone "
                       f"path's {window_parts(path_stamps['no_device_loop_no_update_batch'], 10_000)}); {card}")
        mesh_functions_on_the_card(dev, weights, card)
        multihost_session_phase(torch_cli, wrappers, launches, weights, fasta, tmp, ref_sig,
                                path_stamps, mh_stamps["multihost"], card)
        graft_entry_phase(dev, card)
        shared = shared_card_phase(tmp, card)

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

        # (f4) the 10k set with the two full-vector models on the three paths,
        # one run a path
        full_model_phase("f4", torch_cli, fasta, 10_000, tmp, card, wrappers,
                         launches)

        # (f5) the 10k set with the markov and the plane model (their
        # committed weights): the scorer alone on the card, the signature
        # against the committed JAX --device host reference (too slow to run
        # here: its numpy oracle scores every pair)
        for name in ("markov", "plane"):
            with gzip.open(os.path.join(FIX, f"bench10k_{name}_ref.clstr.gz"),
                           "rb") as f, open(ref_path, "wb") as g:
                g.write(f.read())
            want_sig = signature(read_clstr(ref_path))
            res, out = plane_model_run(
                torch_cli, "f5", name, fasta,
                os.path.join(FIX, f"bench10k_{name}_weights.txt"), tmp, wrappers,
                launches)
            got = read_clstr(out)
            if signature(got) != want_sig:
                raise AssertionError(f"10k {name} model signature differs from "
                                     f"bench10k_{name}_ref ({len(got)} clusters)")
            if counters(res) != PLANE10K_COUNTERS[name]:
                raise AssertionError(f"10k {name} model counters {counters(res)} "
                                     f"!= {PLANE10K_COUNTERS[name]}")
            phase("f5", f"bench 10k, {name} model: signature == bench10k_{name}_ref "
                        f"({len(got)} clusters), counters {counters(res)} (the JAX "
                        f"--device host run's); "
                        f"{plane_line(res, 10_000, launches[f'f5_{name}'])}; {card}")

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
        check_launches("train", launches["train"])
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

        # (t2) --feat slow training on the 10k set: its tables from the host
        # oracle (the log divergences do not derive from the statistics),
        # held byte for byte against the JAX package's --device host
        # training of the same command
        port_ws = os.path.join(train_dir, "slow_weights.txt")
        host_ws = os.path.join(tmp, "host_slow_weights.txt")
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        res_s = torch_cli.run(["--device", "cuda", *TRAIN_SLOW_FLAGS, "--dump",
                               port_ws, fasta])
        port_s_wall = time.perf_counter() - t0
        launches["train_slow"] = {k: fn.launches for k, fn in wrappers.items()}
        if res_s.rc != 0:
            raise AssertionError(f"port --feat slow training exited {res_s.rc}")
        check_launches("train_slow", launches["train_slow"])
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "meshclust2_tpu.cli", "--device", "host",
             *TRAIN_SLOW_FLAGS, "--dump", host_ws, fasta],
            cwd=ROOT, capture_output=True, text=True, timeout=900)
        host_s_wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"host --feat slow training exited "
                                 f"{proc.returncode}:\n{proc.stderr[-2000:]}")
        with open(port_ws, "rb") as f, open(host_ws, "rb") as g:
            if f.read() != g.read():
                raise AssertionError("--feat slow weights differ from the JAX "
                                     "--device host training's")
        sw = load_weights(port_ws).classifier
        phase("t2", f"train 10k ({' '.join(TRAIN_SLOW_FLAGS)}): weights == JAX "
                    f"--device host --dump byte for byte; selected singles "
                    f"{[F.FEAT_NAMES[x] for x in sw.singles]}, combos {sw.combos}; "
                    f"tables on the host (launches {launches['train_slow']}); wall: "
                    f"port (in process) {port_s_wall:.3f} s, JAX {host_s_wall:.3f} s")

        # (fc) fastcar on the 10k set
        fc_record = fastcar_phase(fasta, tmp, card, wrappers, launches)

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
                    r"(pair_stats|closest_mean|window_step|layout|candidates|replay)"
                    r"_kernel(<[^>]*>)?",
                    name)] if m)
            top = "; ".join(f"{name[:48]} {us / 1e3:.1f} ms/{n_by_name[name]}"
                            for name, us in by_name.most_common(6))
            steps = res.accumulator.total_steps if res.accumulator else 0
            events = sum(n_by_name.values())
            fused = sum(n for name, n in n_by_name.items() if "pair_stats_kernel" in name)
            per_step = (f", {events / steps:.1f} a step, {fused} pair_stats_kernel "
                        f"launches") if steps else ""
            phase("h", f"torch.profiler, {path}, 10k: device busy {busy:.4f} s of "
                       f"a {wall:.3f} s profiled engine.run ({100 * busy / wall:.1f} "
                       f"% busy), {events} device events ({steps} accumulator "
                       f"steps{per_step}); the port's kernels (device time per "
                       f"launch): {ours}; top: {top}; {card}")
        # (h2) the phase alone, from the same state as (d6)
        profile_phase(ph10k, state10k, card)
        # (r2) the CLI's --profile on the default path
        profile_flag_phase(torch_cli, wrappers, launches, weights, fasta, tmp, ref_sig,
                           path_stamps["default"], card)
        # (r) Red, the JAX Red beside it as the reference
        red_phase(tmp, card)

    if any(m == "jax" or m.startswith(("jax.", "meshclust2_tpu."))
           or m == "meshclust2_tpu" for m in sys.modules):
        raise AssertionError("the port imported jax or the JAX package")
    k_ms, p_ms, b_ms, b_by = timing["pair"]
    # closest_mean at the main path's shape: the 10k update phase's largest
    # batch (f3)
    cm_real = real[0]
    ws_k, ws_p, ws_b, ws_by, ws_dev = step_timing[1_571, 9]
    # the fused kernel at the 10k mean window (the main path's launches) and
    # in the pair form
    dc, dp = dec_timing["center W=1571"], dec_timing["pair P=98304"]
    # the FULL kernel at the same shapes, the slow and the blockwise models
    fc_slow, fp_slow = (full_timing["slow", f] for f in ("center W=1571", "pair P=98304"))
    fc_block, fp_block = (full_timing["blockwise", f]
                          for f in ("center W=1571", "pair P=98304"))
    # the plane kernel and the PLANE instantiation at the same shapes, the
    # markov and the plane model
    pc_mk, pp_mk = (plane_timing["markov", f] for f in ("center W=1571", "pair P=98304"))
    pc_pl, pp_pl = (plane_timing["plane", f] for f in ("center W=1571", "pair P=98304"))
    # the phase's kernels at the 10k default path's state (d6): the layout,
    # the candidates, the replay
    pl, pc, pr, pcb = (phase_timing[k] for k in ("phase_layout", "closest_candidates",
                                                 "merge_replay", "closest_candidates_block"))
    # window_select at (d7)'s cases: the 10k default path's scan window and
    # seed, and the seeded 100k pool's
    ws, ws_seed, ws100k, ws100k_seed = (win_timing[k] for k in (
        "window 10k", "seed 10k", "window 100k", "seed 100k"))
    # launches: each record's path (training, then clustering with the
    # trained model; the last record: fastcar's search, at its largest
    # slice); library_ms: no PyTorch call computes any of these functions
    # (PERF.md) but the k-mer build's, bincount without the index sweep
    print(json.dumps({"kernels": [{
        "name": "pair_stats",
        "path": "training, then clustering, 10k",
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
        "name": "pair_stats_decision",
        "path": "training, then clustering, 10k",
        "multihost_launches": launches["multihost"]["pair_stats_decision"],
        "multihost_session_launches": launches["multihost_session"]["pair_stats_decision"],
        "route": "cuda",
        "source": "meshclust2_tpu_torch/csrc/pair_stats.cu",
        "replaces": "meshclust2_tpu/ops/pallas_stats.py:39, "
                    "meshclust2_tpu/cluster/device_loop.py:478, "
                    "meshclust2_tpu/cluster/device_loop.py:606, "
                    "meshclust2_tpu/cluster/device_update.py:159",
        "launches": launches["train"]["pair_stats_decision"],
        "max_abs_err": dec_err,
        "ms": dc["ms"],
        "plain_ms": dc["plain_ms"],
        "bound_ms": dc["bound_ms"],
        "bound_by": dc["bound_by"],
        "library_ms": None,
        "device_us": dc["device_us"],
        "pair_ms": dp["ms"],
        "pair_plain_ms": dp["plain_ms"],
        "pair_bound_ms": dp["bound_ms"],
        "pair_device_us": dp["device_us"],
    }, {
        "name": "pair_stats_decision (FULL)",
        "path": "the slow model on the 10k default path (f4)",
        "route": "cuda",
        "source": "meshclust2_tpu_torch/csrc/pair_stats.cu",
        "replaces": "meshclust2_tpu/cluster/device_loop.py:167, "
                    "meshclust2_tpu/cluster/device_loop.py:217",
        "launches": launches["f4_slow_default"]["pair_stats_decision_full"],
        "max_abs_err": full_err,
        "ms": fc_slow["ms"],
        "plain_ms": fc_slow["plain_ms"],
        "bound_ms": fc_slow["bound_ms"],
        "bound_by": fc_slow["bound_by"],
        "library_ms": None,
        "device_us": fc_slow["device_us"],
        "pair_ms": fp_slow["ms"],
        "pair_plain_ms": fp_slow["plain_ms"],
        "pair_bound_ms": fp_slow["bound_ms"],
        "pair_device_us": fp_slow["device_us"],
        "blockwise_launches": launches["f4_blockwise_default"]["pair_stats_decision_full"],
        "blockwise_device_us": fc_block["device_us"],
        "blockwise_bound_ms": fc_block["bound_ms"],
        "blockwise_pair_device_us": fp_block["device_us"],
        "blockwise_pair_bound_ms": fp_block["bound_ms"],
    }, {
        "name": "closest_mean",
        "path": "clustering, 10k, MC2_NO_DEVICE_LOOP=1 (f); timed on the default "
                "path's update batches (f3)",
        "route": "cuda",
        "source": "meshclust2_tpu_torch/csrc/closest_mean.cu",
        "replaces": "meshclust2_tpu/cluster/device_update.py:290",
        "launches": launches["no_device_loop"]["closest_mean"],
        "max_abs_err": cm_err,
        "ms": cm_real["ms"],
        "plain_ms": cm_real["plain_ms"],
        "bound_ms": cm_real["bound_ms"],
        "bound_by": cm_real["bound_by"],
        "library_ms": None,
        "device_us": cm_real["device_us"],
        "skewed_ms": cm_skew["ms"],
        "skewed_device_us": cm_skew["device_us"],
        "skewed_bound_ms": cm_skew["bound_ms"],
    }, {
        "name": "window_absorb",
        "path": "training, then clustering, 10k",
        "route": "cuda",
        "source": "meshclust2_tpu_torch/csrc/window_absorb.cu",
        "replaces": "meshclust2_tpu/cluster/device_loop.py:1074, "
                    "meshclust2_tpu/cluster/device_loop.py:1223",
        "launches": launches["train"]["window_absorb"],
        "max_abs_err": wa_err,
        "ms": ws_k,
        "plain_ms": ws_p,
        "bound_ms": ws_b,
        "bound_by": ws_by,
        "library_ms": None,
        "device_us": ws_dev,
        # the block mode (--multihost's session at 2 ranks, m6; m4): its
        # launches in m6's rank 0; timed at W = 1,571, 4 ranks' three
        # launches a step in one process, and the fused phase 2 alone
        "block_launches": shared["window_absorb_block"],
        "block_max_abs_err": step_block["max_abs_err"],
        "block_ms": step_block["ms"],
        "block_plain_ms": step_block["plain_ms"],
        "block_device_us": step_block["device_us"],
        "block_bound_ms": step_block["bound_ms"],
        "block_bound_by": step_block["bound_by"],
        "block_phase2_device_us": step_block["phase2_device_us"],
        "block_exchange_bytes": step_block["exchange_bytes"],
    }, {
        "name": "plane_singles",
        "path": "the markov model on the 10k set (f5)",
        "route": "cuda",
        "source": "meshclust2_tpu_torch/csrc/plane_singles.cu",
        "replaces": "meshclust2_tpu/ops/device_features.py:278, "
                    "meshclust2_tpu/ops/device_features.py:306, "
                    "meshclust2_tpu/ops/device_features.py:332, "
                    "meshclust2_tpu/ops/device_features.py:344, "
                    "meshclust2_tpu/ops/device_features.py:395",
        "launches": launches["f5_markov"]["plane_singles"],
        "max_abs_err": max([plane_err] + [t["err"] for t in plane_timing.values()]),
        "ms": pc_mk["ms"],
        "plain_ms": pc_mk["plain_ms"],
        "bound_ms": pc_mk["bound_ms"],
        "bound_by": pc_mk["bound_by"],
        "library_ms": None,
        "device_us": pc_mk["device_us"],
        "pair_ms": pp_mk["ms"],
        "pair_plain_ms": pp_mk["plain_ms"],
        "pair_bound_ms": pp_mk["bound_ms"],
        "pair_device_us": pp_mk["device_us"],
        "plane_launches": launches["f5_plane"]["plane_singles"],
        "plane_device_us": pc_pl["device_us"],
        "plane_bound_ms": pc_pl["bound_ms"],
        "plane_pair_device_us": pp_pl["device_us"],
        "plane_pair_bound_ms": pp_pl["bound_ms"],
    }, {
        "name": "pair_stats_decision (PLANE)",
        "path": "the markov model on the 10k set (f5)",
        "route": "cuda",
        "source": "meshclust2_tpu_torch/csrc/pair_stats.cu",
        "replaces": "meshclust2_tpu/ops/pallas_stats.py:39, "
                    "meshclust2_tpu/ops/device_features.py:483",
        "launches": launches["f5_markov"]["pair_stats_decision_plane"],
        "max_abs_err": plane_dec_err,
        "ms": pc_mk["dec_ms"],
        "plain_ms": pc_mk["dec_plain_ms"],
        "bound_ms": pc_mk["dec_bound_ms"],
        "bound_by": pc_mk["dec_bound_by"],
        "library_ms": None,
        "device_us": pc_mk["dec_device_us"],
        "pair_ms": pp_mk["dec_ms"],
        "pair_device_us": pp_mk["dec_device_us"],
        "pair_bound_ms": pp_mk["dec_bound_ms"],
    }, {
        "name": "phase_layout",
        "path": "clustering, 10k default path (f); timed at its state after "
                "accumulate (d6)",
        "route": "cuda",
        "source": "meshclust2_tpu_torch/csrc/phase.cu",
        "replaces": "meshclust2_tpu/cluster/device_phase.py:218, "
                    "meshclust2_tpu/cluster/device_phase.py:261, "
                    "meshclust2_tpu/cluster/device_phase.py:326",
        "launches": launches["default"]["phase_layout"],
        "max_abs_err": 0,
        "ms": pl["ms"],
        "plain_ms": pl["plain_ms"],
        "bound_ms": pl["bound_ms"],
        "bound_by": pl["bound_by"],
        "library_ms": None,
        "device_us": pl["device_us"],
        "wide_slots": pl["wide_slots"],
        "wide_device_us": pl["wide_device_us"],
    }, {
        "name": "closest_candidates",
        "path": "clustering, 10k default path (f); timed at its state after "
                "accumulate (d6)",
        "route": "cuda",
        "source": "meshclust2_tpu_torch/csrc/closest_mean.cu",
        "replaces": "meshclust2_tpu/cluster/device_update.py:290, "
                    "meshclust2_tpu/cluster/device_phase.py:462, "
                    "meshclust2_tpu/cluster/device_phase.py:551",
        "launches": launches["default"]["closest_candidates"],
        "max_abs_err": 0,
        "ms": pc["ms"],
        "plain_ms": pc["plain_ms"],
        "bound_ms": pc["bound_ms"],
        "bound_by": pc["bound_by"],
        "library_ms": None,
        "device_us": pc["device_us"],
        "closest_mean_device_us": pc["closest_mean_device_us"],
        # the block mode (--multihost's session at 2 ranks, m6; m4): its
        # launches in m6's rank 0; timed at (d6)'s state, 4 ranks' three
        # launches a pass in one process
        "block_launches": shared["closest_candidates_block"],
        "block_max_abs_err": pcb["max_abs_err"],
        "block_ms": pcb["ms"],
        "block_plain_ms": pcb["plain_ms"],
        "block_device_us": pcb["device_us"],
        "block_bound_ms": pcb["bound_ms"],
        "block_bound_by": pcb["bound_by"],
        "block_exchange_bytes": pcb["exchange_bytes"],
        "block_exchange_dtype": pcb["exchange_dtype"],
    }, {
        "name": "merge_replay",
        "path": "clustering, 10k default path (f); timed at its state after "
                "accumulate (d6)",
        "route": "cuda",
        "source": "meshclust2_tpu_torch/csrc/phase.cu",
        "replaces": "meshclust2_tpu/cluster/device_phase.py:528",
        "launches": launches["default"]["merge_replay"],
        "max_abs_err": 0,
        "ms": pr["ms"],
        "plain_ms": pr["plain_ms"],
        "bound_ms": pr["bound_ms"],
        "bound_by": pr["bound_by"],
        "library_ms": None,
        "device_us": pr["device_us"],
        "wide_slots": pr["wide_slots"],
        "wide_device_us": pr["wide_device_us"],
    }, {
        "name": "window_select",
        "path": "clustering, 10k default path (f); held and timed at its loop state "
                "before a scan window and a seed, and on a seeded 100k pool (d7)",
        "route": "cuda",
        "source": "meshclust2_tpu_torch/csrc/window_select.cu",
        "replaces": "meshclust2_tpu/cluster/device_loop.py:1358",
        "launches": launches["default"]["window_select"],
        "max_abs_err": 0,
        "ms": ws["ms"],
        "plain_ms": ws["plain_ms"],
        "bound_ms": ws["bound_ms"],
        "bound_by": ws["bound_by"],
        "library_ms": None,
        "device_us": ws["device_us"],
        "n": ws["n"],
        "W": ws["W"],
        "seed_ms": ws_seed["ms"],
        "seed_plain_ms": ws_seed["plain_ms"],
        "seed_device_us": ws_seed["device_us"],
        "seed_bound_ms": ws_seed["bound_ms"],
        "n_100k": ws100k["n"],
        "W_100k": ws100k["W"],
        "ms_100k": ws100k["ms"],
        "plain_ms_100k": ws100k["plain_ms"],
        "device_us_100k": ws100k["device_us"],
        "bound_ms_100k": ws100k["bound_ms"],
        "seed_ms_100k": ws100k_seed["ms"],
        "seed_plain_ms_100k": ws100k_seed["plain_ms"],
        "seed_device_us_100k": ws100k_seed["device_us"],
        "seed_bound_ms_100k": ws100k_seed["bound_ms"],
    }, {
        "name": "kmer_count",
        "path": "clustering, 10k default path with MC2_DEVICE_COUNT=1 (k2); timed "
                "on the 10k set's records (k)",
        "route": "cuda",
        "source": "meshclust2_tpu_torch/csrc/kmer_count.cu",
        "replaces": "meshclust2_tpu/parallel/mesh.py:200",
        "launches": launches["device_count"]["kmer_count"],
        "max_abs_err": kmer_timing["max_abs_err"],
        "ms": kmer_timing["ms"],
        "plain_ms": kmer_timing["plain_ms"],
        "bound_ms": kmer_timing["bound_ms"],
        "bound_by": kmer_timing["bound_by"],
        "library_ms": kmer_timing["library_ms"],
        "library": "torch.bincount over the windows' flat indices (no index sweep, "
                   "no saturation)",
        "device_us": kmer_timing["device_us"],
        "shapes": kmer_timing["shapes"],
        "multihost_launches": launches["multihost_device_count"]["kmer_count"],
        "setup_s": kmer_timing["setup"],
    }, fc_record]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
