"""One run of one cell: set-up, the measured window, the check, the line.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Set-up: the card is looked for (none, or fewer than the cell asks for: exit
2, no result); the cell's pools are written under $TMPDIR from the seed; one
warm job runs, which builds the port's kernels into its fixed build
directories in the checkout on the first run of a checkout.  The window:
jobs back to back, one client, each on the next pool, until `seconds` have
passed since the window opened; a job started in the window runs to its end,
and so does its cycle over the pools.
The window is the same with --trace 1, and its jobs give the program's
spans; after it closes, `trace_jobs` more jobs run under the profiler and
the launch recorder, for the metrics read from the device's trace.  Then
the check: for each pool the run used, the reference's answer, against
which every job on it is held.  The last line of standard output
is the result; standard error ends with a line a job (its time and what the
host did meanwhile) and then each number compared beside its limit.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import shutil
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass, field
from multiprocessing import get_context
from typing import Dict, List, Optional


from . import plan as P
from .jobs import Job, run_job
from .pools import write_pool

FORBIDDEN = {"jax", "jaxlib", "flax", "meshclust2_tpu"}


@dataclass
class Run:
    """What the metric readers read."""
    setup_s: float
    t_open: float
    jobs: List[Job]                        # the window's jobs, in order
    traced: List[Job] = field(default_factory=list)   # after the window
    trace: Optional[object] = None         # trace.DeviceTrace
    launches: Optional[object] = None      # trace.Launches
    epoch: float = 0.0                     # time.time() - time.monotonic()


def parse(argv):
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def cache_env(root: str) -> None:
    """Fixed cache directories inside the checkout; the port's own build
    directories (build/kernels, build/native) are fixed there already."""
    cache = os.path.join(root, "build", "bench-cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["MESHCLUST2_NOPROG"] = "1"


def main(argv, t0: float) -> int:
    args = parse(argv)
    import torch

    plan = P.load(args.workload)
    chips = plan.cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: this cell needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    return run_cell(plan, args, t0, "cuda")


def run_cell(plan: P.Plan, args, t0: float, device: str) -> int:
    """Everything after the look for the card, on `device`."""
    import torch

    cache_env(plan.root)
    work = tempfile.mkdtemp(prefix="mc2bench-")
    try:
        return _run(plan, args, t0, device, work, torch)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _pools(plan: P.Plan, seed: int, work: str) -> List[str]:
    n = plan.traffic["pools"]
    paths = [os.path.join(work, f"pool{j}.fasta") for j in range(n)]
    with ProcessPoolExecutor(max_workers=min(n, 4),
                             mp_context=get_context("spawn")) as ex:
        list(ex.map(write_pool, paths, [seed] * n, range(n),
                    [plan.traffic] * n))
    return paths


def _run(plan, args, t0, device, work, torch) -> int:
    traffic, config = plan.traffic, plan.config
    paths = _pools(plan, args.seed, work)
    n_seqs = (traffic["n_seqs"] // traffic["n_templates"]) * traffic["n_templates"]
    log = open(os.path.join(work, "program.log"), "w")
    weights = plan.path(config["weights"])

    def fields(pool: int, tag: str) -> dict:
        return dict(device=device, weights=weights, pool=paths[pool],
                    output=os.path.join(work, f"out-{tag}"))

    n_trace = traffic["trace_jobs"] if args.trace else 0
    sample = None
    if "sample" in config:
        from .sample import DecisionSample
        sample = DecisionSample(args.seed, **config["sample"])
    with contextlib.ExitStack() as stack:
        if sample is not None:
            stack.enter_context(sample.patched())   # sample.job None: idle
        warm = run_job(config, fields(0, "warm"), 0, n_seqs, log)
        if warm.error:
            print(f"benchmark: the warm job failed: {warm.error}", file=sys.stderr)
            log.close()
            with open(log.name) as f:
                sys.stderr.write(f.read()[-4000:])
            return 1
        _drop(warm)
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        epoch = time.time() - time.monotonic()
        t_open = time.monotonic()
        run = Run(setup_s=t_open - t0, t_open=t_open, jobs=[], epoch=epoch)
        # a job started in the window runs to its end, and so does the
        # cycle over the pools it belongs to: every pool weighs the same in
        # every run, however many cycles fit
        while time.monotonic() - t_open < args.seconds or len(run.jobs) % len(paths):
            i = len(run.jobs)
            if sample is not None:
                sample.job = i
            run.jobs.append(run_job(config, fields(i % len(paths), f"{i}"),
                                    i % len(paths), n_seqs, log, keep_rows=True))
        if sample is not None:
            sample.job = None
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        if n_trace:
            run.traced = _traced(run, config, fields, len(paths), n_trace,
                                 n_seqs, log, device, sample)
    log.close()
    found = forbidden_modules()
    if found:
        print(f"benchmark: the process holds {found} after the window",
              file=sys.stderr)
        return 3
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    metrics = {}
    for m in (plan.per_layer if args.trace else plan.end_to_end):
        value = m.read(run)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}

    judged = run.jobs + run.traced
    from .check import check
    numbers, rejected = check(plan, run, paths, sorted({j.pool for j in judged}),
                              device, sample.by_job() if sample is not None else {})
    for job in judged:
        _drop(job)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the process holds {found}", file=sys.stderr)
        return 3
    failed = sum(1 for j, job in enumerate(judged)
                 if job.error is not None or j in rejected)
    limits = config["limits"]
    correct = (failed == 0 and set(numbers) == set(limits)
               and all(numbers[k] <= limits[k] for k in numbers))
    for j, job in enumerate(judged):
        print(job_line(j, job, run), file=sys.stderr)
        if job.error:
            print(f"job on pool {job.pool} failed: {job.error}", file=sys.stderr)
    for k in sorted(numbers):
        print(f"check {k} {numbers[k]} limit {limits[k]}", file=sys.stderr)
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
           "count": plan.cell["chips"], "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": len(judged), "failed": failed,
           "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = breakdown(run)
    out["checked"] = {k: {"value": numbers[k], "limit": limits[k]}
                      for k in sorted(numbers)}
    print(json.dumps(out), flush=True)
    return 0


def _drop(job: Job) -> None:
    job.headers = job.counts = None


def job_line(j: int, job: Job, run: Run) -> str:
    """One job's time and what the host did meanwhile."""
    where = "traced" if j >= len(run.jobs) else "window"
    h = job.host
    steps = job.counters.get("steps", job.counters.get("pairs", 0))
    return (f"job {j} {where} pool {job.pool} s {job.end - job.start:.4f} "
            f"cpu_s {h.get('cpu_s', 0):.4f} gc_s {h.get('gc_s', 0):.4f} "
            f"waits {h.get('waits', 0)} preempted {h.get('preempted', 0)} "
            f"steps {steps}")


def _traced(run, config, fields, n_pools, n_trace, n_seqs, log, device,
            sample) -> List[Job]:
    """`n_trace` jobs after the window, on pools 0, 1, ..., under the
    profiler and the launch recorder; the trace is reduced after them."""
    from .trace import Launches, Profiled, recorded

    launches = Launches()
    jobs = []
    first = len(run.jobs)
    with recorded(launches), Profiled(device) as prof:
        for t in range(n_trace):
            if sample is not None:
                sample.job = first + t
            pool = t % n_pools
            jobs.append(run_job(config, fields(pool, f"t{t}"), pool, n_seqs,
                                log, keep_rows=True))
    launches.finish()
    run.trace, run.launches = prof.trace, launches
    return jobs


def _phase(job: Job, t: float) -> str:
    """The part of a job that monotonic time t falls in."""
    if job.program == "search":
        return "set-up" if t < job.end - job.counters.get("search_s", 0.0) else "search"
    for name, label in (("read_in_points", "set-up"),
                        ("accumulate", "accumulate"), ("update", "update")):
        if t < job.stamps.get(name, float("inf")):
            return label
    return "output"


def breakdown(run: Run) -> dict:
    """The device's top operations and its idle time by what the job was
    doing, ten of each."""
    tr = run.trace
    ops = sorted(tr.by_kernel.items(), key=lambda kv: -kv[1])[:10]
    idle: Dict[str, float] = {}
    for s, e, nxt in tr.gaps:
        mid = (s + e) / 2 - run.epoch
        job = next((j for j in run.traced if j.start <= mid <= j.end), None)
        label = f"{_phase(job, mid) if job else 'between jobs'} before {nxt}"
        idle[label] = idle.get(label, 0.0) + (e - s)
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}
