"""One job: the program's own entry point called in this process with the
argv a user gives, timed from the call to its return, and what the
benchmark reads from what it returns.

A configuration names its program (`cluster`: meshclust2_tpu_torch.cli.run,
`search`: meshclust2_tpu_torch.fastcar.run) and its argv, whose fields
{device}, {weights}, {pool} and {output} the harness fills in, and the
rest from the configuration's `options`, which the reference is given too.

Each job also keeps what the host did meanwhile (`Job.host`): the
process's CPU seconds, the garbage collector's pauses and the times the
process was switched out, waiting or preempted; the run prints them a job,
as the trail of what made two runs differ.
"""
from __future__ import annotations

import contextlib
import gc
import resource
import time
import traceback
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class Job:
    program: str
    pool: int
    n_seqs: int
    start: float                  # time.monotonic() at the call
    end: float = 0.0              # at its return
    output: str = ""              # the file the job is judged by
    error: Optional[str] = None
    stamps: Dict[str, float] = field(default_factory=dict)   # monotonic
    counters: Dict[str, float] = field(default_factory=dict)
    headers: Optional[List[str]] = None     # the program's rows, when kept
    counts: Optional[np.ndarray] = None     # and their histograms
    host: Dict[str, float] = field(default_factory=dict)


class _GcClock:
    """The garbage collector's pauses, summed (a gc.callbacks entry)."""

    def __init__(self):
        self.total = 0.0
        self._t = None

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.total += time.perf_counter() - self._t
            self._t = None


_GC = _GcClock()


def _host_now() -> tuple:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return time.process_time(), _GC.total, ru.ru_nvcsw, ru.ru_nivcsw


def _host_since(t0: tuple) -> Dict[str, float]:
    t1 = _host_now()
    return {"cpu_s": t1[0] - t0[0], "gc_s": t1[1] - t0[1],
            "waits": t1[2] - t0[2], "preempted": t1[3] - t0[3]}


def _cluster(argv: List[str], job: Job, keep_rows: bool) -> None:
    from meshclust2_tpu_torch import cli

    res = cli.run(argv)
    job.end = time.monotonic()
    if res.rc != 0:
        job.error = f"cli.run returned {res.rc}"
        return
    job.stamps = {k: res.clock.start + v for k, v in res.clock.stamps.items()}
    if res.accumulator is not None:
        job.counters["steps"] = res.accumulator.total_steps
    if res.phase is not None:
        job.counters["phase_iterations"] = res.phase.last_iterations
    if keep_rows:
        job.headers = list(res.engine.ps.headers)
        job.counts = res.engine.ps.counts


def _search(argv: List[str], job: Job, keep_rows: bool) -> None:
    from meshclust2_tpu_torch import fastcar

    res = fastcar.run(argv)
    job.end = time.monotonic()
    if res.rc != 0:
        job.error = f"fastcar.run returned {res.rc}"
        return
    st = res.stats
    job.counters.update(positives=res.positives, search_s=res.search_seconds,
                        pairs_s=st.pairs_seconds, score_s=st.score_seconds,
                        write_s=st.write_seconds, pairs=st.pairs)


PROGRAMS = {"cluster": (_cluster, "{output}"), "search": (_search, "{output}0")}


def run_job(config: dict, fields: dict, pool: int, n_seqs: int, log,
            keep_rows: bool = False) -> Job:
    """Run one job of the configuration on pool `pool` (fields: the argv's
    placeholders), the program's printing sent to `log`."""
    run, judged = PROGRAMS[config["program"]]
    fields = dict(config.get("options", {}), **fields)
    argv = [a.format(**fields) for a in config["argv"]]
    if _GC not in gc.callbacks:
        gc.callbacks.append(_GC)
    host = _host_now()
    job = Job(config["program"], pool, n_seqs, time.monotonic(),
              output=judged.format(**fields))
    with contextlib.redirect_stdout(log), contextlib.redirect_stderr(log):
        try:
            run(argv, job, keep_rows)
        except Exception as e:  # noqa: BLE001 - a job that raises is a failed job
            job.end = time.monotonic()
            job.error = f"{type(e).__name__}: {e}"
            traceback.print_exc(file=log)
    job.host = _host_since(host)
    return job
