"""What the span metrics share: the records that the program's clock keeps
of its runs (`meshclust2_tpu_torch.utils.clock.FINISHED`: per span name its
total, count, self time and parent; under a profiler each
span's interval), matched to the harness's jobs by their start.  A program
that keeps no such records gives no reading."""
import importlib


def _finished():
    try:
        clock = importlib.import_module("meshclust2_tpu_torch.utils.clock")
    except ImportError:
        return []
    return list(getattr(clock, "FINISHED", ()))


def job_records(jobs):
    """[(job, its records)] for the jobs a run of the program started in."""
    finished = _finished()
    out = []
    for job in jobs:
        recs = [r for r in finished if job.start <= r.start_ns * 1e-9 <= job.end]
        if recs:
            out.append((job, recs))
    return out


def total_s(recs, names) -> float:
    """The spans `names` summed over the records, in seconds."""
    return 1e-9 * sum(r.spans[n][0] for r in recs for n in names if n in r.spans)


def mean_s(jobs, names):
    """The spans `names` summed a job, the mean over the jobs with records."""
    pairs = job_records(jobs)
    if not pairs:
        return None
    return sum(total_s(recs, names) for _, recs in pairs) / len(pairs)


def per_step_us(jobs, name):
    """Span `name` over the jobs' accumulator steps, in microseconds."""
    pairs = [(j, recs) for j, recs in job_records(jobs) if j.counters.get("steps")]
    if not pairs:
        return None
    return 1e6 * sum(total_s(recs, [name]) for _, recs in pairs) / \
        sum(j.counters["steps"] for j, _ in pairs)


def _union(spans):
    """The sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap_s(a, b) -> float:
    """The length of the intersection of two interval sets."""
    a, b = _union(a), _union(b)
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in(run, program, names):
    """The share of the traced jobs' wall time in which the card is in one
    of the trace's gaps (idle time between its first and last operation;
    before the first and after the last counts nowhere) and the host inside
    one of the spans `names`: the
    spans' intervals (monotonic ns) against the gaps (epoch seconds, moved
    to monotonic time by the run's epoch, as the breakdown moves them)."""
    if run.trace is None or not run.traced or \
            any(j.program != program for j in run.traced):
        return None
    host = [(t0 * 1e-9, t1 * 1e-9) for _, recs in job_records(run.traced)
            for r in recs for name, _, t0, t1 in r.intervals if name in names]
    if not host:
        return None
    gaps = [(s - run.epoch, e - run.epoch) for s, e, _ in run.trace.gaps]
    return 100 * overlap_s(host, gaps) / run.trace.window_s
