"""Issuing the accumulate step's two hand-written kernels (the span
`accumulate.scan`: `pair_stats_decision` and `window_step`), over the
window's clustering jobs' accumulator steps, in microseconds."""
from metrics._jobs import cluster_jobs
from metrics._spans import per_step_us


def read(run):
    return per_step_us(cluster_jobs(run), "accumulate.scan")
