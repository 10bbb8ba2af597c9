"""The accumulate step's one read, the host's wait on the card (the
span `accumulate.read`), over the window's clustering jobs' accumulator
steps, in microseconds."""
from metrics._jobs import cluster_jobs
from metrics._spans import per_step_us


def read(run):
    return per_step_us(cluster_jobs(run), "accumulate.read")
