"""Seeding the next cluster in a step whose window holds no candidate (the
span `accumulate.seed`: the pool's first alive row found and moved into
the open cluster on the card), over the window's clustering jobs'
accumulator steps, in microseconds."""
from metrics._jobs import cluster_jobs
from metrics._spans import per_step_us


def read(run):
    return per_step_us(cluster_jobs(run), "accumulate.seed")
