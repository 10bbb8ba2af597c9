"""The accumulate phase's host-driven step loop: the accumulate parts
(read_in_points to accumulate) summed over the window's jobs, over their
accumulator steps summed."""
from metrics._jobs import cluster_jobs


def read(run):
    jobs = [j for j in cluster_jobs(run, ("read_in_points", "accumulate"))
            if j.counters.get("steps")]
    if not jobs:
        return None
    part = sum(j.stamps["accumulate"] - j.stamps["read_in_points"] for j in jobs)
    return 1e3 * part / sum(j.counters["steps"] for j in jobs)
