"""A clustering job's update part (accumulate to update: the phase and the
CLSTR written), the mean over the window's jobs."""
from metrics._jobs import cluster_jobs, mean


def read(run):
    return mean(j.stamps["update"] - j.stamps["accumulate"]
                for j in cluster_jobs(run, ("accumulate", "update")))
