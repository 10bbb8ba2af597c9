"""A clustering job's device session: the store's upload and the warm-up
of each batch (the span `setup.session`), the mean over the window's jobs."""
from metrics._jobs import cluster_jobs
from metrics._spans import mean_s


def read(run):
    return mean_s(cluster_jobs(run), ("setup.session",))
