"""The accumulate part's host work outside the steps: the carry's upload,
the final read and `consume`, the host's resolution of aborted steps (the
spans `accumulate.upload`, `.consume`, `.resolve`), the mean a clustering
job of the window."""
from metrics._jobs import cluster_jobs
from metrics._spans import mean_s


def read(run):
    return mean_s(cluster_jobs(run), ("accumulate.upload", "accumulate.consume",
                                      "accumulate.resolve"))
