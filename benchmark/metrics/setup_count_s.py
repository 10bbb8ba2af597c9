"""A clustering job's FASTA reading, k-mer counting and sort (the spans
`setup.read`, `setup.count`), the mean over the window's jobs."""
from metrics._jobs import cluster_jobs
from metrics._spans import mean_s


def read(run):
    return mean_s(cluster_jobs(run), ("setup.read", "setup.count"))
