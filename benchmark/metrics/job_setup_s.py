"""A clustering job's set-up part: its call to the read_in_points stamp
(FASTA, counting, sorting, the session's upload and warm-up), the mean over
the window's jobs."""
from metrics._jobs import cluster_jobs, mean


def read(run):
    return mean(j.stamps["read_in_points"] - j.start
                for j in cluster_jobs(run, ("read_in_points",)))
