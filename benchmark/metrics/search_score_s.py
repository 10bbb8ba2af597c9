"""A search job's scoring (the card and the host's re-checks), the mean over
the window's jobs."""
from metrics._jobs import mean, search_jobs


def read(run):
    return mean(j.counters["score_s"] for j in search_jobs(run))
