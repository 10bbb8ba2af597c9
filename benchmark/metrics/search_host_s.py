"""fastcar's host stages in a search job: its search window less the
scoring (reading and counting the chunks, the pair arrays, the output
lines), the mean over the window's jobs."""
from metrics._jobs import mean, search_jobs


def read(run):
    return mean(j.counters["search_s"] - j.counters["score_s"]
                for j in search_jobs(run))
