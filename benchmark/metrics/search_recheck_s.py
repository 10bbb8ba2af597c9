"""The device search's host re-checks of pairs near a decision edge or a
printed digit (the span `search.recheck`), the mean a search job of the
window."""
from metrics._jobs import search_jobs
from metrics._spans import mean_s


def read(run):
    return mean_s(search_jobs(run), ("search.recheck",))
