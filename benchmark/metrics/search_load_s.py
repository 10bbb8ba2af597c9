"""fastcar's chunks: reading and counting each chunk drawn from
`load_chunks` (the span `search.load`), the mean a search job of the window."""
from metrics._jobs import search_jobs
from metrics._spans import mean_s


def read(run):
    return mean_s(search_jobs(run), ("search.load",))
