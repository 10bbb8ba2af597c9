"""The share of the traced search jobs' wall time in which the card is idle
while the host is in one of fastcar's host stages (inside the spans
`search.load`, `.pairs`, `.write` or `.recheck`).  Only the idle time
between the card's first and last operation of the traced jobs counts (the
trace's gaps): the first job's load before the card's first operation and
the last job's write after its last one are left out."""
from metrics._spans import idle_in


def read(run):
    return idle_in(run, "search", ("search.load", "search.pairs", "search.write",
                                   "search.recheck"))
