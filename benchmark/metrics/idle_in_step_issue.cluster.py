"""The share of the traced clustering jobs' wall time in which the card is
idle while the host issues a step's work (inside the spans
`accumulate.window`, `.scan` or `.seed`).  Only the idle time between the
card's first and last operation of the traced jobs counts (the trace's
gaps)."""
from metrics._spans import idle_in


def read(run):
    return idle_in(run, "cluster", ("accumulate.window", "accumulate.scan",
                                    "accumulate.seed"))
