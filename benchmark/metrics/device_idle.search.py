"""The card's idle share over the traced search jobs."""
from metrics._roofline import idle_share


def read(run):
    return idle_share(run, "search")
