"""Queries searched a second: every search job started in the window (each
query one sequence of the pool, against the whole pool), over the window's
opening to the last one's end."""
from metrics._jobs import rate


def read(run):
    return rate(run, "search")
