"""Sequences clustered a second: every clustering job started in the
window, over the window's opening to the last one's end."""
from metrics._jobs import rate


def read(run):
    return rate(run, "cluster")
