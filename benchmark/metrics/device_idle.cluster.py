"""The card's idle share over the traced clustering jobs: 1 less the union
of its activity over their wall time."""
from metrics._roofline import idle_share


def read(run):
    return idle_share(run, "cluster")
