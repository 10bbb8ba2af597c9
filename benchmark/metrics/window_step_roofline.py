"""window_step's share of its roofline in the clustering jobs."""
from metrics._roofline import step_share


def read(run):
    return step_share(run)
