"""pair_stats_decision's share of its roofline in the clustering jobs (the
step loop's center form and the phase's pair form)."""
from metrics._roofline import decision_share


def read(run):
    return decision_share(run, "cluster")
