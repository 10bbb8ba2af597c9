"""pair_stats_decision's share of its roofline in the search jobs (the pair
form on slices of up to 2^24 pairs)."""
from metrics._roofline import decision_share


def read(run):
    return decision_share(run, "search")
