"""What the metric readers share: the window's jobs of a program, their
rate and means."""


def rate(run, program):
    """The sequences of every job of `program` started in the window, over
    the time from the window's opening to the last of them ending."""
    jobs = [j for j in run.jobs if j.program == program]
    if not jobs:
        return None
    return sum(j.n_seqs for j in jobs) / (max(j.end for j in jobs) - run.t_open)


def mean(values):
    values = list(values)
    return sum(values) / len(values) if values else None


def cluster_jobs(run, stamps=()):
    """The window's clustering jobs that ran to their end with the stamps."""
    return [j for j in run.jobs if j.program == "cluster" and j.error is None
            and all(s in j.stamps for s in stamps)]


def search_jobs(run):
    return [j for j in run.jobs if j.program == "search" and j.error is None]
