"""A kernel's share of its roofline over the traced jobs: the summed least
times of its launches (`_bounds.py`, from each launch's own arguments),
over the summed device time of its kernels in the profiler's trace."""
from metrics import _bounds as B


def decision_share(run, program):
    """pair_stats_decision's launches in the traced jobs of `program`."""
    if run.trace is None or not any(j.program == program for j in run.traced):
        return None
    calls = run.launches.calls.get("pair_stats_decision", [])
    if not calls or any(c["plane"] or set(c["singles"]) & B.VECTOR_OR_PLANE
                        for c in calls):
        return None
    least = sum(B.decision_bound(c["rows"], c["d"], c["elem"], c["p"], c["nb"],
                                 len(c["singles"]), c["combos"]) for c in calls)
    device = run.trace.by_kernel.get("pair_stats_kernel", 0.0)
    return 100 * least / device if device > 0 else None


def step_share(run):
    """window_step's launches in the traced jobs."""
    if run.trace is None:
        return None
    calls = run.launches.calls.get("window_step", [])
    if not calls:
        return None
    least = sum(B.step_bound(c["w"], c["npos"], c["mcnt"] + c["npos"], c["d"],
                             c["elem"]) for c in calls)
    device = run.trace.by_kernel.get("window_step_kernel", 0.0)
    return 100 * least / device if device > 0 else None


def idle_share(run, program):
    """The card's idle share of the traced jobs' wall time."""
    if run.trace is None or not run.traced or \
            any(j.program != program for j in run.traced):
        return None
    return 100 * (1 - run.trace.busy_s / run.trace.window_s)
