"""Issuing the accumulate step's window operations (the span
`accumulate.window`: the bounds, masks, cumsums and scatter of
`TorchDeviceAccumulator._window_ops`, up to the step's read), over the
window's clustering jobs' accumulator steps, in microseconds."""
from metrics._jobs import cluster_jobs
from metrics._spans import per_step_us


def read(run):
    return per_step_us(cluster_jobs(run), "accumulate.window")
