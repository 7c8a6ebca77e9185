"""Device milliseconds of the window's kernels and fills (every device
operation but the staging and result copies) per LP iteration dispatched,
from the profiler's trace.  In a ``vdt`` cell every kernel belongs to a
``vdt`` scan."""
from bench.metrics._iters import dispatched_iters


def read(run):
    iters = dispatched_iters(run)
    if run.trace is None or not iters or run.cell.mix["backend"] != "vdt":
        return None
    kernels = run.trace.kernels()
    if not kernels:
        return None
    return run.trace.seconds(kernels) * 1e3 / iters
