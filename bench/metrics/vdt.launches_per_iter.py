"""Kernel and fill launches of the window per LP iteration dispatched, from
the profiler's trace (a ``vdt`` cell's scans launch every kernel)."""
from bench.metrics._iters import dispatched_iters


def read(run):
    iters = dispatched_iters(run)
    if run.trace is None or not iters or run.cell.mix["backend"] != "vdt":
        return None
    kernels = len(run.trace.kernels())
    return kernels / iters if kernels else None
