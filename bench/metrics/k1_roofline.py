"""K1's share of its roofline, in %: the least time of the exact step's
work in the window over K1's device time in the trace (its split pass and
main kernel).  The work is counted from the algorithm, not from K1's
launches: each LP iteration dispatched (``_iters.py``) computes the N^2
distances from the points (``bench/work.py``), and each real request column
``P @ Y`` once an iteration."""
from bench import work
from bench.metrics._iters import dispatched_iters

KERNELS = r"folded_lp_kernel|split_kernel"


def read(run):
    iters = dispatched_iters(run)
    if run.trace is None or not iters or run.cell.mix["backend"] != "exact":
        return None
    k1_s = run.trace.seconds(run.trace.select(KERNELS))
    if k1_s <= 0:
        return None
    columns = sum(r.spec.width for r in run.records if r.ok) \
        * int(run.cell.mix["n_iters"])
    total = iters * work.exact_distances(run.n, run.d, run.integer_points) \
        + columns * work.exact_product(run.n, 1)
    return 100.0 * total.seconds() / k1_s
