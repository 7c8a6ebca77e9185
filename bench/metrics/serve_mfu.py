"""The whole serving step's share of the chip's peak, in %: the least time
of all LP work answered in the traced window (``bench/work.py``, summed per
dispatch and per request column), over the window's wall seconds.

``exact``: ``P @ Y`` over the real columns, and each dispatched iteration's
N^2 transition entries computed or read back, whichever mix is cheapest.
``vdt``: each dispatched iteration's block list, and per real column the
block products and the labels read and written.
"""
from bench import work
from bench.metrics._iters import dispatched_iters


def read(run):
    iters = dispatched_iters(run)
    if run.trace is None or not iters or run.trace.busy_s <= 0:
        return None
    columns = sum(r.spec.width for r in run.records if r.ok) \
        * int(run.cell.mix["n_iters"])
    backend = run.cell.mix["backend"]
    if backend == "exact":
        least = max((columns * work.exact_product(run.n, 1)).seconds(),
                    work.exact_pairs_seconds(run.n, run.d,
                                             run.integer_points, iters))
    elif backend == "vdt":
        least = (iters * work.vdt_blocks(run.n_blocks)
                 + columns * work.vdt_columns(run.n, run.n_blocks, 1)
                 ).seconds()
    else:
        return None
    return 100.0 * least / run.trace.window_s
