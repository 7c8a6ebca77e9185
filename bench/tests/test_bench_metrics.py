"""Metric readers on hand-made runs: what they count does not follow how
the program batches or launches its work."""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

from bench import work
from bench.layout import Layout
from bench.tests.conftest import REPO

LAYOUT = Layout(REPO)


def _record(t_done, width=1, ok=True):
    return SimpleNamespace(t_done=t_done, ok=ok,
                           spec=SimpleNamespace(width=width))


def _run(records, dispatches=0, n_iters=10, backend="exact", trace=None,
         seconds=30.0, n=1000, d=315):
    snap = lambda k: SimpleNamespace(dispatches=k)   # noqa: E731
    return SimpleNamespace(
        records=records, t_end=100.0 + seconds, seconds=seconds,
        before=snap(0), after=snap(dispatches), trace=trace, n=n, d=d,
        integer_points=True,
        cell=SimpleNamespace(mix={"n_iters": n_iters, "backend": backend}))


def test_requests_per_s_ends_at_the_last_answer_in_the_window():
    read = LAYOUT.module("metrics", "lp_requests_per_s").read
    lumps = [_record(100.0 + t) for t in (4.0, 10.0, 29.0) for _ in range(8)]
    late = [_record(131.0) for _ in range(8)]
    failed = [_record(20.0 + 100.0, ok=False)]
    assert read(_run(lumps + late + failed)) == pytest.approx(24 / 29.0)
    assert read(_run(late)) is None


class _Trace:
    """K1's launches in a trace: ``launches`` of ``each`` device seconds."""

    def __init__(self, launches, each):
        self.names = ["tf32x3::folded_lp_kernel<16>"] * launches
        self.each = each

    def select(self, pattern):
        return list(range(len(self.names)))

    def seconds(self, idx):
        return len(np.asarray(idx)) * self.each


@pytest.mark.parametrize("split", [1, 2, 4])
def test_k1_roofline_counts_iterations_not_launches(split):
    """A step cut into more launches, each a part of the time, reads the
    same share: the work is the dispatches' iterations'."""
    read = LAYOUT.module("metrics", "k1_roofline").read
    dispatches, n_iters, n, d = 3, 10, 1000, 315
    records = [_record(101.0, width=2) for _ in range(12)]
    trace = _Trace(dispatches * n_iters * split, 0.01 / split)
    got = read(_run(records, dispatches, n_iters, trace=trace, n=n, d=d))
    iters = dispatches * n_iters
    least = (iters * work.exact_distances(n, d, True)
             + 24 * n_iters * work.exact_product(n, 1)).seconds()
    assert got == pytest.approx(100.0 * least / (iters * 0.01))
