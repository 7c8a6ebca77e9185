"""``bench/work.py``'s counts against hand counts at small shapes."""
from __future__ import annotations

import pytest

from bench import work


def test_exact_counts():
    n, d, k = 4, 3, 2
    dist = work.exact_distances(n, d, integer_points=False)
    assert dict(dist.ops) == {"tf32": 2 * 16 * 3} and dist.bytes == 4 * 4 * 3
    assert dict(work.exact_distances(n, d, True).ops) == {"int8": 96}
    prod = work.exact_product(n, k)
    assert dict(prod.ops) == {"tf32": 2 * 16 * 2} and prod.bytes == 3 * 4 * 4 * 2
    both = dist + prod
    assert dict(both.ops) == {"tf32": 96 + 64} and both.bytes == 48 + 96
    assert both.seconds() == pytest.approx(max(160 / 495e12, 144 / 3.35e12))


def test_vdt_counts():
    blocks = work.vdt_blocks(10)
    assert blocks.ops == () and blocks.bytes == 10 * 12
    cols = work.vdt_columns(n=8, n_blocks=10, columns=3)
    assert dict(cols.ops) == {"tf32": 2 * 10 * 3}
    assert cols.bytes == 3 * 4 * 8 * 3
    assert (2 * blocks).bytes == 240 and (blocks * 2).bytes == 240


def test_work_prices_each_peak():
    w = work.Work((("int8", 1979e12), ("tf32", 495e12)), 0.0)
    assert w.seconds() == pytest.approx(2.0)
    assert work.Work((), 3.35e12).seconds() == pytest.approx(1.0)
    assert (w + w).seconds() == pytest.approx(4.0)


@pytest.mark.parametrize("n,d", [(64, 8), (1000, 315)])
def test_pairs_bound_is_the_cheapest_mix(n, d):
    steps = 12
    c = work.exact_distances(n, d, True).seconds()
    b = n * n / work.HBM_BYTES_PER_S
    best = min(max(m * c, (steps - m) * b) for m in range(steps + 1))
    got = work.exact_pairs_seconds(n, d, True, steps)
    assert got <= best * (1 + 1e-12)
    assert got >= 0.5 * min(steps * c, steps * b) * (1 - 1e-12)
