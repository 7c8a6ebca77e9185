"""Seeded data and traffic repeat exactly, and differ between seeds."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from bench import harness
from bench.layout import Layout
from bench.seeds import subseed
from bench.tests.conftest import REPO

BIG = 2**31 + 2**30 + 17       # the driver's seeds exceed 32 signed bits


def _points(name: str, seed: int) -> torch.Tensor:
    config = json.loads((REPO / f"bench/configs/{name}.json").read_text())
    config["data"].update(n=512, d=24)
    return harness.points(Layout(REPO), config, seed, "cpu")


@pytest.mark.parametrize("name", ["secstr", "alpha"])
def test_data_repeats(name):
    """One data set a configuration; the run's seed orders its rows."""
    a, b, c = _points(name, BIG), _points(name, BIG), _points(name, BIG + 1)
    assert a.shape == (512, 24) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    rows = lambda t: sorted(map(tuple, t.tolist()))
    assert rows(a) == rows(c)


def test_secstr_points_are_binary_at_the_stated_density():
    x = _points("secstr", 3)
    assert set(torch.unique(x).tolist()) <= {0.0, 1.0}
    assert 0.07 < float(x.mean()) < 0.13


def test_subseed_takes_large_seeds():
    assert subseed(BIG, "a") != subseed(BIG, "b") != subseed(BIG + 1, "a")
    assert 0 <= subseed(2**70, "labels") < 2**63


def test_traffic_repeats():
    """Every seed gets the same set of requests (gaps, widths, alphas,
    checks) in another order; the same seed the same order and labels."""
    layout = Layout(REPO)
    loop = layout.module("traffic", "open")
    mix = json.loads((REPO / "bench/traffic/vdt_r55.json").read_text())
    a, b = loop.Traffic(mix, 1000, BIG, 30.0), loop.Traffic(mix, 1000, BIG, 30.0)
    c = loop.Traffic(mix, 1000, BIG + 1, 30.0)
    assert len(a.specs) == 55 * 30 and a.specs == b.specs
    assert all(np.array_equal(a.labels(s), b.labels(s)) for s in a.specs[:5])
    assert a.specs != c.specs
    gaps = lambda t: sorted(np.diff([s.due for s in t.specs]).round(9))
    for key in ("width", "alpha", "check"):
        assert sorted(getattr(s, key) for s in a.specs) == \
            sorted(getattr(s, key) for s in c.specs)
    assert abs(a.specs[-1].due - 30.0) < 1.0 and a.specs[0].due == 0.0
    assert {s.width for s in a.specs} == set(mix["widths"])
    assert sum(s.check for s in a.specs) == -(-len(a.specs) // 8)
    y = a.labels(a.specs[0])
    assert y.shape == (1000, a.specs[0].width) and y.dtype == np.float32
    share = np.mean(np.concatenate([a.labels(s).ravel() for s in a.specs[:20]]))
    assert abs(share - mix["label_share"]) < 0.02
    assert len(gaps(a)) == len(a.specs) - 1
