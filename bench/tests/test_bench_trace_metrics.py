"""The readers of the engine's phase seconds, wait seconds and column
counts on hand-made snapshots, and on snapshots of a program that has none
of those fields."""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from bench.layout import Layout
from bench.tests.conftest import REPO

LAYOUT = Layout(REPO)
NEW = ("engine.queue_wait_ms", "engine.serial_ms", "lp.column_fill")


def _snap(**fields):
    base = dict(dispatches=0, batched_requests=0, stage_s=0.0, walk_s=0.0,
                copy_out_s=0.0, resolve_s=0.0, queued_s=0.0,
                columns_real=0, columns_walked=0)
    base.update(fields)
    return SimpleNamespace(**base)


def _run(before, after):
    return SimpleNamespace(before=before, after=after)


def _read(stem, suffix, run):
    return LAYOUT.module("metrics", f"{stem}.{suffix}").read(run)


@pytest.mark.parametrize("suffix", ["tail", "rate"])
def test_readers_take_window_deltas(suffix):
    before = _snap(dispatches=10, batched_requests=100, stage_s=1.0,
                   walk_s=50.0, copy_out_s=0.5, resolve_s=0.25,
                   queued_s=20.0, columns_real=300, columns_walked=1000)
    after = _snap(dispatches=14, batched_requests=180, stage_s=1.2,
                  walk_s=90.0, copy_out_s=0.7, resolve_s=0.29,
                  queued_s=36.0, columns_real=500, columns_walked=1512)
    run = _run(before, after)
    # 16 s of waiting over 80 requests; 0.44 s over 4 dispatches (the
    # walk's 40 s are not serial host work); 200 of 512 columns
    assert _read("engine.queue_wait_ms", suffix, run) == pytest.approx(200.0)
    assert _read("engine.serial_ms", suffix, run) == pytest.approx(110.0)
    assert _read("lp.column_fill", suffix, run) == pytest.approx(
        100.0 * 200 / 512)


@pytest.mark.parametrize("stem", NEW)
def test_readers_return_none_on_a_program_without_the_fields(stem):
    """A program whose ``MetricsSnapshot`` has only the reference's
    counters."""
    before = SimpleNamespace(dispatches=1, batched_requests=8)
    after = SimpleNamespace(dispatches=5, batched_requests=40)
    for suffix in ("tail", "rate"):
        assert _read(stem, suffix, _run(before, after)) is None


@pytest.mark.parametrize("stem", NEW)
def test_readers_return_none_on_an_idle_window(stem):
    snap = _snap(dispatches=3, batched_requests=9, queued_s=1.0,
                 columns_real=9, columns_walked=24)
    assert _read(stem, "tail", _run(snap, snap)) is None


def test_new_metrics_are_declared_for_the_three_cells():
    spec = {m["name"]: m for m in LAYOUT.spec["per_layer"]}
    cells = ["secstr.vdt_r55", "alpha.vdt_r40", "secstr.exact_r20"]
    for stem in NEW:
        assert f"{stem}.tail" not in spec
        assert spec[f"{stem}.rate"]["workloads"] == cells
        assert spec[f"{stem}.rate"]["moves"] == "lp_requests_per_s"
    for w in cells:
        names = {m["name"] for m in LAYOUT.cell(w).per_layer}
        assert {f"{stem}.rate" for stem in NEW} <= names


@pytest.mark.parametrize("workload", ["tiny.vdt", "tiny.exact"])
def test_a_traced_tiny_run_reads_every_new_metric(tiny_runs, workload):
    result, _ = tiny_runs[(workload, True)]
    got = result["metrics"]
    for stem in NEW:
        assert f"{stem}.rate" in got, stem
    assert 0.0 < got["lp.column_fill.rate"]["value"] <= 100.0
    assert got["engine.serial_ms.rate"]["value"] > 0.0
    assert got["engine.queue_wait_ms.rate"]["value"] > 0.0
