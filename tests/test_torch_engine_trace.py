"""The port engine's phase seconds, wait seconds, column counts and spans.

The engine times each phase of its dispatch cycle on its injectable clock
(``linger_s``, ``stage_s``, ``walk_s``, ``copy_out_s``, ``resolve_s``),
each request's wait (``queued_s``, ``blocked_s``) and the columns it walks
(``columns_real`` of ``columns_walked``), and opens a profiler span per
phase on the scheduler thread.  A fake clock that only the test's hooks
advance makes every second land exactly where the hook ran.
"""
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _serving_pair import FakeClock
from repro_torch import serving as t_serving
from repro_torch.core.vdt import VariationalDualTree
from test_torch_preempt import _InjectingVDT

PHASES = ("linger_s", "stage_s", "walk_s", "copy_out_s", "resolve_s")
WAIT_S = 60.0


@pytest.fixture(scope="module")
def vdt():
    x = np.random.RandomState(5).randn(24, 4).astype(np.float32)
    return VariationalDualTree.fit(x, max_blocks=4 * 24, device="cpu")


def _request(n, width, n_iters=2, **kw):
    y0 = np.zeros((n, width), np.float32)
    y0[: width + 1, :] = 1.0
    return t_serving.PropagateRequest(y0, alpha=0.05, n_iters=n_iters, **kw)


def _phase_sum(m) -> float:
    return sum(getattr(m, f) for f in PHASES)


class _HookedEngine(t_serving.PropagateEngine):
    """Advances the fake clock by fixed amounts inside the linger and scan
    hooks only."""

    LINGER_S, SCAN_S = 0.25, 0.5

    def _linger(self):
        self._clock.advance(self.LINGER_S)
        super()._linger()

    def _scan(self, *args, **kwargs):
        self._clock.advance(self.SCAN_S)
        return super()._scan(*args, **kwargs)


def test_linger_and_scan_hooks_land_in_linger_s_and_walk_s(vdt):
    clock = FakeClock()
    eng = _HookedEngine(vdt, clock=clock, max_wait_ms=5.0)
    try:
        for width in (1, 2, 3):
            fut = eng.submit(_request(vdt.tree.n_points, width))
            assert fut.result(timeout=WAIT_S).shape == (vdt.tree.n_points,
                                                        width)
    finally:
        eng.shutdown()
    m = eng.metrics()
    assert m.dispatches == 3 and m.scheduler_errors == 0
    assert m.linger_s == 3 * _HookedEngine.LINGER_S
    assert m.walk_s == 3 * _HookedEngine.SCAN_S
    assert m.stage_s == m.copy_out_s == m.resolve_s == 0.0
    assert _phase_sum(m) == clock()   # the scheduler's whole fake wall time


def test_columns_count_true_and_padded_widths(vdt):
    n = vdt.tree.n_points
    eng = t_serving.PropagateEngine(vdt, start=False, max_batch=4)
    # one drain, two groups: n_iters 2 (widths 1, 3, 2 -> 4 rows x 4
    # columns) and n_iters 3 (width 5 -> 1 row x 8 columns)
    futs = [eng.submit(_request(n, w, n_iters=i))
            for w, i in ((1, 2), (3, 2), (2, 2), (5, 3))]
    assert eng.step() == 4
    m = eng.metrics()
    assert (m.dispatches, m.columns_real, m.columns_walked) == (2, 11, 24)
    # a full batch (4 x 8) then a lone width 2 (1 x 2)
    futs += [eng.submit(_request(n, w)) for w in (8, 8, 1, 1, 2)]
    assert eng.flush() == 5
    m = eng.metrics()
    assert (m.dispatches, m.batched_requests) == (4, 9)
    assert (m.columns_real, m.columns_walked) == (11 + 18 + 2, 24 + 32 + 2)
    assert all(f.done() for f in futs)


def test_queued_and_blocked_seconds_add_up(vdt):
    """max_queue 1: a second sender blocks in ``submit`` until the first
    request is drained; its wait is in ``blocked_s`` and, since
    ``t_submit`` precedes the queue insert, in its ``queued_s`` too."""
    n = vdt.tree.n_points
    clock = FakeClock()
    sent = threading.Event()

    class Engine(t_serving.PropagateEngine):
        def _scan(self, *args, **kwargs):
            # the blocked sender returns before the walk moves the clock
            assert sent.wait(WAIT_S)
            clock.advance(0.5)
            return super()._scan(*args, **kwargs)

    eng = Engine(vdt, start=False, max_queue=1, clock=clock)
    first = eng.submit(_request(n, 1))          # t_submit 0
    putting = threading.Event()
    real_put = eng._queue.put

    def put(*args, **kwargs):
        putting.set()     # submit has read its clock: the wait starts at 0
        return real_put(*args, **kwargs)

    eng._queue.put = put
    second = {}

    def sender():
        second["fut"] = eng.submit(_request(n, 2))   # t_submit 0, blocks
        sent.set()

    thread = threading.Thread(target=sender)
    thread.start()
    assert putting.wait(WAIT_S)
    clock.advance(1.0)
    assert eng.step() == 1      # drains the first at t = 1, walks to 1.5
    thread.join(WAIT_S)
    assert not thread.is_alive()
    clock.advance(2.0)
    assert eng.step() == 1      # drains the second at t = 3.5
    assert first.done() and second["fut"].done()
    m = eng.metrics()
    assert m.blocked_s == 1.0
    assert m.queued_s == 1.0 + 3.5
    assert m.walk_s == 1.0 and m.stage_s == m.copy_out_s == 0.0
    assert m.latency_mean_ms == pytest.approx((1.5 + 4.0) / 2 * 1e3)


def test_preempted_walk_counts_no_second_twice(vdt):
    """A 20-iteration walk in segments of 5 yields to a 3-iteration urgent
    request: the walk's seconds are its own four segments plus the urgent
    dispatch's walk, each once."""
    clock = FakeClock()
    model = _InjectingVDT(vdt, clock, t_serving)
    eng = t_serving.PropagateEngine(model, start=False, policy="edf",
                                    segment_iters=5, backend="vdt",
                                    clock=clock)
    model.engine = eng
    bulk = eng.submit(_request(vdt.tree.n_points, 2, n_iters=20,
                               deadline_ms=60_000.0))
    eng.step()
    m = eng.metrics()
    assert m.preemptions >= 1 and m.completed == 2 and bulk.done()
    assert model.urgent.done()
    assert m.dispatches == 2
    assert m.walk_s == pytest.approx(_InjectingVDT.ITER_S * (20 + 3),
                                     rel=1e-12)
    assert _phase_sum(m) == pytest.approx(clock(), rel=1e-12)


def _events_by_name(prof) -> dict:
    out: dict = {}
    for ev in prof.events():
        out.setdefault(ev.name, []).append(ev)
    return out


def _ancestors(ev) -> list:
    names = []
    while ev.cpu_parent is not None:
        ev = ev.cpu_parent
        names.append(ev.name)
    return names


def _assert_nesting(by) -> None:
    for phase in ("stage", "walk", "copy_out", "resolve"):
        assert by[f"engine.{phase}"], phase
        for ev in by[f"engine.{phase}"]:
            assert _ancestors(ev)[0] == "engine.dispatch", phase
    for name in ("lp.fold", "lp.walk", "lp.unfold", "lp.exact"):
        assert by[name], name
        for ev in by[name]:
            assert _ancestors(ev)[:2] == ["engine.walk", "engine.dispatch"]


def _submit_mix(eng, n) -> list:
    """Three vdt requests and an exact one, 3 iterations each."""
    futs = [eng.submit(_request(n, w, n_iters=3)) for w in (1, 3, 2)]
    futs.append(eng.submit(_request(n, 2, n_iters=3, backend="exact")))
    return futs


def test_spans_nest_on_the_scheduler_thread_under_an_all_thread_profiler(vdt):
    """The scheduler thread starts before the profiler, as it does in a
    served deployment; profiled with ``profile_all_threads``, its spans nest
    as documented, all on that thread.  On the real clock the phases add up
    to no more than the engine's lifetime."""
    n = vdt.tree.n_points
    t0 = time.perf_counter()
    eng = t_serving.PropagateEngine(vdt, max_batch=4, max_wait_ms=2.0)
    cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=cfg) as prof:
        with torch.profiler.record_function("test.sender"):
            torch.ones(1)
        for f in _submit_mix(eng, n):
            f.result(timeout=WAIT_S)
    eng.shutdown()
    wall = time.perf_counter() - t0
    m = eng.metrics()
    assert all(getattr(m, f) > 0 for f in PHASES)
    assert _phase_sum(m) <= wall

    by = _events_by_name(prof)
    _assert_nesting(by)
    assert by["engine.linger"]
    for ev in by["engine.linger"]:
        assert _ancestors(ev) == []
    (sender,) = {ev.thread for ev in by["test.sender"]}
    threads = {ev.thread for name, evs in by.items()
               if name.startswith(("engine.", "lp.")) for ev in evs}
    assert len(threads) == 1 and sender not in threads


def test_spans_carry_the_dispatch_number_seqs_iterations_and_width(vdt):
    """Keyword values reach a profiler that records inputs on the thread
    that dispatches (``step`` driven by the profiling thread)."""
    n = vdt.tree.n_points
    eng = t_serving.PropagateEngine(vdt, start=False, max_batch=2)
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        futs = _submit_mix(eng, n)
        eng.flush()
    assert all(f.done() for f in futs)
    by = _events_by_name(prof)
    _assert_nesting(by)
    dispatches = sorted(by["engine.dispatch"],
                        key=lambda ev: ev.kwinputs["dispatch"])
    assert [ev.kwinputs["dispatch"] for ev in dispatches] == [1, 2]
    assert [ev.kwinputs["seqs"] for ev in dispatches] == ["0,1", "2,3"]
    for name in ("lp.fold", "lp.walk", "lp.unfold", "lp.exact"):
        assert all(ev.kwinputs["n_iters"] == 3 for ev in by[name])
    # folded widths: (1, 3) -> 2 x 4; (2) -> 1 x 2 on vdt, (2) -> 1 x 2 exact
    assert sorted(ev.kwinputs["width"] for ev in by["lp.walk"]) == [2, 8]
    assert [ev.kwinputs["width"] for ev in by["lp.exact"]] == [2]
    assert eng.metrics().columns_walked == 8 + 2 + 2
