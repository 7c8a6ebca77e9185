"""The port's queue disciplines and scheduler against the reference's.

The queues get the same hand-built entries on a fake clock and must drain,
cancel and expire them in the same order; the engines (``start=False``, a
fake clock each, the same seeded requests) must make the same dispatches,
resolve the same futures the same way, choose the same linger windows and
count the same metrics under ``fifo``, ``priority`` and ``edf``.
"""
from concurrent.futures import Future

import numpy as np
import pytest

from _serving_pair import (FakeClock, Pair, assert_metrics_equal,
                           assert_outcomes_close, assert_same_decisions)
from repro import serving as r_serving
from repro.serving import _queue as r_queue
from repro_torch import serving as t_serving
from repro_torch.serving import _queue as t_queue

DISCIPLINES = ("fifo", "priority", "edf")


def _fixture(request, name="small_fitted_vdt"):
    return request.getfixturevalue(name)[-1]


def _drive_queue(mod, discipline, seed):
    """Seeded puts, cancels, clock steps and partial drains on one queue;
    returns every drain's (live, cancelled, expired) sequence numbers."""
    rng = np.random.RandomState(seed)
    clock = FakeClock()
    q = mod.RequestQueue(64, discipline=discipline, aging_s=0.05,
                         clock=clock)
    futures, trace = [], []
    for seq in range(40):
        deadline = None if rng.rand() < 0.3 else clock() + rng.rand() * 0.2
        fut = Future()
        futures.append(fut)
        q.put(mod.QueueEntry(seq=seq, request=None, future=fut,
                             t_submit=clock(),
                             priority=int(rng.randint(0, 4)),
                             t_deadline=deadline))
        clock.advance(float(rng.rand()) * 0.02)
        if rng.rand() < 0.15:
            futures[int(rng.randint(0, seq + 1))].cancel()
        if rng.rand() < 0.3:
            live, cancelled, expired = q.drain(int(rng.randint(1, 5)))
            trace.append(([e.seq for e in live], [e.seq for e in cancelled],
                          [e.seq for e in expired], q.popped, len(q),
                          q.next_deadline()))
    while len(q):
        live, cancelled, expired = q.drain(3)
        trace.append(([e.seq for e in live], [e.seq for e in cancelled],
                      [e.seq for e in expired], q.popped, len(q)))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("discipline", DISCIPLINES)
def test_queue_drain_order_matches_reference(discipline, seed):
    assert _drive_queue(t_queue, discipline, seed) == \
        _drive_queue(r_queue, discipline, seed)


def test_queue_config_errors_match_reference():
    assert t_queue.DISCIPLINES == r_queue.DISCIPLINES
    assert t_queue.DEFAULT_AGING_S == r_queue.DEFAULT_AGING_S
    for kw in (dict(maxsize=4, discipline="lifo"), dict(maxsize=0),
               dict(maxsize=4, aging_s=0.0)):
        msgs = []
        for mod in (r_queue, t_queue):
            with pytest.raises(ValueError) as err:
                mod.RequestQueue(**kw)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


def _same_engine_run(pair, futs):
    assert_outcomes_close([f[0] for f in futs], [f[1] for f in futs])
    assert_same_decisions(pair)
    assert_metrics_equal(*pair.call("metrics"))


def _y0(n, seed=22):
    return (np.random.RandomState(seed).rand(n, 2) > 0.8).astype(np.float32)


def test_priority_policy_matches_reference(request):
    ref = _fixture(request)
    y0 = _y0(ref.tree.n_points)
    pair = Pair.build(ref, policy="priority", max_batch=2)
    futs = [pair.submit(y0=y0, n_iters=4, priority=p)
            for p in (0, 0, 0, 5, 0, 5)]
    pair.call("step")
    assert [f[1].done() for f in futs] == [f[0].done() for f in futs] == \
        [False, False, False, True, False, True]
    pair.call("flush")
    _same_engine_run(pair, futs)


def test_priority_aging_matches_reference(request):
    ref = _fixture(request)
    y0 = _y0(ref.tree.n_points, 23)
    pair = Pair.build(ref, policy="priority", max_batch=1, aging_ms=100.0)
    old_low = pair.submit(y0=y0, n_iters=4, priority=0)
    pair.advance(0.35)
    fresh_high = pair.submit(y0=y0, n_iters=4, priority=3)
    pair.call("step")
    assert old_low[1].done() and not fresh_high[1].done()
    pair.call("flush")
    _same_engine_run(pair, [old_low, fresh_high])


def test_edf_policy_orders_and_fast_fails_like_reference(request):
    ref = _fixture(request)
    y0 = _y0(ref.tree.n_points, 24)
    pair = Pair.build(ref, policy="edf", max_batch=1)
    futs = [pair.submit(y0=y0, n_iters=4, deadline_ms=50.0),
            pair.submit(y0=y0, n_iters=4, deadline_ms=5000.0),
            pair.submit(y0=y0, n_iters=4)]
    pair.call("step")
    pair.advance(10.0)
    pair.call("flush")
    _same_engine_run(pair, futs)
    m = pair.port.metrics()
    assert (m.expired, m.completed, m.failed) == (1, 2, 0)


def test_late_completions_counted_like_reference(request):
    ref = _fixture(request)
    y0 = _y0(ref.tree.n_points, 25)
    pair = Pair.build(ref, policy="fifo")
    futs = [pair.submit(y0=y0, n_iters=4, deadline_ms=10.0)]
    pair.advance(1.0)
    pair.call("flush")
    _same_engine_run(pair, futs)
    assert pair.port.metrics().deadline_missed == 1


@pytest.mark.parametrize("policy", DISCIPLINES)
def test_mixed_traffic_decisions_match_reference(request, policy):
    """Priorities, deadlines, backends and iteration counts together, with
    the clock stepping between arrivals and partial service."""
    ref = _fixture(request)
    n = ref.tree.n_points
    rng = np.random.RandomState(26)
    pair = Pair.build(ref, policy=policy, max_batch=3, aging_ms=50.0)
    futs = []
    for i in range(10):
        fields = dict(y0=(rng.rand(n, int(rng.choice((1, 2, 3)))) > 0.7)
                      .astype(np.float32),
                      alpha=float(rng.choice((0.01, 0.2))),
                      n_iters=int(rng.choice((4, 6))),
                      priority=int(rng.randint(0, 3)),
                      backend=str(rng.choice(("vdt", "exact"))))
        if rng.rand() < 0.6:
            fields["deadline_ms"] = float(rng.choice((5.0, 40.0, 400.0)))
        futs.append(pair.submit(**fields))
        pair.advance(0.004)
        if i % 4 == 3:
            pair.call("step")
    pair.advance(0.02)
    pair.call("flush")
    _same_engine_run(pair, futs)


def test_adaptive_linger_matches_reference(request):
    ref = _fixture(request)
    y0 = np.zeros((ref.tree.n_points, 1), np.float32)
    pair = Pair.build(ref, max_batch=4, max_wait_ms=50.0)
    windows = [pair.call("_linger_window_s")]
    for gaps in ((0.002,) * 8, (0.002,), (10.0,) * 3):
        for gap in gaps:
            pair.advance(gap)
            pair.submit(y0=y0, n_iters=2)
            windows.append(pair.call("_linger_window_s"))
        pair.call("flush")
    for r, p in windows:
        assert p == pytest.approx(r, rel=1e-12, abs=1e-15)
    assert pair.port._ewma_gap_s == pytest.approx(pair.ref._ewma_gap_s)
    r_m, p_m = pair.call("metrics")
    assert p_m.linger_window_ms == pytest.approx(r_m.linger_window_ms)
    assert_metrics_equal(r_m, p_m)


@pytest.mark.parametrize("adaptive", [True, False])
def test_linger_window_under_deadlines_matches_reference(request, adaptive):
    ref = _fixture(request)
    y0 = np.zeros((ref.tree.n_points, 1), np.float32)
    pair = Pair.build(ref, policy="edf", max_batch=8, max_wait_ms=100.0,
                      adaptive_linger=adaptive)
    pair.submit(y0=y0, n_iters=2, deadline_ms=20.0)
    for dt in (0.0, 0.015, 0.004):
        pair.advance(dt)
        r, p = pair.call("_linger_window_s")
        assert p == pytest.approx(r)
    pair.call("flush")


def test_linger_mid_window_arrival_matches_reference(request, monkeypatch):
    """The linger loop re-reads the nearest deadline every wait: both
    engines end it after the same number of waits."""
    ref = _fixture(request)
    y0 = np.zeros((ref.tree.n_points, 1), np.float32)
    pair = Pair.build(ref, policy="edf", max_batch=64, max_wait_ms=1000.0)
    pair.submit(y0=y0, n_iters=2)
    waits = {}
    for name, eng, clock, mod in (
            ("ref", pair.ref, pair.ref_clock, r_serving),
            ("port", pair.port, pair.port_clock, t_serving)):
        calls = waits.setdefault(name, [])

        def wait_and_arrive(n, timeout=None, eng=eng, clock=clock, mod=mod,
                            calls=calls):
            # every wait sees 5 ms pass and one arrival; the first arrival
            # has a 10 ms deadline
            calls.append(timeout)
            clock.advance(0.005)
            eng.submit(mod.PropagateRequest(
                y0, n_iters=2, deadline_ms=10.0 if len(calls) == 1 else None))
            return False

        monkeypatch.setattr(eng._queue, "wait_atleast", wait_and_arrive)
        eng._linger()
    assert waits["port"] == pytest.approx(waits["ref"])
    assert len(waits["port"]) <= 4
    pair.call("flush")
    assert_metrics_equal(*pair.call("metrics"))
