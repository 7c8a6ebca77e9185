"""The port's preemptible segmented dispatch against the reference's.

A proxy model advances the fake clock per dispatch and submits an urgent
request after the first segment of a long scan, reproducibly, to both
engines: the same yields, the same urgent service, the same counters.
Within the port, a segmented walk equals the monolithic one bit for bit on
the vdt and exact backends, and grf dispatches stay monolithic.
"""
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from _serving_pair import (FakeClock, Pair, PortEngine, RefEngine,
                           assert_metrics_equal, assert_outcomes_close,
                           assert_same_decisions)
from repro import serving as r_serving
from repro.serving import _queue as r_queue
from repro_torch import serving as t_serving
from repro_torch.serving import _queue as t_queue
from test_torch_fit import port_of

BULK_ITERS, SEG = 20, 5


def _fixture(request, name="small_fitted_vdt"):
    return request.getfixturevalue(name)[-1]


class _InjectingVDT:
    """Proxy model: advances a fake clock per dispatch (so per-iteration time
    is measurable and deterministic) and submits an urgent request after the
    first resumed segment — a mid-flight arrival, reproducibly."""

    ITER_S = 0.01  # simulated device seconds per LP iteration

    def __init__(self, inner, clock, mod):
        self._inner, self._clock, self._mod = inner, clock, mod
        self.engine = None
        self.urgent = None
        self.done_t: dict = {}

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def label_propagate(self, y0, *args, n_iters=500, **kw):
        self._clock.advance(self.ITER_S * n_iters)
        return self._inner.label_propagate(y0, *args, n_iters=n_iters, **kw)

    def label_propagate_resume(self, y, y0, *args, n_iters=500, **kw):
        self._clock.advance(self.ITER_S * n_iters)
        out = self._inner.label_propagate_resume(y, y0, *args,
                                                 n_iters=n_iters, **kw)
        if self.urgent is None:
            self.urgent = self.engine.submit(self._mod.PropagateRequest(
                y0=np.ones((y0.shape[-2], 1), np.float32), n_iters=3,
                deadline_ms=60.0))
            self.urgent.add_done_callback(
                lambda f: self.done_t.setdefault("urgent", self._clock()))
        return out


@pytest.mark.parametrize("backend", ["vdt", "exact"])
def test_midflight_urgent_arrival_preempts_like_reference(request, backend):
    ref = _fixture(request)
    rc, pc = FakeClock(), FakeClock()
    proxies = (_InjectingVDT(ref, rc, r_serving),
               _InjectingVDT(port_of(ref), pc, t_serving))
    kw = dict(start=False, policy="edf", segment_iters=SEG, backend=backend)
    pair = Pair(ref=RefEngine(proxies[0], clock=rc, **kw),
                port=PortEngine(proxies[1], clock=pc, **kw),
                ref_clock=rc, port_clock=pc)
    for proxy, eng in zip(proxies, (pair.ref, pair.port)):
        proxy.engine = eng
    y0 = np.random.RandomState(23).rand(ref.tree.n_points, 2) \
        .astype(np.float32)
    bulk = pair.submit(y0=y0, alpha=0.02, n_iters=BULK_ITERS,
                       deadline_ms=60_000.0)
    for proxy, fut, clock in zip(proxies, bulk, (rc, pc)):
        fut.add_done_callback(
            lambda f, proxy=proxy, clock=clock:
            proxy.done_t.setdefault("bulk", clock()))
    pair.call("step")

    r_m, p_m = pair.call("metrics")
    assert_metrics_equal(r_m, p_m)
    assert (p_m.preemptions, p_m.preempt_iters, p_m.expired,
            p_m.completed) == (1, BULK_ITERS - SEG, 0, 2)
    assert_same_decisions(pair)
    assert proxies[1].done_t["urgent"] < proxies[1].done_t["bulk"]
    assert proxies[1].done_t == pytest.approx(proxies[0].done_t)
    assert_outcomes_close([bulk[0], proxies[0].urgent],
                          [bulk[1], proxies[1].urgent])
    # the preempted walk equals an unpreempted one, bit for bit
    mono = proxies[1]._inner.label_propagate(y0, alpha=0.02,
                                             n_iters=BULK_ITERS,
                                             backend=backend)
    np.testing.assert_array_equal(bulk[1].result(timeout=0), mono.numpy())
    pair.call("shutdown")


@pytest.mark.parametrize("seg", [1, 3, 7, 20])
@pytest.mark.parametrize("backend", ["vdt", "exact"])
def test_segmented_engine_equals_monolithic_bit_for_bit(request, backend,
                                                        seg):
    """No urgency: the engine walks in segments of ``seg`` and its answers
    equal the monolithic batched walk on the same padded stack, bit for
    bit; the same resume calls as the reference engine."""
    ref = _fixture(request)
    n = ref.tree.n_points
    pair = Pair.build(ref, policy="edf", segment_iters=seg, max_batch=4,
                      backend=backend)
    rng = np.random.RandomState(29)
    futs = [pair.submit(y0=rng.rand(n, c).astype(np.float32), alpha=a,
                        n_iters=BULK_ITERS)
            for c, a in ((1, 0.01), (2, 0.2), (1, 0.05))]
    pair.call("flush")
    assert_same_decisions(pair)
    assert_metrics_equal(*pair.call("metrics"))
    assert_outcomes_close([f[0] for f in futs], [f[1] for f in futs])
    stack = np.zeros((4, n, 2), np.float32)
    alphas = np.zeros(4, np.float32)
    rng = np.random.RandomState(29)
    for k, (c, a) in enumerate(((1, 0.01), (2, 0.2), (1, 0.05))):
        stack[k, :, :c] = rng.rand(n, c).astype(np.float32)
        alphas[k] = a
    mono = pair.port.vdt.label_propagate(stack, alpha=alphas,
                                         n_iters=BULK_ITERS, batched=True,
                                         backend=backend)
    resumes = sum(e[0] == "resume" for e in pair.port.log)
    assert resumes == (0 if seg >= BULK_ITERS else -(-BULK_ITERS // seg))
    for k, f in enumerate(futs):
        c = f[1].result(timeout=0).shape[1]
        np.testing.assert_array_equal(f[1].result(timeout=0),
                                      mono[k, :, :c].numpy())


def test_grf_stays_monolithic_under_segmented_edf(request):
    ref = _fixture(request)
    n = ref.tree.n_points
    eng = PortEngine(port_of(ref), start=False, policy="edf", segment_iters=2,
                     backend="grf", n_walkers=8, grf_seed=3)
    fut = eng.submit(t_serving.PropagateRequest(np.ones((n, 1), np.float32),
                                                n_iters=6))
    eng.flush()
    assert not [e for e in eng.log if e[0] == "resume"]
    assert fut.result(timeout=0).shape == (n, 1)
    assert eng.metrics().preemptions == 0
    with pytest.raises(ValueError, match="segmented resume"):
        eng.vdt.label_propagate_resume(torch.zeros(1, n, 1),
                                       torch.zeros(1, n, 1), alpha=[0.1],
                                       batched=True, backend="grf")


def test_segmenting_inert_outside_edf(request):
    ref = _fixture(request)
    eng = PortEngine(port_of(ref), start=False, policy="fifo",
                     segment_iters=2)
    fut = eng.submit(t_serving.PropagateRequest(
        np.zeros((ref.tree.n_points, 1), np.float32), n_iters=8))
    eng.step()
    assert fut.result(timeout=0) is not None
    assert not [e for e in eng.log if e[0] == "resume"]
    assert "preempt" not in eng.capabilities()


def _queue_trace(mod):
    clock = FakeClock()
    q = mod.RequestQueue(16, discipline="edf", clock=clock)

    def entry(seq, deadline):
        return mod.QueueEntry(seq=seq, request=None, future=Future(),
                              t_submit=clock(), t_deadline=deadline)

    for seq, deadline in enumerate((5.0, 0.5, None, 0.7, 3.0)):
        q.put(entry(seq, deadline))
    trace = [q.deadline_before(1.0), q.deadline_before(0.5)]
    live, cancelled, expired = q.drain_urgent(8, horizon=1.0)
    trace.append(([e.seq for e in live], len(cancelled), len(expired),
                  len(q), q.next_deadline(), q.popped))
    clock.advance(10.0)
    live, cancelled, expired = q.drain_urgent(8, horizon=100.0)
    trace.append(([e.seq for e in live], [e.seq for e in expired], len(q),
                  q.popped))
    fifo = mod.RequestQueue(4, discipline="fifo")
    trace.append((fifo.drain_urgent(4, horizon=1.0),
                  fifo.deadline_before(float("inf"))))
    return trace


def test_queue_urgency_api_matches_reference():
    assert _queue_trace(t_queue) == _queue_trace(r_queue)
