"""The port's serving engine against the reference engine, on the CPU.

Both engines serve the reference's fitted model (carried into the port with
``port_of``) with ``start=False`` and a fake clock each, on the same seeded
numpy requests: the same dispatches and scans in the same order, the same
outcomes, every counter of ``MetricsSnapshot`` equal, and results within
``rtol=1e-4, atol=1e-5``.  Within the port, every scan the engine made
equals a direct batched ``label_propagate`` on the same padded stack bit
for bit, on the vdt, exact and grf backends.
"""
import threading

import numpy as np
import pytest
import torch

from _serving_pair import (ATOL, RTOL, Pair, PortEngine,
                           assert_metrics_equal, assert_outcomes_close,
                           assert_same_decisions,
                           assert_scans_equal_direct_calls, make_requests,
                           outcome)
from repro import serving as r_serving
from repro_torch import VariationalDualTree
from repro_torch import serving as t_serving
from repro_torch.serving import _batching as t_batching
from repro.serving import _batching as r_batching
from test_torch_fit import port_of

ITERS = 8


def _fixture(request, name="small_fitted_vdt"):
    return request.getfixturevalue(name)[-1]


# --------------------------------------------------------------- parity
@pytest.mark.parametrize("backend,seed", [("vdt", 0), ("vdt", 1),
                                          ("exact", 2)])
def test_engine_matches_reference_engine(request, backend, seed):
    ref = _fixture(request)
    pair = Pair.build(ref, max_batch=4, backend=backend)
    reqs = make_requests(seed, ref.tree.n_points, 9)
    futs = [pair.submit(**r) for r in reqs]
    assert pair.call("flush") == (9, 9)
    assert_outcomes_close([f[0] for f in futs], [f[1] for f in futs])
    assert_same_decisions(pair)
    assert_metrics_equal(*pair.call("metrics"))
    assert_scans_equal_direct_calls(pair.port)
    for f, r in zip(futs, reqs):
        got = f[1].result(timeout=0)
        assert isinstance(got, np.ndarray) and got.shape == r["y0"].shape
        solo = pair.port.vdt.label_propagate(
            r["y0"], alpha=r["alpha"], n_iters=r["n_iters"], backend=backend)
        np.testing.assert_allclose(got, solo.numpy(), rtol=RTOL, atol=ATOL)


def test_engine_mixed_iters_widths_and_backends(request):
    """Per-request backends and iteration counts split groups as the
    reference does; width coalescing off keeps width buckets apart."""
    ref = _fixture(request)
    n = ref.tree.n_points
    pair = Pair.build(ref, max_batch=8, coalesce_widths=False)
    reqs = (make_requests(3, n, 4, iters=(4, ITERS))
            + make_requests(4, n, 3, backend="exact")
            + make_requests(5, n, 2, backend="auto"))
    futs = [pair.submit(**r) for r in reqs]
    pair.call("flush")
    assert_outcomes_close([f[0] for f in futs], [f[1] for f in futs])
    assert_same_decisions(pair)
    assert_metrics_equal(*pair.call("metrics"))
    assert_scans_equal_direct_calls(pair.port)


@pytest.mark.parametrize("n_walkers", [None, 12])
def test_grf_engine_equals_direct_call_and_reference_budget(request,
                                                            n_walkers):
    """grf: the dispatch runs at the largest budget of its group, as the
    reference's ``_walker_budget`` sizes it, and equals a direct port call
    with that budget and the engine's seed bit for bit.  (The reference's
    threefry walks cannot match torch's generator, so only the budgets are
    held to it.)"""
    ref = _fixture(request)
    n = ref.tree.n_points
    reqs = (make_requests(6, n, 2, n_walkers=n_walkers)
            + make_requests(7, n, 1, rtol=0.25)
            + make_requests(8, n, 1))
    kw = dict(start=False, max_batch=4, backend="grf", n_walkers=8,
              grf_seed=5)
    r_eng = r_serving.PropagateEngine(ref, **kw)
    port = PortEngine(port_of(ref), **kw)
    futs = [port.submit(t_serving.PropagateRequest(**r)) for r in reqs]
    for r in reqs:
        req = r_serving.PropagateRequest(**r)
        want = r_eng._walker_budget(req)
        assert port._walker_budget(t_serving.PropagateRequest(**r)) == want
    port.flush()
    budget = max(r_eng._walker_budget(r_serving.PropagateRequest(**r))
                 for r in reqs)
    (_, _, _, _, _, used), = port.scans
    assert used == budget == 16  # rtol 0.25 -> ceil(1 / 0.25^2)
    assert port.metrics().n_walkers == budget
    assert_scans_equal_direct_calls(port)
    for f, r in zip(futs, reqs):
        out = f.result(timeout=0)
        assert out.shape == r["y0"].shape and np.isfinite(out).all()
    r_eng.shutdown()
    port.shutdown()


def test_propagate_many_matches_reference(request):
    ref = _fixture(request)
    port = port_of(ref)
    reqs = make_requests(9, ref.tree.n_points, 6, widths=(1, 3),
                         alphas=(0.05, 0.2))
    reqs.append(dict(reqs[0], alpha=reqs[0]["alpha"] * (1 + 1e-9)))
    want = r_serving.propagate_many(ref, [r_serving.PropagateRequest(**r)
                                          for r in reqs], max_batch=4)
    got = t_serving.propagate_many(port, [t_serving.PropagateRequest(**r)
                                          for r in reqs], max_batch=4)
    for g, w, r in zip(got, want, reqs):
        assert isinstance(g, torch.Tensor) and g.shape == r["y0"].shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
    # near-equal alphas share a group: the appended copy equals the first
    torch.testing.assert_close(got[-1], got[0], rtol=0, atol=0)


def test_batching_vocabulary_matches_reference():
    for c in (1, 2, 3, 5, 8, 17):
        assert t_batching.bucket_width(c, t_batching.DEFAULT_WIDTH_BUCKETS) \
            == r_batching.bucket_width(c, r_batching.DEFAULT_WIDTH_BUCKETS)
    for n, cap in ((1, 8), (3, 8), (5, 4), (9, 32)):
        assert t_batching.batch_bucket(n, cap) == r_batching.batch_bucket(
            n, cap)
    for a in (0.01, 0.010000001, 0.123456789, 1.0):
        assert t_batching.canonical_alpha(a) == r_batching.canonical_alpha(a)
        assert t_batching.group_key(a, 5, 3, (2, 4)) == \
            r_batching.group_key(a, 5, 3, (2, 4))
    y = torch.arange(6.0).reshape(3, 2)
    stacked = t_batching.stack_group([y, y[:, :1]], 4)
    assert stacked.shape == (2, 3, 4)
    np.testing.assert_array_equal(
        stacked.numpy(), np.asarray(r_batching.stack_group(
            [y.numpy(), y[:, :1].numpy()], 4)))


@pytest.mark.parametrize("field,value", [
    ("y0", np.zeros((5, 2), np.float32)), ("y0", np.zeros((33, 129))),
    ("alpha", 1.5), ("alpha", float("nan")), ("n_iters", 0),
    ("backend", "dense"), ("rtol", 0.0), ("n_walkers", 0),
    ("deadline_ms", -1.0)])
def test_validation_errors_match_reference(request, field, value):
    ref = _fixture(request)
    pair = Pair.build(ref)
    fields = dict(y0=np.zeros((ref.tree.n_points, 2), np.float32))
    fields[field] = value
    msgs = []
    for eng, mod in ((pair.ref, r_serving), (pair.port, t_serving)):
        with pytest.raises(ValueError) as err:
            eng.submit(mod.PropagateRequest(**fields))
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    assert_metrics_equal(*pair.call("metrics"))


def test_validate_takes_a_private_copy_of_a_tensor(request):
    ref = _fixture(request)
    y0 = torch.ones((ref.tree.n_points, 2))
    req = t_serving.PropagateRequest(y0).validate(
        n=ref.tree.n_points, buckets=t_batching.DEFAULT_WIDTH_BUCKETS)
    y0.zero_()
    assert isinstance(req.y0, np.ndarray) and req.y0.dtype == np.float32
    assert (req.y0 == 1).all()


# ------------------------------------------- lifecycle, queue and metrics
def test_cancellation_backpressure_and_counters_match_reference(request):
    ref = _fixture(request)
    pair = Pair.build(ref, max_batch=4, max_queue=3)
    reqs = make_requests(10, ref.tree.n_points, 3, widths=(2,))
    futs = [pair.submit(**r) for r in reqs]
    for mod, eng in ((r_serving, pair.ref), (t_serving, pair.port)):
        with pytest.raises(mod.QueueFull):
            eng.submit(mod.PropagateRequest(**reqs[0]), block=False)
    assert futs[1][0].cancel() and futs[1][1].cancel()
    pair.call("step")
    late = pair.submit(**reqs[2])
    pair.call("flush")
    assert_outcomes_close([f[0] for f in futs + [late]],
                          [f[1] for f in futs + [late]])
    assert_same_decisions(pair)
    assert_metrics_equal(*pair.call("metrics"))
    m = pair.port.metrics()
    assert (m.cancelled, m.rejected, m.completed) == (1, 1, 3)


@pytest.mark.parametrize("wait", [True, False])
def test_shutdown_resolves_like_reference(request, wait):
    ref = _fixture(request)
    pair = Pair.build(ref, policy="edf")
    y0 = np.zeros((ref.tree.n_points, 1), np.float32)
    doomed = pair.submit(y0=y0, n_iters=2, deadline_ms=10.0)
    live = pair.submit(y0=y0, n_iters=2)
    pair.advance(1.0)
    pair.call("shutdown", wait=wait)
    assert outcome(doomed[1]) == outcome(doomed[0]) == "DeadlineExceeded"
    assert_outcomes_close([live[0]], [live[1]])
    assert_metrics_equal(*pair.call("metrics"))
    with pytest.raises(RuntimeError, match="shut down"):
        pair.port.submit(t_serving.PropagateRequest(y0))


def test_scheduler_fault_is_counted_and_survived(request, caplog):
    ref = _fixture(request)
    eng = t_serving.PropagateEngine(port_of(ref), max_wait_ms=0)
    fired = threading.Event()
    real_step = eng.step

    def bad_step():
        if not fired.is_set():
            fired.set()
            raise RuntimeError("injected scheduler fault")
        return real_step()

    eng.step = bad_step
    with caplog.at_level("ERROR", logger="repro_torch.serving._engine"):
        fut = eng.submit(t_serving.PropagateRequest(
            np.ones((ref.tree.n_points, 1), np.float32), n_iters=2))
        assert fut.result(timeout=60).shape == (ref.tree.n_points, 1)
    assert eng.metrics().scheduler_errors >= 1
    assert "injected scheduler fault" in caplog.text
    eng.shutdown()


def test_background_thread_engine_end_to_end(request):
    """``start=True``: the scheduler thread serves the requests; each answer
    equals the port's own static batching of the same list."""
    ref = _fixture(request)
    port = port_of(ref)
    reqs = make_requests(11, ref.tree.n_points, 8)
    want = t_serving.propagate_many(
        port, [t_serving.PropagateRequest(**r) for r in reqs])
    with t_serving.PropagateEngine(port, max_batch=4, max_wait_ms=1.0) as eng:
        futs = [eng.submit(t_serving.PropagateRequest(**r)) for r in reqs]
        for f, w in zip(futs, want):
            np.testing.assert_allclose(f.result(timeout=60), w.numpy(),
                                       rtol=1e-5, atol=1e-6)
    assert eng.metrics().completed == 8


@pytest.mark.parametrize("kwargs,warm", [
    (dict(max_batch=4), dict(widths=(1, 2), n_iters=(ITERS,))),
    (dict(max_batch=3, policy="edf", segment_iters=4),
     dict(widths=(4,), n_iters=(ITERS, 3))),
    (dict(max_batch=1, backend="exact"),
     dict(widths=(4,), n_iters=(2, 3), backends=("vdt", "exact", "auto"))),
    # grf warms no resume, so its count is the shape grid's alone
    (dict(max_batch=2, policy="edf", segment_iters=2, n_walkers=4),
     dict(widths=(1,), n_iters=(ITERS,), backends=("grf", "vdt")))])
def test_warmup_counts_match_reference(request, kwargs, warm):
    ref = _fixture(request)
    pair = Pair.build(ref, **kwargs)
    want, got = pair.call("warmup", **warm)
    assert got == want > 0
    # one iteration per shape and backend, each resume warmed once
    scans = [e for e in pair.port.log if e[0] == "scan"]
    assert all(e[3] == 1 for e in scans)
    assert len(scans) == len(set((e[1], e[2]) for e in scans))


def test_port_engine_rejects_bad_config_like_reference(request):
    ref = _fixture(request)
    port = port_of(ref)
    for kw in (dict(max_batch=0), dict(policy="lifo"), dict(segment_iters=0),
               dict(n_walkers=0), dict(backend="dense")):
        msgs = []
        for cls, vdt in ((r_serving.PropagateEngine, ref),
                         (t_serving.PropagateEngine, port)):
            with pytest.raises(ValueError) as err:
                cls(vdt, start=False, **kw)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


def test_capabilities_and_dispatch_key_match_reference(request):
    ref = _fixture(request)
    port = port_of(ref)
    assert port.divergence_name == ref.divergence_name == "sqeuclidean"
    for kw in (dict(), dict(policy="edf", segment_iters=3),
               dict(backend="exact")):
        pair = Pair.build(ref, port_vdt=port, **kw)
        assert pair.port.capabilities() == pair.ref.capabilities()
        assert pair.port.metrics().dispatch_key == \
            pair.ref.metrics().dispatch_key
        fp = pair.port.fit_params
        assert (fp.model, fp.n_points, fp.divergence, fp.epoch) == \
            (port, ref.tree.n_points, "sqeuclidean", 0)


# ------------------------------------------------------------- epochs
def test_publish_bookkeeping_matches_reference(request):
    """Publishing a second model mid-queue: the same epochs, pins,
    retirements and counters as the reference, and the old epoch's
    results unchanged."""
    ref = _fixture(request)
    pair = Pair.build(ref, max_batch=4)
    n = ref.tree.n_points
    old = [pair.submit(**r) for r in make_requests(12, n, 5, widths=(2,))]
    eids = (pair.ref.publish(ref, patched_points=3, stale_blocks=2),
            pair.port.publish(port_of(ref), patched_points=3, stale_blocks=2))
    assert eids == (1, 1)
    assert_metrics_equal(*pair.call("metrics"))
    assert pair.port.metrics().live_epochs == 2
    new = [pair.submit(**r) for r in make_requests(13, n, 3, widths=(2,))]
    pair.call("flush")
    pair.call("step")
    assert_outcomes_close([f[0] for f in old + new], [f[1] for f in old + new])
    assert_same_decisions(pair)
    assert_metrics_equal(*pair.call("metrics"))
    m = pair.port.metrics()
    assert (m.epoch, m.live_epochs, m.epochs_retired, m.patched_points,
            m.stale_blocks) == (1, 1, 1, 3, 2)


def test_publish_a_second_fitted_model_pins_epochs_bit_for_bit(request):
    """A second model with another point count, fitted by the port: entries
    queued before the publish equal direct calls on the first model, those
    after it direct calls on the second, bit for bit; staging buffers of
    the retired N are pruned."""
    ref = _fixture(request)
    vdt0 = port_of(ref)
    x = np.random.RandomState(17).randn(21, 4).astype(np.float32)
    vdt1 = VariationalDualTree.fit(x, max_blocks=4 * 21, device="cpu")
    n0, n1 = vdt0.tree.n_points, vdt1.tree.n_points
    eng = PortEngine(vdt0, start=False, max_batch=4)
    old = [eng.submit(t_serving.PropagateRequest(**r))
           for r in make_requests(14, n0, 5)]
    assert eng.publish(vdt1) == 1
    with pytest.raises(ValueError):
        eng.submit(t_serving.PropagateRequest(np.zeros((n0, 1), np.float32)))
    new = [eng.submit(t_serving.PropagateRequest(**r))
           for r in make_requests(15, n1, 5)]
    eng.flush()
    assert [f.result(timeout=0).shape[0] for f in old] == [n0] * 5
    assert [f.result(timeout=0).shape[0] for f in new] == [n1] * 5
    for stack, alphas, out, backend, n_iters, _ in eng.scans:
        vdt = vdt0 if stack.shape[1] == n0 else vdt1
        direct = vdt.label_propagate(stack, alpha=alphas, n_iters=n_iters,
                                     batched=True, backend=backend)
        torch.testing.assert_close(out, direct, rtol=0, atol=0)
    eng.step()
    m = eng.metrics()
    assert (m.epoch, m.live_epochs, m.epochs_retired) == (1, 1, 1)
    assert all(key[0] == n1 for key in eng.dispatch_state.staging)
    eng.shutdown()


def test_engine_runs_where_its_model_is(request, monkeypatch):
    """The engine has no device argument: a CPU model dispatches on the CPU
    and resolves to host arrays; a model said to lie on the card stages its
    stack there, which raises without one (no fallback)."""
    ref = _fixture(request)
    port = port_of(ref)
    eng = t_serving.PropagateEngine(port, start=False)
    fut = eng.submit(t_serving.PropagateRequest(
        np.ones((ref.tree.n_points, 1), np.float32), n_iters=2))
    eng.flush()
    assert isinstance(fut.result(timeout=0), np.ndarray)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(type(port), "device",
                        property(lambda self: torch.device("cuda")))
    fut = eng.submit(t_serving.PropagateRequest(
        np.ones((ref.tree.n_points, 1), np.float32), n_iters=2))
    eng.flush()
    with pytest.raises((RuntimeError, AssertionError)):
        fut.result(timeout=0)
    assert eng.metrics().failed == 1


def test_fake_clock_latencies_match_reference(request):
    """Latencies are read off the injected clock: with the same clock steps
    both engines report the same quantiles."""
    ref = _fixture(request)
    pair = Pair.build(ref, max_batch=2)
    n = ref.tree.n_points
    for i, r in enumerate(make_requests(16, n, 4, widths=(1,))):
        pair.submit(**r)
        pair.advance(0.01 * (i + 1))
    pair.call("flush")
    r_m, p_m = pair.call("metrics")
    assert (p_m.latency_p50_ms, p_m.latency_p95_ms, p_m.latency_mean_ms) \
        == pytest.approx((r_m.latency_p50_ms, r_m.latency_p95_ms,
                          r_m.latency_mean_ms))



def test_concurrent_producers_against_the_scheduler_thread(request):
    """More producer threads than cores, a short switch interval: every
    accepted request is answered once, correctly, and the counters add up
    (a lost update would break either)."""
    import sys

    ref = _fixture(request)
    port = port_of(ref)
    n = ref.tree.n_points
    reqs = make_requests(18, n, 48, widths=(1, 2), iters=(2,))
    want = t_serving.propagate_many(
        port, [t_serving.PropagateRequest(**r) for r in reqs])
    results = [None] * len(reqs)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with t_serving.PropagateEngine(port, max_batch=8, max_wait_ms=0.5,
                                       max_queue=16) as eng:
            def producer(t):
                for i in range(t, len(reqs), 12):
                    fut = eng.submit(t_serving.PropagateRequest(**reqs[i]),
                                     timeout=60)
                    results[i] = fut.result(timeout=60)

            threads = [threading.Thread(target=producer, args=(t,))
                       for t in range(12)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    for got, w in zip(results, want):
        np.testing.assert_allclose(got, w.numpy(), rtol=1e-5, atol=1e-6)
    m = eng.metrics()
    assert m.submitted == m.completed == len(reqs)
    assert m.batched_requests == len(reqs) and m.in_flight == 0
