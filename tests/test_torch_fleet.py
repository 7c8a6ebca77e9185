"""The port's multi-tenant fleet against the reference's, on the CPU.

Two fleets (``start=False``, a fake clock each) over the reference's fitted
model and its port copy get the same tenants, weights and seeded requests:
the deficit-round-robin dispatch order across tenants, the requests each
round serves, the per-tenant snapshots, the fleet counters and every
outcome must be the reference's (results within ``rtol=1e-4, atol=1e-5``).
"""
import numpy as np
import pytest

from _serving_pair import (FakeClock, PortEngine, RefEngine,
                           assert_metrics_equal, assert_outcomes_close,
                           make_requests)
from repro import serving as r_serving
from repro_torch import VariationalDualTree
from repro_torch import serving as t_serving
from test_torch_fit import port_of

ITERS = 4


def _fixture(request, name="small_fitted_vdt"):
    return request.getfixturevalue(name)[-1]


class FleetPair:
    """A reference fleet and a port fleet with the same tenants."""

    def __init__(self, ref_vdt, quantum=8.0):
        self.port_vdt = port_of(ref_vdt)
        self.ref_vdt = ref_vdt
        self.ref = r_serving.EngineFleet(start=False, clock=FakeClock(),
                                         quantum=quantum)
        self.port = t_serving.EngineFleet(start=False, clock=FakeClock(),
                                          quantum=quantum)
        self.steps = {"ref": [], "port": []}

    def register(self, tenant, **kw):
        for side, fleet, vdt, cls in (
                ("ref", self.ref, self.ref_vdt, RefEngine),
                ("port", self.port, self.port_vdt, PortEngine)):
            eng = fleet.register(tenant, vdt, engine_cls=cls, **kw)
            eng.step = self._logged(eng.step, self.steps[side], tenant)

    @staticmethod
    def _logged(step, steps, tenant):
        """``step`` that appends (tenant, futures resolved) to ``steps``:
        the fleet's dispatch order across tenants."""
        def logged():
            served = step()
            steps.append((tenant, served))
            return served
        return logged

    def submit(self, tenant, **fields):
        return (self.ref.submit(r_serving.PropagateRequest(tenant=tenant,
                                                           **fields),
                                block=False),
                self.port.submit(t_serving.PropagateRequest(tenant=tenant,
                                                            **fields),
                                 block=False))

    def call(self, name, *args, **kwargs):
        return (getattr(self.ref, name)(*args, **kwargs),
                getattr(self.port, name)(*args, **kwargs))

    def assert_same(self):
        assert self.steps["port"] == self.steps["ref"]
        r_m, p_m = self.call("metrics")
        assert (p_m.rounds, dict(p_m.served), dict(p_m.weights)) == \
            (r_m.rounds, dict(r_m.served), dict(r_m.weights))
        assert p_m.fair_share_err == pytest.approx(r_m.fair_share_err,
                                                   nan_ok=True)
        assert set(p_m.tenants) == set(r_m.tenants)
        for t in r_m.tenants:
            assert_metrics_equal(r_m.tenants[t], p_m.tenants[t])
            assert self.port._tenants[t].engine.log == \
                self.ref._tenants[t].engine.log
            assert self.port._tenants[t].deficit == pytest.approx(
                self.ref._tenants[t].deficit)


def _requests(seed, n, count, tenant):
    return [(tenant, r) for r in make_requests(seed, n, count, widths=(2,),
                                               alphas=(0.05,), iters=(ITERS,))]


@pytest.mark.parametrize("weights,quantum,rounds", [
    ((3.0, 1.0), 4.0, 3), ((10.0, 0.25), 1.0, 4), ((2.0, 1.0, 1.0), 2.0, 5)])
def test_drr_dispatch_order_matches_reference(request, weights, quantum,
                                              rounds):
    ref = _fixture(request)
    n = ref.tree.n_points
    fp = FleetPair(ref, quantum=quantum)
    names = [f"t{i}" for i in range(len(weights))]
    for name, w in zip(names, weights):
        fp.register(name, weight=w, max_batch=4, max_queue=64)
    traffic = []
    for i, name in enumerate(names):
        traffic += _requests(30 + i, n, 24 if i == 0 else 6, name)
    traffic.sort(key=lambda tr: tr[1]["y0"].sum())  # interleave tenants
    futs = [fp.submit(t, **r) for t, r in traffic]
    served = [fp.call("step_round") for _ in range(rounds)]
    assert [s[1] for s in served] == [s[0] for s in served]
    assert fp.steps["port"] == fp.steps["ref"]
    assert len({t for t, _ in fp.steps["port"]}) == len(names)
    fp.assert_same()
    fp.call("flush")
    fp.assert_same()
    assert_outcomes_close([f[0] for f in futs], [f[1] for f in futs])
    fp.call("shutdown")


def test_idle_tenants_and_isolation_match_reference(request):
    """An idle tenant banks no credit; one tenant's cancellation and expiry
    never reach another's futures — as in the reference, count for
    count."""
    ref = _fixture(request)
    n = ref.tree.n_points
    fp = FleetPair(ref, quantum=2.0)
    fp.register("a", policy="edf", max_batch=2)
    fp.register("b", max_batch=2)
    y0 = np.ones((n, 2), np.float32)
    doomed = fp.submit("a", y0=y0, n_iters=ITERS, deadline_ms=5.0)
    dropped = fp.submit("a", y0=y0, n_iters=ITERS, deadline_ms=1000.0)
    healthy = [fp.submit("b", y0=y0 * k, n_iters=ITERS) for k in range(5)]
    assert dropped[0].cancel() and dropped[1].cancel()
    for fleet in (fp.ref, fp.port):
        fleet._clock.advance(0.05)
    for _ in range(4):
        fp.call("step_round")
    assert fp.port._tenants["a"].deficit == 0.0
    fp.assert_same()
    assert_outcomes_close([f[0] for f in [doomed, dropped] + healthy],
                          [f[1] for f in [doomed, dropped] + healthy])
    fp.call("shutdown")


def test_routing_and_registration_errors_match_reference(request):
    ref = _fixture(request)
    n = ref.tree.n_points
    fp = FleetPair(ref)
    fp.register("a")
    fp.register("b")
    assert fp.port.tenants() == fp.ref.tenants() == ("a", "b")
    cases = [
        ("submit", dict(request=dict(y0=np.zeros((n, 1), np.float32)))),
        ("submit", dict(request=dict(y0=np.zeros((n, 1), np.float32),
                                     tenant="zz"))),
        ("register", dict(tenant="a")),
        ("register", dict(tenant="c", weight=0.0)),
        ("register", dict(tenant="c", start=True)),
        ("publish", dict(tenant=None)),
        ("publish", dict(tenant="zz")),
    ]
    for name, kw in cases:
        msgs = []
        for fleet, mod, vdt in ((fp.ref, r_serving, fp.ref_vdt),
                                (fp.port, t_serving, fp.port_vdt)):
            with pytest.raises(ValueError) as err:
                if name == "submit":
                    fleet.submit(mod.PropagateRequest(**kw["request"]))
                elif name == "register":
                    fleet.register(vdt=vdt, **kw)
                else:
                    fleet.publish(kw["tenant"], vdt)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1], name
    with pytest.raises(ValueError, match="quantum must be > 0"):
        t_serving.EngineFleet(quantum=0.0, start=False)
    fp.call("shutdown")
    with pytest.raises(RuntimeError, match="shut down"):
        fp.port.submit(t_serving.PropagateRequest(np.zeros((n, 1))))


def test_backpressure_is_per_tenant(request):
    ref = _fixture(request)
    n = ref.tree.n_points
    fleet = t_serving.EngineFleet(start=False, clock=FakeClock())
    vdt = port_of(ref)
    fleet.register("tiny", vdt, max_queue=1)
    fleet.register("roomy", vdt, max_queue=8)
    y0 = np.ones((n, 1), np.float32)
    fleet.submit(t_serving.PropagateRequest(y0, n_iters=2, tenant="tiny"))
    with pytest.raises(t_serving.QueueFull):
        fleet.submit(t_serving.PropagateRequest(y0, tenant="tiny"),
                     block=False)
    fut = fleet.submit(t_serving.PropagateRequest(y0, n_iters=2,
                                                  tenant="roomy"))
    fleet.flush()
    assert fut.result(timeout=0).shape == (n, 1)
    assert fleet.metrics().tenants["tiny"].rejected == 1
    fleet.shutdown()


def test_single_tenant_fleet_is_the_bare_engine_bit_for_bit(request):
    ref = _fixture(request)
    port = port_of(ref)
    reqs = make_requests(40, ref.tree.n_points, 9, widths=(1, 2, 3),
                         iters=(ITERS,))
    bare = t_serving.PropagateEngine(port, start=False, clock=FakeClock(),
                                     max_batch=4)
    bare_futs = [bare.submit(t_serving.PropagateRequest(**r)) for r in reqs]
    bare.flush()
    fleet = t_serving.EngineFleet(start=False, clock=FakeClock())
    fleet.register("solo", port, max_batch=4)
    fleet_futs = [fleet.submit(t_serving.PropagateRequest(**r))
                  for r in reqs]
    fleet.flush()
    for a, b in zip(bare_futs, fleet_futs):
        np.testing.assert_array_equal(a.result(timeout=0),
                                      b.result(timeout=0))
    fleet.shutdown()


def test_snapshots_share_no_mutable_state(request):
    ref = _fixture(request)
    fleet = t_serving.EngineFleet(start=False, clock=FakeClock())
    vdt = port_of(ref)
    fleet.register("a", vdt, weight=2.0)
    fleet.register("b", vdt)
    assert np.isnan(fleet.metrics().fair_share_err)
    fleet.submit(t_serving.PropagateRequest(
        np.ones((ref.tree.n_points, 1), np.float32), n_iters=2, tenant="a"))
    fleet.step_round()
    snap1, snap2 = fleet.metrics(), fleet.metrics()
    assert snap1.served is not snap2.served
    snap1.served["a"] = 10 ** 6
    del snap1.tenants["a"]
    assert fleet.metrics().served["a"] == 1
    assert fleet.metrics().tenants["a"].completed == 1
    fleet.shutdown()


def test_publish_is_per_tenant(request):
    """Publishing a second fitted model (another point count) to one
    tenant leaves the other's epoch, shape contract and answer alone; the
    bookkeeping is the reference's when both publish the same models."""
    ref = _fixture(request)
    n0 = ref.tree.n_points
    fp = FleetPair(ref)
    fp.register("a")
    fp.register("b")
    y0 = np.ones((n0, 2), np.float32)
    fut_b = fp.submit("b", y0=y0, n_iters=ITERS)
    fp.submit("a", y0=y0, n_iters=ITERS)
    assert (fp.ref.publish("a", fp.ref_vdt, patched_points=2),
            fp.port.publish("a", fp.port_vdt, patched_points=2)) == (1, 1)
    fp.assert_same()
    fp.call("flush")
    fp.assert_same()
    assert_outcomes_close([fut_b[0]], [fut_b[1]])

    x = np.random.RandomState(18).randn(19, 4).astype(np.float32)
    vdt1 = VariationalDualTree.fit(x, max_blocks=4 * 19, device="cpu")
    n1 = vdt1.tree.n_points
    fleet = fp.port
    fleet.submit(t_serving.PropagateRequest(y0, n_iters=ITERS, tenant="a"))
    assert fleet.publish("a", vdt1) == 2
    with pytest.raises(ValueError):
        fleet.submit(t_serving.PropagateRequest(y0, tenant="a"))
    fut_a = fleet.submit(t_serving.PropagateRequest(
        np.ones((n1, 1), np.float32), n_iters=ITERS, tenant="a"))
    fut_b2 = fleet.submit(t_serving.PropagateRequest(y0, n_iters=ITERS,
                                                     tenant="b"))
    fleet.flush()
    assert fut_a.result(timeout=0).shape == (n1, 1)
    np.testing.assert_array_equal(fut_b2.result(timeout=0),
                                  fut_b[1].result(timeout=0))
    snap = fleet.metrics().tenants
    assert (snap["a"].epoch, snap["a"].live_epochs) == (2, 1)
    assert (snap["b"].epoch, snap["b"].epochs_published) == (0, 0)
    fp.call("shutdown")


def test_background_fleet_serves_end_to_end(request):
    ref = _fixture(request)
    n = ref.tree.n_points
    vdt = port_of(ref)
    with t_serving.EngineFleet() as fleet:
        fleet.register("a", vdt, weight=2.0)
        fleet.register("b", vdt)
        futs = [fleet.submit(t_serving.PropagateRequest(
            np.ones((n, 2), np.float32), n_iters=ITERS, tenant=t))
            for t in ("a", "b", "a", "b", "a")]
        outs = [f.result(timeout=60) for f in futs]
    assert all(o.shape == (n, 2) for o in outs)
    m = fleet.metrics()
    assert m.served["a"] + m.served["b"] == 5
