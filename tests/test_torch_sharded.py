"""The port's sharded serving engine: bit parity with its single engine.

Mirrors ``tests/test_sharded.py`` against the port's ``PropagateEngine``
(``np.array_equal``, bit for bit: sharding is invisible in the output), on
the reference's ``fitted128`` model (n = 128, d = 8) carried across with
``vdt_from_numpy``.  The reference runs its full-mesh tests only on a CI
leg that forces 8 host devices; the port's mesh is a list of devices one
process drives, and a device may hold several shards, so here the full-mesh
tests run at D = 2, 4 and 8 on ``["cpu"] * D``.  Beside them: the port at
D = 1 against the reference's ``ShardedPropagateEngine`` at D = 1
(``rtol=1e-4, atol=1e-5``), and the exact stripe step against the whole
matrix's step bit for bit at shapes whose row-tile shape moves the plain
version's bits.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.vdt import VariationalDualTree as RefVDT
from repro_torch import VariationalDualTree
from repro_torch.core.divergence import mahalanobis
from repro_torch.kernels.fused_lp import folded_step_plain
from repro_torch.serving import (EngineFleet, PropagateEngine,
                                 PropagateRequest, ShardedPropagateEngine)
from repro_torch.serving import _sharded
from test_torch_fit import port_of

ITERS = 8
MESHES = (1, 2, 4, 8)

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


def _cpu(d: int) -> list:
    return ["cpu"] * d


@pytest.fixture(scope="module")
def fitted128():
    """The reference's fixture: (x, reference model, port model)."""
    r = np.random.RandomState(5)
    x = r.randn(128, 8).astype(np.float32)
    ref = RefVDT.fit(x, max_blocks=4 * 128, refine_batch=64)
    return x, ref, port_of(ref)


def _requests(rng, n, count, backend="vdt", n_iters=ITERS):
    reqs = []
    for i in range(count):
        c = [1, 2, 3, 4][i % 4]
        y0 = (rng.rand(n, c) > 0.8).astype(np.float32)
        reqs.append(PropagateRequest(
            y0, alpha=[0.01, 0.05, 0.2][i % 3], n_iters=n_iters,
            backend=backend))
    return reqs


def _run(engine, reqs):
    try:
        futs = [engine.submit(q) for q in reqs]
        engine.flush()
        return [np.asarray(f.result(timeout=30)) for f in futs]
    finally:
        engine.shutdown()


def _assert_bit_equal(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.array_equal(g, w), float(np.abs(g - w).max())


# ------------------------------------------------------- mesh of one shard
@pytest.mark.parametrize("backend", ["vdt", "exact"])
def test_single_device_mesh_bit_parity(fitted128, backend):
    """D=1 sharded engine == plain engine, bit for bit, both backends."""
    x, _, vdt = fitted128
    reqs = _requests(np.random.RandomState(0), x.shape[0], 5, backend)
    want = _run(PropagateEngine(vdt, start=False, max_batch=4), reqs)
    sh = ShardedPropagateEngine(vdt, devices=_cpu(1), start=False,
                                max_batch=4)
    assert sh.n_devices == 1
    _assert_bit_equal(_run(sh, reqs), want)


@pytest.mark.parametrize("backend", ["vdt", "exact"])
def test_single_device_segmented_edf_parity(fitted128, backend):
    """Segmented dispatch resumes through the sharded carry and reproduces
    the monolithic result exactly (9 iterations in segments of 2 force a
    1-iteration tail segment)."""
    x, _, vdt = fitted128
    reqs = _requests(np.random.RandomState(1), x.shape[0], 4, backend, 9)
    want = _run(PropagateEngine(vdt, start=False, max_batch=4), reqs)
    sh = ShardedPropagateEngine(vdt, devices=_cpu(1), start=False,
                                max_batch=4, policy="edf", segment_iters=2)
    assert "preempt" in sh.capabilities()
    _assert_bit_equal(_run(sh, reqs), want)


@pytest.mark.parametrize("backend", ["vdt", "exact"])
def test_single_device_matches_reference_sharded_engine(fitted128, backend):
    """D = 1 against the reference's sharded engine on the same tree."""
    from repro.serving import PropagateRequest as RefRequest
    from repro.serving import ShardedPropagateEngine as RefSharded

    x, ref, vdt = fitted128
    reqs = _requests(np.random.RandomState(2), x.shape[0], 5, backend)
    got = _run(ShardedPropagateEngine(vdt, devices=_cpu(1), start=False,
                                      max_batch=4), reqs)
    r_eng = RefSharded(ref, devices=jax.devices()[:1], start=False,
                       max_batch=4)
    want = _run(r_eng, [RefRequest(q.y0, alpha=q.alpha, n_iters=q.n_iters,
                                   backend=q.backend) for q in reqs])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


def test_capabilities_surface(fitted128):
    """Sharded advertises {publish, sharded} (plus preempt only under the
    EDF/segmented configuration) and never grf."""
    vdt = fitted128[-1]
    for d in MESHES:
        sh = ShardedPropagateEngine(vdt, devices=_cpu(d), start=False)
        edf = ShardedPropagateEngine(vdt, devices=_cpu(d), start=False,
                                     policy="edf", segment_iters=3)
        try:
            assert sh.capabilities() == frozenset({"publish", "sharded"})
            assert edf.capabilities() == frozenset(
                {"publish", "sharded", "preempt"})
        finally:
            sh.shutdown()
            edf.shutdown()
    base = PropagateEngine(vdt, start=False)
    assert base.capabilities() == frozenset({"publish", "grf"})
    base.shutdown()


def test_grf_rejected_at_ctor_and_submit(fitted128):
    x, _, vdt = fitted128
    with pytest.raises(ValueError, match="grf"):
        ShardedPropagateEngine(vdt, devices=_cpu(1), backend="grf",
                               start=False)
    sh = ShardedPropagateEngine(vdt, devices=_cpu(2), start=False)
    try:
        with pytest.raises(ValueError, match="grf"):
            sh.submit(PropagateRequest(
                np.zeros((x.shape[0], 1), np.float32), backend="grf"))
        with pytest.raises(ValueError, match="grf"):
            sh.warmup(widths=(1,), n_iters=(2,), backends=("grf",))
    finally:
        sh.shutdown()


def test_warmup_runs_every_sharded_shape(fitted128):
    vdt = fitted128[-1]
    sh = ShardedPropagateEngine(vdt, devices=_cpu(4), start=False,
                                max_batch=2, policy="edf", segment_iters=4)
    try:
        # (width bucket 2) x (batch buckets 1, 2), each with a resume
        assert sh.warmup(widths=(2,), n_iters=(ITERS,),
                         backends=("vdt", "exact")) == 8
        assert len(sh._buf_cache) == 1 and "cols" in next(
            iter(sh._buf_cache.values()))
    finally:
        sh.shutdown()


def _streamed_pair(seed: int, n: int, d: int, capacity: int):
    r = np.random.RandomState(seed)
    x = r.randn(n, d).astype(np.float32)
    vdt = VariationalDualTree.fit(x, max_blocks=4 * n, refine_batch=n // 2,
                                  capacity=capacity, device="cpu")
    return r, x, vdt, vdt.insert_points(x[:4] + 0.01)


def test_publish_serves_new_epoch_single_device():
    """The swapped-in tree serves bit-equal to a fresh engine over the same
    tree, and the retired epoch's shard buffers are dropped."""
    r, _, vdt, up = _streamed_pair(11, 96, 6, 128)
    sh = ShardedPropagateEngine(vdt, devices=_cpu(1), start=False,
                                max_batch=4)
    futs = [sh.submit(q) for q in _requests(np.random.RandomState(2), 96, 2)]
    sh.flush()
    assert all(f.done() for f in futs)
    sh.publish(up.vdt, patched_points=up.patched_points)
    req = PropagateRequest((r.rand(sh.n, 2) > 0.8).astype(np.float32),
                           alpha=0.05, n_iters=ITERS)
    got = _run(sh, [req])[0]
    want = _run(PropagateEngine(up.vdt, start=False), [req])[0]
    assert np.array_equal(got, want)
    assert list(sh._buf_cache) == [id(up.vdt)]  # old epoch's buffers gone


def test_fleet_registers_sharded_tenant(fitted128):
    """``engine_cls`` routes a tenant onto the sharded engine with no other
    fleet change."""
    x, _, vdt = fitted128
    fleet = EngineFleet(start=False)
    try:
        eng = fleet.register("shard", vdt, engine_cls=ShardedPropagateEngine,
                             devices=_cpu(4), max_batch=4)
        assert isinstance(eng, ShardedPropagateEngine) and eng.n_devices == 4
        reqs = [PropagateRequest(
            (np.random.RandomState(7).rand(x.shape[0], 2) > 0.8)
            .astype(np.float32), alpha=0.05, n_iters=ITERS, tenant="shard")]
        futs = [fleet.submit(q) for q in reqs]
        fleet.flush()
        want = _run(PropagateEngine(vdt, start=False), reqs)
        _assert_bit_equal([np.asarray(f.result(timeout=30)) for f in futs],
                          want)
    finally:
        fleet.shutdown()


# ------------------------------------------------------------- full mesh
@pytest.mark.parametrize("backend", ["vdt", "exact"])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_full_mesh_bit_parity(fitted128, backend, seed, n_shards):
    """A mixed width/alpha request stream, bit for bit."""
    x, _, vdt = fitted128
    reqs = _requests(np.random.RandomState(seed), x.shape[0], 6, backend)
    want = _run(PropagateEngine(vdt, start=False, max_batch=4), reqs)
    sh = ShardedPropagateEngine(vdt, devices=_cpu(n_shards), start=False,
                                max_batch=4)
    assert sh.n_devices == n_shards
    _assert_bit_equal(_run(sh, reqs), want)


@pytest.mark.parametrize("backend", ["vdt", "exact"])
@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_full_mesh_segmented_edf_parity(fitted128, backend, n_shards):
    """The carry guarantee survives sharding: segmented dispatch on the full
    mesh is bit-identical to the monolithic single-device run."""
    x, _, vdt = fitted128
    reqs = _requests(np.random.RandomState(3), x.shape[0], 4, backend, 9)
    want = _run(PropagateEngine(vdt, start=False, max_batch=4), reqs)
    sh = ShardedPropagateEngine(vdt, devices=_cpu(n_shards), start=False,
                                max_batch=4, policy="edf", segment_iters=2)
    _assert_bit_equal(_run(sh, reqs), want)


@pytest.mark.parametrize("backend", ["vdt", "exact"])
def test_full_mesh_publish_mid_flight(backend):
    """Queued old-epoch requests keep their bits across a publish; the new
    epoch serves bit-equal to a fresh engine on the full mesh."""
    r, _, vdt, up = _streamed_pair(13, 128, 8, 160)
    reqs = _requests(np.random.RandomState(4), 128, 2, backend)
    sh = ShardedPropagateEngine(vdt, devices=_cpu(8), start=False,
                                max_batch=4, backend=backend)
    pending = [sh.submit(q) for q in reqs]
    sh.publish(up.vdt, patched_points=up.patched_points)
    req2 = PropagateRequest((r.rand(sh.n, 2) > 0.8).astype(np.float32),
                            alpha=0.05, n_iters=ITERS, backend=backend)
    got2 = _run(sh, [req2])[0]
    _assert_bit_equal([np.asarray(f.result(timeout=0)) for f in pending],
                      _run(PropagateEngine(vdt, start=False, max_batch=4),
                           reqs))
    assert np.array_equal(got2, _run(PropagateEngine(up.vdt, start=False),
                                     [req2])[0])
    assert list(sh._buf_cache) == [id(up.vdt)]


def test_one_point_model_runs_the_single_engine_scan():
    """N = 1: the exact walk carries the reference's padded rows, as the
    single engine's does."""
    x = np.zeros((1, 3), np.float32)
    vdt = VariationalDualTree.fit(x, max_blocks=4, device="cpu")
    reqs = [PropagateRequest(np.ones((1, 2), np.float32), alpha=0.5,
                             n_iters=3, backend=be) for be in
            ("exact", "vdt")]
    want = _run(PropagateEngine(vdt, start=False), reqs)
    _assert_bit_equal(_run(ShardedPropagateEngine(
        vdt, devices=_cpu(1), start=False), reqs), want)


def test_more_devices_than_leaves_rejected():
    x = np.random.RandomState(17).randn(3, 3).astype(np.float32)
    vdt = VariationalDualTree.fit(x, max_blocks=12, device="cpu")
    assert vdt.tree.n_leaves < 8
    with pytest.raises(ValueError, match="leaf"):
        ShardedPropagateEngine(vdt, devices=_cpu(8), start=False)


def test_non_power_of_two_mesh_rejected(fitted128):
    vdt = fitted128[-1]
    for d in (3, 6, 0):
        with pytest.raises(ValueError, match="power-of-two"):
            ShardedPropagateEngine(vdt, devices=_cpu(d), start=False)
    with pytest.raises(ValueError, match="at most 256"):
        ShardedPropagateEngine(vdt, devices=_cpu(512), start=False)


@pytest.fixture(scope="module", params=["kl", "mahalanobis"])
def fitted_divergence(request):
    """A port model fitted under a Bregman divergence: KL on positive
    points, Mahalanobis with a non-trivial scale (its point pre-map)."""
    r = np.random.RandomState(23)
    x = ((r.rand(128, 8) + 0.1) * 2.0).astype(np.float32)
    div = (mahalanobis(np.linspace(0.5, 2.0, 8))
           if request.param == "mahalanobis" else request.param)
    return x, VariationalDualTree.fit(x, max_blocks=4 * 128, refine_batch=64,
                                      divergence=div, device="cpu")


@pytest.mark.parametrize("backend", ["vdt", "exact"])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_full_mesh_divergence_bit_parity(fitted_divergence, backend,
                                         n_shards):
    """Sharding stays invisible under the divergences: the stripes run the
    model's divergence tile on its pre-mapped points, as the single engine
    does."""
    x, vdt = fitted_divergence
    reqs = _requests(np.random.RandomState(5), x.shape[0], 4, backend)
    want = _run(PropagateEngine(vdt, start=False, max_batch=4), reqs)
    sh = ShardedPropagateEngine(vdt, devices=_cpu(n_shards), start=False,
                                max_batch=4)
    _assert_bit_equal(_run(sh, reqs), want)


# ------------------------------------------------------ the stripe step
@pytest.mark.parametrize("n,d,k", [(128, 8, 4), (517, 33, 16),
                                   (1000, 17, 24), (4_300, 8, 3)])
@pytest.mark.parametrize("n_shards", [2, 8])
def test_stripe_rows_equal_the_whole_step(n, d, k, n_shards):
    """Each stripe's rows (``row_base`` = its offset, the reference's
    layout) equal the whole step's rows bit for bit; at 4,300 rows a stripe
    crosses the plain version's 4,096-row tile."""
    g = torch.Generator().manual_seed(n + k)
    x, y = torch.randn(n, d, generator=g), torch.randn(n, k, generator=g)
    al = torch.rand(k, generator=g)
    whole = folded_step_plain(x, x, y, y, al, 0.7)
    rps = (-(-n // 256) * 256) // n_shards
    covered = 0
    for s in range(n_shards):
        lo, hi = min(s * rps, n), min((s + 1) * rps, n)
        if lo == hi:
            continue
        got = _sharded._stripe_step(x[lo:hi], x, y, y[lo:hi], al, 0.7, lo,
                                    None)
        assert torch.equal(got, whole[lo:hi]), (s, lo, hi)
        covered += hi - lo
    assert covered == n
