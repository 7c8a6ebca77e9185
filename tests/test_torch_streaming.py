"""The port's streaming layer (``repro_torch.core.streaming``) against the
reference's, on the CPU, and the port's own differential harness.

Per divergence, the reference's fitted model and its copy in the port
(``vdt_from_numpy`` with its ``divergence``) take the same interleaved
insert/delete script: every ``StreamUpdate`` (rows, row map, touched and
stale block counts), the new epoch's tree, partition and q-state (identical
``-inf`` patterns, ``rtol=1e-4, atol=1e-5``) and its VDT and exact label
propagation must agree.  Then, within the port, the claims of
``tests/test_streaming.py``: each mutation equals :func:`recompute`, epochs
are copy-on-write, capacity and validation errors, stale-first refinement,
and the soak (slow).  Last, a streamed epoch published into the port's
``PropagateEngine`` mid-flight, as ``tests/test_engine.py`` does: entries
queued before the publish resolve bit for bit as on an engine that never
saw it.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _serving_pair import (Pair, assert_metrics_equal, assert_outcomes_close,
                           assert_same_decisions, make_requests)
from repro.core.vdt import VariationalDualTree as RefVDT
from repro_torch import VariationalDualTree
from repro_torch.core import CapacityError
from repro_torch.core.streaming import recompute
from repro_torch.serving import PropagateEngine, PropagateRequest
from test_torch_divergence import port_model
from test_torch_fit import assert_qstate_close, assert_state_close

DIVERGENCES = ("sqeuclidean", "kl", "itakura_saito", "mahalanobis")
N0, DIM, CAPACITY, MAX_BLOCKS = 37, 3, 64, 120   # tests/test_streaming.py's
RTOL, ATOL = 1e-4, 1e-5
OPS = [("ins", 6), ("del", 9), ("ins", 4), ("del", 5), ("ins", 7), ("del", 3),
       ("ins", 2)]


def make_x(rng, k, divergence, scale=1.0):
    x = rng.randn(k, DIM).astype(np.float32) * scale
    if divergence in ("kl", "itakura_saito"):
        x = np.abs(x) + 0.1  # positive-domain divergences
    return x.astype(np.float32)


def fit(x, divergence="sqeuclidean", **kw):
    return VariationalDualTree.fit(x, device="cpu", divergence=divergence,
                                   **kw)


@pytest.fixture(scope="module", params=DIVERGENCES)
def fitted_pair(request):
    """(divergence, reference model, its port copy) with insert headroom."""
    div = request.param
    x = make_x(np.random.RandomState(11), N0, div)
    ref = RefVDT.fit(x, max_blocks=MAX_BLOCKS, capacity=CAPACITY,
                     divergence=div)
    return div, ref, port_model(ref)


def assert_epochs_match(ref_upd, port_upd) -> None:
    """One mutation's result in both packages."""
    np.testing.assert_array_equal(port_upd.rows, ref_upd.rows)
    if ref_upd.row_map is None:
        assert port_upd.row_map is None
    else:
        np.testing.assert_array_equal(port_upd.row_map, ref_upd.row_map)
    assert (port_upd.patched_points, port_upd.touched_blocks,
            port_upd.stale_blocks) == (ref_upd.patched_points,
                                       ref_upd.touched_blocks,
                                       ref_upd.stale_blocks)
    assert set(port_upd.seconds) == {"mirrors", "patch", "freeze", "qopt"}
    ref, port = ref_upd.vdt, port_upd.vdt
    assert port.tree.n_points == ref.tree.n_points
    for k in ("slot_of", "leaf_of"):
        np.testing.assert_array_equal(getattr(port.tree, k).numpy(),
                                      np.asarray(getattr(ref.tree, k)))
    for k in ("x_leaf", "w_leaf", "W", "S1", "S2"):
        np.testing.assert_allclose(getattr(port.tree, k).numpy(),
                                   np.asarray(getattr(ref.tree, k)),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    rs, ps = ref.bound_divergence.stats, port.bound_divergence.stats
    assert (rs is None) == (ps is None)
    if rs is not None:
        for k in ("sphi", "sg", "sgx"):
            np.testing.assert_allclose(getattr(ps, k).numpy(),
                                       np.asarray(getattr(rs, k)),
                                       rtol=RTOL, atol=1e-4, err_msg=k)
    for k in ("a", "b", "mirror", "active", "refined"):
        np.testing.assert_array_equal(getattr(port.bp, k), getattr(ref.bp, k))
    assert_qstate_close(ref.qstate, port.qstate)
    n = ref.tree.n_points
    y0 = (np.random.RandomState(n).rand(n, 2) > 0.8).astype(np.float32)
    for backend in ("vdt", "exact"):
        np.testing.assert_allclose(
            port.label_propagate(y0, alpha=0.1, n_iters=6,
                                 backend=backend).numpy(),
            np.asarray(ref.label_propagate(jnp.asarray(y0), alpha=0.1,
                                           n_iters=6, backend=backend)),
            rtol=RTOL, atol=ATOL, err_msg=backend)


def run_script(ref, port, div, ops, seed):
    """The same insert/delete script in both packages, held op by op."""
    rng = np.random.RandomState(seed)
    for kind, k in ops:
        n = ref.tree.n_points
        if kind == "ins":
            x_new = make_x(rng, k, div)
            r_upd, t_upd = ref.insert_points(x_new), port.insert_points(x_new)
        else:
            rows = np.sort(rng.choice(n, k, replace=False))
            r_upd, t_upd = ref.delete_points(rows), port.delete_points(rows)
        assert_epochs_match(r_upd, t_upd)
        ref, port = r_upd.vdt, t_upd.vdt
    return ref, port


def assert_matches_recompute(vdt, lp_atol=2e-3, unit_weights=True):
    """The port's differential oracle, at the reference harness's limits."""
    ora = recompute(vdt)
    n = vdt.tree.n_points
    w_scale = max(1.0, float(ora.tree.W.abs().max()))
    for name in ("W", "S1", "S2"):
        np.testing.assert_allclose(getattr(vdt.tree, name).numpy(),
                                   getattr(ora.tree, name).numpy(), rtol=2e-4,
                                   atol=1e-3 * w_scale, err_msg=name)
    np.testing.assert_array_equal(vdt.bp.active, ora.bp.active)
    lq, lq_ora = vdt.qstate.log_q.numpy(), ora.qstate.log_q.numpy()
    mask = np.isfinite(lq_ora)
    np.testing.assert_array_equal(np.isfinite(lq), mask)
    np.testing.assert_allclose(lq[mask], lq_ora[mask], rtol=1e-3, atol=5e-4)
    q_mut, q_ora = vdt.dense_q(), ora.dense_q()
    if unit_weights:
        np.testing.assert_allclose(q_mut.sum(1), np.ones(n), atol=1e-3)
    np.testing.assert_allclose(q_mut, q_ora, atol=1e-4)
    y0 = (np.random.RandomState(5).rand(n, 2) > 0.8).astype(np.float32)
    np.testing.assert_allclose(
        vdt.label_propagate(y0, alpha=0.1, n_iters=8).numpy(),
        ora.label_propagate(y0, alpha=0.1, n_iters=8).numpy(), atol=lp_atol)


# ------------------------------------------------- parity with the reference
def test_interleaved_ops_match_reference(fitted_pair):
    div, ref, port = fitted_pair
    ref, port = run_script(ref, port, div, OPS, seed=23)
    assert port.tree.n_points == N0 + 6 - 9 + 4 - 5 + 7 - 3 + 2
    assert_matches_recompute(port)


def test_refine_after_mutation_matches_reference(fitted_pair):
    """Stale-first refinement of a streamed epoch, in both packages."""
    div, ref, port = fitted_pair
    ref, port = run_script(ref, port, div, [("ins", 5), ("del", 4)], seed=3)
    budget = port.n_blocks + 8
    ref.refine(max_blocks=budget)
    port.refine(max_blocks=budget)
    assert port._stream is None
    assert port.n_blocks == ref.n_blocks
    for k in ("a", "b", "active", "refined"):
        np.testing.assert_array_equal(getattr(port.bp, k), getattr(ref.bp, k))
    assert_qstate_close(ref.qstate, port.qstate)
    np.testing.assert_allclose(float(port.sigma), float(ref.sigma), rtol=RTOL)


def test_recompute_matches_reference(fitted_pair):
    from repro.core.streaming import recompute as r_recompute

    div, ref, port = fitted_pair
    ref, port = run_script(ref, port, div, [("del", 6), ("ins", 3)], seed=7)
    r_ora, t_ora = r_recompute(ref), recompute(port)
    for k in ("W", "S1", "S2"):
        assert_state_close(getattr(r_ora.tree, k), getattr(t_ora.tree, k))
    np.testing.assert_array_equal(t_ora.bp.active, r_ora.bp.active)
    assert_qstate_close(r_ora.qstate, t_ora.qstate)


# ------------------------------------------------- the port's own harness
def test_single_insert_and_delete_match_recompute(fitted_pair):
    div, _, vdt0 = fitted_pair
    upd = vdt0.insert_points(make_x(np.random.RandomState(1), 5, div))
    assert upd.touched_blocks > 0 and upd.stale_blocks >= upd.touched_blocks
    assert_matches_recompute(upd.vdt)
    upd2 = upd.vdt.delete_points([0, 3, N0 + 2])
    assert_matches_recompute(upd2.vdt)


def test_exact_backend_matches_true_refit(fitted_pair):
    """Row compaction makes the mutated model's exact LP a refit's."""
    div, _, vdt0 = fitted_pair
    sigma = float(vdt0.sigma)
    rng = np.random.RandomState(31)
    upd = vdt0.delete_points(np.sort(rng.choice(N0, 8, replace=False)))
    vdt = upd.vdt.insert_points(make_x(rng, 6, div)).vdt
    x_final = vdt.x_rows.numpy()
    refit = fit(x_final, div, max_blocks=MAX_BLOCKS, sigma=sigma,
                learn_sigma=False)
    n = x_final.shape[0]
    y0 = (np.random.RandomState(9).rand(n, 2) > 0.8).astype(np.float32)
    np.testing.assert_allclose(
        vdt.label_propagate(y0, alpha=0.1, n_iters=6, backend="exact"),
        refit.label_propagate(y0, alpha=0.1, n_iters=6, backend="exact"),
        atol=1e-5)


def test_copy_on_write_isolation(fitted_pair):
    div, _, vdt0 = fitted_pair
    y0 = (np.random.RandomState(2).rand(N0, 2) > 0.8).astype(np.float32)
    before_lp = vdt0.label_propagate(y0, alpha=0.1, n_iters=6).clone()
    before_x = vdt0.x_rows.clone()
    before_q = vdt0.qstate.log_q.clone()
    upd = vdt0.insert_points(make_x(np.random.RandomState(3), 4, div))
    upd.vdt.delete_points([1, 2])
    assert vdt0.tree.n_points == N0
    assert torch.equal(vdt0.x_rows, before_x)
    assert torch.equal(vdt0.qstate.log_q, before_q)
    assert torch.equal(vdt0.label_propagate(y0, alpha=0.1, n_iters=6),
                       before_lp)
    # the new epoch's tensors are its own, not views of the old epoch's
    assert upd.vdt.tree.x_leaf.data_ptr() != vdt0.tree.x_leaf.data_ptr()


def test_delete_empties_subtree_exactly():
    vdt = fit(make_x(np.random.RandomState(7), 24, "sqeuclidean"),
              max_blocks=80, capacity=32)
    slot_of = vdt.tree.slot_of.numpy()
    rows = np.flatnonzero(slot_of < vdt.tree.n_leaves // 4)  # under node 3
    assert rows.size > 0
    new = vdt.delete_points(rows).vdt
    assert float(new.tree.W[3]) == 0.0
    assert bool((new.tree.S1[3] == 0.0).all()) and float(new.tree.S2[3]) == 0.0
    a, b = new.bp.a[:new.bp.n], new.bp.b[:new.bp.n]
    w = new.tree.W.numpy()
    assert not np.any(new.bp.active[:new.bp.n] & ((w[a] == 0) | (w[b] == 0)))
    assert new.bp.n_active < vdt.bp.n_active
    assert_matches_recompute(new)
    upd2 = new.insert_points(make_x(np.random.RandomState(8), rows.size,
                                    "sqeuclidean"))
    assert upd2.vdt.bp.n_active > new.bp.n_active
    assert_matches_recompute(upd2.vdt)


def test_delete_to_single_point_then_refill():
    rng = np.random.RandomState(13)
    vdt = fit(make_x(rng, 9, "sqeuclidean"), max_blocks=40, capacity=16)
    one = vdt.delete_points(np.arange(8)).vdt
    assert one.tree.n_points == 1
    lp = one.label_propagate(np.ones((1, 2), np.float32), alpha=0.1,
                             n_iters=4)
    assert bool(torch.isfinite(lp).all())
    upd2 = one.insert_points(make_x(rng, 10, "sqeuclidean"))
    assert upd2.vdt.tree.n_points == 11
    assert_matches_recompute(upd2.vdt)


def test_capacity_and_validation_errors():
    rng = np.random.RandomState(19)
    vdt = fit(make_x(rng, 8, "sqeuclidean"), max_blocks=20)
    free = vdt.tree.n_leaves - 8
    with pytest.raises(CapacityError, match="capacity"):
        vdt.insert_points(make_x(rng, free + 1, "sqeuclidean"))
    vdt.delete_points([0, 1]).vdt.insert_points(
        make_x(rng, free + 2, "sqeuclidean"))
    with pytest.raises(ValueError, match="at least one"):
        vdt.delete_points(np.arange(8))
    with pytest.raises(ValueError, match="points"):
        vdt.insert_points(np.zeros((2, DIM + 1), np.float32))
    with pytest.raises(ValueError, match="positive"):
        vdt.insert_points(make_x(rng, 2, "sqeuclidean"), weights=[1.0, -1.0])
    with pytest.raises(ValueError, match="row ids"):
        vdt.delete_points([0, 99])
    with pytest.raises(ValueError, match="empty"):
        vdt.delete_points([])
    kl = fit(make_x(rng, 8, "kl"), "kl", max_blocks=20, capacity=16)
    with pytest.raises(ValueError, match="strictly positive"):
        kl.insert_points(np.full((1, DIM), -1.0, np.float32))


def test_refine_spends_budget_on_stale_blocks_first():
    rng = np.random.RandomState(29)
    vdt = fit(make_x(rng, 40, "sqeuclidean"), max_blocks=90, capacity=64)
    upd = vdt.insert_points(make_x(rng, 6, "sqeuclidean", scale=3.0))
    new = upd.vdt
    assert upd.stale_blocks > 0
    stale = new._stream.stale[:new.bp.n].copy()
    refined_before = new.bp.refined[:new.bp.n].copy()
    before_blocks, before_bound = new.n_blocks, new.bound
    new.refine(max_blocks=before_blocks + 8)
    assert new.n_blocks > before_blocks
    assert np.isfinite(new.bound) and new.bound >= before_bound - 1e-3
    picked = new.bp.refined[:refined_before.size] & ~refined_before
    assert picked.any() and stale[picked].all()
    assert_matches_recompute(new.delete_points([0]).vdt)


def test_insert_weights_carried():
    rng = np.random.RandomState(37)
    vdt = fit(make_x(rng, 12, "sqeuclidean"), max_blocks=40, capacity=32)
    upd = vdt.insert_points(make_x(rng, 3, "sqeuclidean"),
                            weights=[2.0, 0.5, 3.0])
    tree = upd.vdt.tree
    np.testing.assert_allclose(tree.w_leaf[tree.slot_of[upd.rows]].numpy(),
                               [2.0, 0.5, 3.0])
    assert_matches_recompute(upd.vdt, unit_weights=False)


@pytest.mark.slow
@pytest.mark.parametrize("div", DIVERGENCES)
def test_streaming_soak(div):
    """Long interleaved churn per divergence: drift must not accumulate."""
    rng = np.random.RandomState(41)
    vdt = fit(make_x(rng, 96, div), div, max_blocks=320, capacity=192)
    x_mirror = vdt.x_rows.numpy().copy()
    for _ in range(30):
        for kind in ("ins", "del"):
            k = int(rng.randint(1, 9))
            n = vdt.tree.n_points
            if kind == "ins":
                x_new = make_x(rng, k, div)
                vdt = vdt.insert_points(x_new).vdt
                x_mirror = np.vstack([x_mirror, x_new])
            else:
                rows = np.sort(rng.choice(n, k, replace=False))
                vdt = vdt.delete_points(rows).vdt
                x_mirror = np.delete(x_mirror, rows, axis=0)
            np.testing.assert_array_equal(vdt.x_rows.numpy(), x_mirror)
    assert_matches_recompute(vdt, lp_atol=5e-3)


# ------------------------------------------------ publish a streamed epoch
@pytest.fixture(scope="module")
def streamed_pair(small_fitted_vdt):
    """(old model, streamed epoch, its update) with different point counts,
    as ``tests/test_engine.py``'s, in the port."""
    x, ref = small_fitted_vdt
    vdt0 = port_model(ref)
    r = np.random.RandomState(31)
    upd = vdt0.delete_points([2, 7, 11])
    upd = upd.vdt.insert_points(r.randn(5, x.shape[1]).astype(np.float32))
    return vdt0, upd.vdt, upd


def _width2_requests(rng, n, count, **extra):
    return [PropagateRequest((rng.rand(n, 2) > 0.8).astype(np.float32),
                             alpha=float(rng.choice((0.01, 0.2))), n_iters=6,
                             **extra) for _ in range(count)]


@pytest.mark.parametrize("backend", ["vdt", "exact", "grf"])
def test_midflight_publish_preserves_old_epoch_bits(streamed_pair, backend):
    """Entries queued before a publish resolve exactly as on an engine that
    never saw it; those after it as on an engine fitted with the new epoch."""
    vdt0, vdt1, upd = streamed_pair
    n0, n1 = vdt0.tree.n_points, vdt1.tree.n_points
    assert n0 != n1
    kw = dict(start=False, max_batch=4, backend=backend, n_walkers=8,
              grf_seed=7)
    reqs_old = _width2_requests(np.random.RandomState(41), n0, 7)
    reqs_new = _width2_requests(np.random.RandomState(42), n1, 7)

    def control(vdt, reqs):
        eng = PropagateEngine(vdt, **kw)
        futs = [eng.submit(q) for q in reqs]
        eng.flush()
        out = [f.result(timeout=0) for f in futs]
        eng.shutdown()
        return out

    want_old, want_new = control(vdt0, reqs_old), control(vdt1, reqs_new)
    eng = PropagateEngine(vdt0, **kw)
    futs_old = [eng.submit(q) for q in reqs_old]
    assert eng.publish(vdt1, patched_points=upd.patched_points,
                       stale_blocks=upd.stale_blocks) == 1
    m = eng.metrics()
    assert (m.epoch, m.epochs_published, m.live_epochs) == (1, 1, 2)
    assert (m.patched_points, m.stale_blocks) == (upd.patched_points,
                                                  upd.stale_blocks)
    with pytest.raises(ValueError):  # old-N shape no longer valid
        eng.submit(PropagateRequest(np.zeros((n0, 2), np.float32)))
    futs_new = [eng.submit(q) for q in reqs_new]
    eng.flush()
    for f, w in zip(futs_old, want_old):
        np.testing.assert_array_equal(f.result(timeout=0), w)
    for f, w in zip(futs_new, want_new):
        np.testing.assert_array_equal(f.result(timeout=0), w)
    eng.step()
    m = eng.metrics()
    assert m.live_epochs == 1 and m.epochs_retired == 1
    assert all(key[0] == n1 for key in eng.dispatch_state.staging)
    eng.shutdown()


def test_publish_streamed_epoch_matches_reference_engine(small_fitted_vdt):
    """The reference engine publishing its streamed epoch and the port's
    publishing the port's: the same decisions, counters and results."""
    x, ref0 = small_fitted_vdt
    r_upd = ref0.delete_points([2, 7, 11])
    t_upd = port_model(ref0).delete_points([2, 7, 11])
    x_new = np.random.RandomState(31).randn(5, x.shape[1]).astype(np.float32)
    r_upd, t_upd = r_upd.vdt.insert_points(x_new), t_upd.vdt.insert_points(x_new)
    assert_epochs_match(r_upd, t_upd)
    pair = Pair.build(ref0, max_batch=4)
    n0, n1 = ref0.tree.n_points, r_upd.vdt.tree.n_points
    old = [pair.submit(**r) for r in make_requests(12, n0, 5, widths=(2,))]
    eids = (pair.ref.publish(r_upd.vdt, patched_points=r_upd.patched_points,
                             stale_blocks=r_upd.stale_blocks),
            pair.port.publish(t_upd.vdt, patched_points=t_upd.patched_points,
                              stale_blocks=t_upd.stale_blocks))
    assert eids == (1, 1)
    assert_metrics_equal(*pair.call("metrics"))
    new = [pair.submit(**r) for r in make_requests(13, n1, 4, widths=(2,))]
    pair.call("flush")
    pair.call("step")
    assert_outcomes_close([f[0] for f in old + new], [f[1] for f in old + new])
    assert_same_decisions(pair)
    assert_metrics_equal(*pair.call("metrics"))


def test_epoch_pins_released_without_dispatch(streamed_pair):
    from _serving_pair import FakeClock

    vdt0, vdt1, _ = streamed_pair
    clock = FakeClock()
    eng = PropagateEngine(vdt0, start=False, policy="edf", clock=clock)
    y0 = np.zeros((vdt0.tree.n_points, 2), np.float32)
    eng.submit(PropagateRequest(y0, n_iters=2, deadline_ms=10.0))
    dropped = eng.submit(PropagateRequest(y0, n_iters=2))
    eng.publish(vdt1)
    assert eng.metrics().live_epochs == 2
    assert dropped.cancel()
    clock.advance(1.0)  # expires the first while queued
    eng.step()
    m = eng.metrics()
    assert (m.expired, m.cancelled, m.live_epochs, m.epochs_retired) == \
        (1, 1, 1, 1)
    eng.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        eng.publish(vdt1)
