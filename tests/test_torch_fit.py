"""The port's fit (``repro_torch``) against the reference (``repro``) on the CPU.

The same numpy inputs go through both packages.  The later stages are held
against the reference on the reference's own tree, carried across by
``vdt_from_numpy``; the port's own tree build is compared too.  Tolerances
are the reference's LP tolerance, ``rtol=1e-4, atol=1e-5``, and the ``-inf``
patterns of the q-state must be identical.
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blocks as r_blocks
from repro.core import qopt as r_qopt
from repro.core import refine as r_refine
from repro.core import sigma as r_sigma
from repro.core import tree as r_tree
from repro_torch import VariationalDualTree, vdt_from_numpy
from repro_torch.core import blocks as t_blocks
from repro_torch.core import qopt as t_qopt
from repro_torch.core import refine as t_refine
from repro_torch.core import sigma as t_sigma
from repro_torch.core import tree as t_tree

RTOL, ATOL = 1e-4, 1e-5


def reference_state(vdt) -> dict:
    """The reference model's fitted state as plain numpy (``STATE_KEYS``)."""
    t, bp, qs = vdt.tree, vdt.bp, vdt.qstate
    state = dict(L=t.L, n_points=t.n_points, dim=t.dim, n=bp.n, cap=bp.cap,
                 sigma=np.asarray(vdt.sigma))
    for k in ("x_leaf", "w_leaf", "slot_of", "leaf_of", "W", "S1", "S2"):
        state[k] = np.asarray(getattr(t, k))
    for k in ("a", "b", "mirror", "active", "refined"):
        state[k] = getattr(bp, k).copy()
    for k in qs._fields:
        state[k] = np.asarray(getattr(qs, k))
    return state


def port_of(vdt):
    """The reference model carried into the port, on the CPU."""
    return vdt_from_numpy(reference_state(vdt), device="cpu")


def assert_state_close(ref, port) -> None:
    """Equal ``-inf``/``+inf`` patterns and finite entries within tolerance."""
    ref = np.asarray(ref)
    port = port.detach().cpu().numpy() if isinstance(port, torch.Tensor) \
        else np.asarray(port)
    assert ref.shape == port.shape
    np.testing.assert_array_equal(np.isneginf(ref), np.isneginf(port))
    np.testing.assert_array_equal(np.isposinf(ref), np.isposinf(port))
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(fin, np.isfinite(port))
    np.testing.assert_allclose(port[fin], ref[fin], rtol=RTOL, atol=ATOL)


def assert_qstate_close(ref_qs, port_qs) -> None:
    for name in r_qopt.QState._fields:
        assert_state_close(getattr(ref_qs, name), getattr(port_qs, name))


def _fixture(request, name):
    out = request.getfixturevalue(name)
    return out[0], out[-1]  # (x, fitted reference vdt)


FIXTURES = ["small_fitted_vdt", "separated_clusters_vdt"]


# ------------------------------------------------------------------- tree
@pytest.mark.parametrize("n,d,capacity,weighted", [
    (33, 4, None, False), (50, 3, 100, False), (64, 5, None, True),
])
def test_build_tree_matches_reference(n, d, capacity, weighted):
    r = np.random.RandomState(n)
    x = r.randn(n, d).astype(np.float32)
    w = r.uniform(0.5, 2.0, n).astype(np.float32) if weighted else None
    ref = r_tree.build_tree(jnp.asarray(x), None if w is None else jnp.asarray(w),
                            capacity=capacity)
    port = t_tree.build_tree(torch.as_tensor(x),
                             None if w is None else torch.as_tensor(w),
                             capacity=capacity)
    assert (port.L, port.n_points, port.dim) == (ref.L, ref.n_points, ref.dim)
    np.testing.assert_array_equal(port.leaf_of.numpy(), np.asarray(ref.leaf_of))
    np.testing.assert_array_equal(port.slot_of.numpy(), np.asarray(ref.slot_of))
    for k in ("x_leaf", "w_leaf", "W", "S1", "S2"):
        np.testing.assert_allclose(getattr(port, k).numpy(),
                                   np.asarray(getattr(ref, k)),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_build_tree_rejects_small_capacity():
    with pytest.raises(ValueError, match="capacity"):
        t_tree.build_tree(torch.zeros(8, 2), capacity=4)


def test_tree_index_helpers_match_reference():
    ids = np.arange(63)
    np.testing.assert_array_equal(t_tree.node_level(ids), r_tree.node_level(ids))
    for lvl in range(6):
        assert t_tree.level_slice(lvl) == r_tree.level_slice(lvl)
    for node in range(63):
        assert t_tree.leaf_range(node, 5) == r_tree.leaf_range(node, 5)


# ----------------------------------------------------------------- blocks
@pytest.mark.parametrize("fixture", FIXTURES)
def test_coarsest_partition_matches_reference(request, fixture):
    _, ref = _fixture(request, fixture)
    port = port_of(ref)
    want = r_blocks.coarsest_partition(ref.tree)
    got = t_blocks.coarsest_partition(port.tree)
    for k in ("a", "b", "mirror", "active", "refined"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    assert (got.n, got.cap) == (want.n, want.cap)
    assert t_blocks.validate_partition(got, port.tree)
    assert t_blocks.mirror_invariant_ok(got)
    np.testing.assert_array_equal(t_blocks.levels_of(got),
                                  r_blocks.levels_of(want))


# ------------------------------------------------------------ qopt, sigma
@pytest.mark.parametrize("fixture", FIXTURES)
def test_optimize_q_matches_reference_on_its_tree(request, fixture):
    _, ref = _fixture(request, fixture)
    port = port_of(ref)
    a, b, active = t_blocks.device_blocks(port.bp, "cpu")
    qs = t_qopt.optimize_q(port.tree, a, b, active, port.sigma)
    assert_qstate_close(ref.qstate, qs)
    ja, jb, jact = (jnp.asarray(v) for v in (ref.bp.a, ref.bp.b, ref.bp.active))
    assert_state_close(r_qopt.block_log_G(ref.tree, ja, jb, jact, ref.sigma),
                       t_qopt.block_log_G(port.tree, a, b, active, port.sigma))
    np.testing.assert_allclose(
        float(t_qopt.lower_bound(port.tree, a, b, active, qs.log_q, port.sigma)),
        float(r_qopt.lower_bound(ref.tree, ja, jb, jact, ref.qstate.log_q,
                                 ref.sigma)), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fixture", FIXTURES)
def test_sigma_fit_matches_reference_on_its_tree(request, fixture):
    x, ref = _fixture(request, fixture)
    port = port_of(ref)
    np.testing.assert_allclose(float(t_sigma.sigma_init(torch.as_tensor(x))),
                               float(r_sigma.sigma_init(jnp.asarray(x))),
                               rtol=RTOL)
    bp = r_blocks.coarsest_partition(ref.tree)
    ja, jb, jact = (jnp.asarray(v) for v in (bp.a, bp.b, bp.active))
    a, b, active = t_blocks.device_blocks(bp, "cpu")
    s0 = float(r_sigma.sigma_init(jnp.asarray(x)))
    r_sig, r_qs, r_its = r_sigma.fit_sigma_q(ref.tree, ja, jb, jact, s0)
    t_sig, t_qs, t_its = t_sigma.fit_sigma_q(port.tree, a, b, active, s0)
    assert t_its == r_its
    np.testing.assert_allclose(float(t_sig), float(r_sig), rtol=RTOL)
    assert_qstate_close(r_qs, t_qs)
    np.testing.assert_allclose(
        float(t_sigma.sigma_star(port.tree, a, b, active, t_qs.log_q)),
        float(r_sigma.sigma_star(ref.tree, ja, jb, jact, r_qs.log_q)),
        rtol=RTOL)


# ----------------------------------------------------------------- refine
@pytest.mark.parametrize("batch,refit_sigma", [(16, False), (64, True)])
@pytest.mark.parametrize("fixture", FIXTURES)
def test_refinement_matches_reference_on_its_tree(request, fixture, batch,
                                                   refit_sigma):
    _, ref = _fixture(request, fixture)
    port = port_of(ref)
    n = ref.tree.n_points
    bp0 = r_blocks.coarsest_partition(ref.tree, cap=int(2.5 * 5 * n))
    sig = float(ref.sigma)
    r_bp, t_bp = copy.deepcopy(bp0), copy.deepcopy(bp0)

    ja, jb, jact = (jnp.asarray(v) for v in (bp0.a, bp0.b, bp0.active))
    r_qs0 = r_qopt.optimize_q(ref.tree, ja, jb, jact, sig)
    a, b, active = t_blocks.device_blocks(bp0, "cpu")
    t_sig = torch.tensor(sig)
    t_qs0 = t_qopt.optimize_q(port.tree, a, b, active, t_sig)
    assert_state_close(
        r_refine.refinement_gains(ref.tree, ja, jb, jact, r_qs0.log_q, sig),
        t_refine.refinement_gains(port.tree, a, b, active, t_qs0.log_q, t_sig))

    r_qs, r_sig = r_refine.refine_to_budget(r_bp, ref.tree, sig, 5 * n,
                                            batch=batch,
                                            refit_sigma=refit_sigma)
    t_qs, t_sig = t_refine.refine_to_budget(t_bp, port.tree, t_sig, 5 * n,
                                            batch=batch,
                                            refit_sigma=refit_sigma)
    np.testing.assert_allclose(float(t_sig), float(r_sig), rtol=RTOL)
    for k in ("a", "b", "mirror", "active", "refined"):
        np.testing.assert_array_equal(getattr(t_bp, k), getattr(r_bp, k))
    assert_qstate_close(r_qs, t_qs)
    q_ref = r_blocks.densify_q(r_bp, ref.tree, np.asarray(
        jnp.where(jnp.isfinite(r_qs.log_q), jnp.exp(r_qs.log_q), 0.0)))
    q_port = t_blocks.densify_q(t_bp, port.tree, np.where(
        np.isfinite(t_qs.log_q.numpy()), np.exp(t_qs.log_q.numpy()), 0.0))
    np.testing.assert_allclose(q_port, q_ref, rtol=RTOL, atol=ATOL)


def test_refine_topk_stale_first_matches_reference(small_fitted_vdt):
    _, ref = small_fitted_vdt
    port = port_of(ref)
    bp0 = r_blocks.coarsest_partition(ref.tree)
    ja, jb, jact = (jnp.asarray(v) for v in (bp0.a, bp0.b, bp0.active))
    qs = r_qopt.optimize_q(ref.tree, ja, jb, jact, ref.sigma)
    gains = np.asarray(r_refine.refinement_gains(ref.tree, ja, jb, jact,
                                                 qs.log_q, ref.sigma))
    stale = np.zeros(bp0.n, bool)
    stale[::5] = True
    r_bp, t_bp = copy.deepcopy(bp0), copy.deepcopy(bp0)
    r_stale, t_stale = stale.copy(), stale.copy()
    assert (t_refine.refine_topk(t_bp, port.tree, gains, 4, stale=t_stale)
            == r_refine.refine_topk(r_bp, ref.tree, gains, 4, stale=r_stale))
    np.testing.assert_array_equal(t_stale, r_stale)
    for k in ("a", "b", "active", "refined"):
        np.testing.assert_array_equal(getattr(t_bp, k), getattr(r_bp, k))


# -------------------------------------------------------------- whole fit
@pytest.mark.parametrize("fixture,budget", [("small_fitted_vdt", 4),
                                            ("separated_clusters_vdt", 6)])
def test_fit_matches_reference(request, fixture, budget):
    """The port's own pipeline, tree build included, on the CPU.

    The port's tree statistics differ from the reference's in the last ulps,
    so refinement may pick blocks tied within rounding in another order:
    the block layout is compared on the reference's tree (above), and here
    what it determines — Q, sigma, the bound.
    """
    x, ref = _fixture(request, fixture)
    n = x.shape[0]
    port = VariationalDualTree.fit(x, max_blocks=budget * n, device="cpu")
    assert port.device == torch.device("cpu")
    assert port.n_blocks == ref.n_blocks
    assert port.stats.sigma_iters == ref.stats.sigma_iters
    np.testing.assert_allclose(float(port.sigma), float(ref.sigma), rtol=RTOL)
    np.testing.assert_allclose(port.bound, ref.bound, rtol=RTOL)
    np.testing.assert_allclose(port.dense_q(), ref.dense_q(),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(port.lower_bound()),
                               float(ref.lower_bound()), rtol=RTOL)


@pytest.mark.parametrize("fixture", FIXTURES)
def test_carried_state_matches_reference(request, fixture):
    _, ref = _fixture(request, fixture)
    port = port_of(ref)
    assert port.n_blocks == ref.n_blocks
    np.testing.assert_allclose(port.dense_q(), ref.dense_q(),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(port.lower_bound()),
                               float(ref.lower_bound()), rtol=RTOL)
    np.testing.assert_allclose(port.x_rows.numpy(), np.asarray(ref.x_rows))


def test_refine_in_place_matches_reference(small_fitted_vdt):
    _, ref = small_fitted_vdt
    ref = copy.deepcopy(ref)
    port = port_of(ref)
    n = ref.tree.n_points
    ref.refine(6 * n, batch=8)
    port.refine(6 * n, batch=8)
    assert port.n_blocks == ref.n_blocks
    np.testing.assert_allclose(port.dense_q(), ref.dense_q(),
                               rtol=RTOL, atol=ATOL)


def test_model_to_device_copies(small_fitted_vdt):
    _, ref = small_fitted_vdt
    port = port_of(ref)
    moved = port.to("cpu")
    assert moved.bp is not port.bp
    np.testing.assert_array_equal(moved.dense_q(), port.dense_q())
    y0 = np.eye(ref.tree.n_points, 3, dtype=np.float32)
    torch.testing.assert_close(moved.label_propagate(y0, n_iters=5),
                               port.label_propagate(y0, n_iters=5),
                               rtol=0, atol=0)
