"""The port's Bregman divergences (``repro_torch.core.divergence``) against
the reference's, on the CPU.

The same numpy inputs go through both packages: the registry's generators,
pairwise forms, tiles, log-partition terms, block divergences on bound
statistics and their error messages; then a fit on the reference's tree
(carried across by ``vdt_from_numpy`` with its ``divergence``), its VDT and
exact label propagation; and the plain versions of K1, K2 and K3 on every
divergence tile against the reference's interpreted Pallas kernels over the
divergence grid of ``tests/test_kernels.py``.  Tolerance: ``rtol=1e-4,
atol=1e-5`` (the reference's LP tolerance), identical ``-inf`` patterns.
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blocks as r_blocks
from repro.core import divergence as r_div
from repro.core import qopt as r_qopt
from repro.core import refine as r_refine
from repro.core import sigma as r_sigma
from repro.core import tree as r_tree
from repro.core.vdt import VariationalDualTree as RefVDT
from repro.kernels.fused_lp import fused_lp_matvec as r_matvec
from repro.kernels.fused_lp import fused_lp_scan_batched as r_scan
from repro.kernels.fused_lp import fused_lp_step_batched as r_step
from repro_torch import VariationalDualTree, vdt_from_numpy
from repro_torch.core import blocks as t_blocks
from repro_torch.core import divergence as t_div
from repro_torch.core import qopt as t_qopt
from repro_torch.core import refine as t_refine
from repro_torch.core import sigma as t_sigma
from repro_torch.core.tree import PartitionTree
from repro_torch.kernels.fused_lp import (fused_lp_matvec,
                                          fused_lp_scan_batched,
                                          fused_lp_step_batched, kernel_tile,
                                          tile_config)
from test_torch_fit import (ATOL, RTOL, assert_qstate_close,
                            assert_state_close, reference_state)

# every registered divergence plus a non-trivially-scaled Mahalanobis
ALL_DIVS = ["itakura_saito", "kl", "mahalanobis", "mahalanobis-scaled",
            "sqeuclidean"]
SCALED = "mahalanobis-scaled"


def _pair(name: str, d: int):
    """(reference divergence, port divergence) of one grid name."""
    if name == SCALED:
        scale = np.linspace(0.5, 2.0, d)
        return r_div.mahalanobis(scale), t_div.mahalanobis(scale)
    return r_div.get_divergence(name), t_div.get_divergence(name)


def _points(rng, n: int, d: int) -> np.ndarray:
    """Points inside every registered divergence's domain."""
    return (rng.rand(n, d).astype(np.float32) + 0.1) * 2.0


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


def port_tree(tree) -> PartitionTree:
    """The reference's tree carried into the port, on the CPU."""
    return PartitionTree(
        L=tree.L, n_points=tree.n_points, dim=tree.dim,
        **{k: _t(getattr(tree, k)).to(torch.int64 if k.endswith("_of")
                                      else torch.float32)
           for k in ("x_leaf", "w_leaf", "slot_of", "leaf_of", "W", "S1",
                     "S2")})


def port_model(ref):
    """A reference fit carried into the port with its divergence."""
    state = reference_state(ref)
    div = ref.bound_divergence.div
    if div.name.startswith("mahalanobis["):
        state["divergence"] = _SCALES[div.name]
    else:
        state["divergence"] = div.name
    return vdt_from_numpy(state, device="cpu")


_SCALES = {}  # mahalanobis name -> its scale, for port_model


def _registered_scale(d: int) -> np.ndarray:
    scale = np.linspace(0.5, 2.0, d)
    _SCALES[r_div.mahalanobis(scale).name] = scale
    return scale


# ---------------------------------------------------------- pointwise forms
@pytest.mark.parametrize("name", ALL_DIVS)
def test_pointwise_forms_match_reference(name):
    r = np.random.RandomState(1)
    d = 5
    ref, port = _pair(name, d)
    assert port.name == ref.name
    assert (port.pad_value, port.positive_domain, port.required_dim,
            port.euclidean_after_transform) == (
        ref.pad_value, ref.positive_domain, ref.required_dim,
        ref.euclidean_after_transform)
    a, b = _points(r, 7, d), _points(r, 6, d)
    for got, want in (
            (port.phi(_t(a)), ref.phi(jnp.asarray(a))),
            (port.grad_phi(_t(a)), ref.grad_phi(jnp.asarray(a))),
            (port.pairwise(_t(a), _t(b)), ref.pairwise(jnp.asarray(a),
                                                       jnp.asarray(b))),
            (port.tile(_t(a), _t(b)), ref.tile(jnp.asarray(a),
                                               jnp.asarray(b))),
            (port.transform_points(_t(a)),
             ref.transform_points(jnp.asarray(a)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)
    for dim, sigma in ((d, 0.7), (315, 1.3)):
        np.testing.assert_allclose(
            float(port.log_partition(dim, torch.tensor(sigma))),
            float(ref.log_partition(dim, jnp.asarray(sigma))), rtol=1e-6)


def test_registry_and_names_match_reference():
    assert sorted(t_div.DIVERGENCES) == sorted(r_div.DIVERGENCES)
    for scale in ([0.5, 2.0, 1.5], [1.0, 1.0, 1.0], [1.0], [2.0],
                  np.linspace(0.1, 3.0, 315)):
        assert t_div.mahalanobis(scale).name == r_div.mahalanobis(scale).name
    a, b = t_div.mahalanobis([0.5, 2.0]), t_div.mahalanobis([0.5, 2.0])
    assert a == b and hash(a) == hash(b) and a is not b
    assert a != t_div.mahalanobis([0.5, 2.1])
    for spec in (None, "sqeuclidean", t_div.SQEUCLIDEAN):
        assert t_div.resolve_divergence(spec) is t_div.SQEUCLIDEAN
    with pytest.raises(ValueError, match="unknown divergence"):
        t_div.resolve_divergence("wasserstein")
    with pytest.raises(TypeError):
        t_div.resolve_divergence(1.5)
    with pytest.raises(ValueError, match="strictly positive"):
        t_div.mahalanobis([1.0, -2.0])
    with pytest.raises(ValueError, match="already registered"):
        t_div.register_divergence(t_div.KL)


@pytest.mark.parametrize("name", ["kl", "itakura_saito"])
def test_domain_errors_match_reference(name):
    x = np.random.RandomState(2).randn(16, 3).astype(np.float32)
    messages = []
    for package in (r_div, t_div):
        with pytest.raises(ValueError) as err:
            package.get_divergence(name).validate_domain(x)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    assert "requires strictly positive inputs" in messages[1]
    with pytest.raises(ValueError, match="requires strictly positive inputs"):
        VariationalDualTree.fit(x, divergence=name, device="cpu")


def test_mahalanobis_dim_mismatch_raises_like_reference():
    x = _points(np.random.RandomState(3), 16, 4)
    with pytest.raises(ValueError, match="3-dimensional points, got d=4"):
        VariationalDualTree.fit(x, divergence=t_div.mahalanobis([1., 2., 3.]),
                                device="cpu")


# ------------------------------------------------- block stats and binding
@pytest.mark.parametrize("name", ALL_DIVS)
def test_block_div_on_bound_stats_matches_reference(name):
    d = 4
    x = _points(np.random.RandomState(4), 21, d)  # ghosts must stay invisible
    ref_div, port_div = _pair(name, d)
    rt = r_tree.build_tree(jnp.asarray(x))
    tt = port_tree(rt)
    rb = r_div.bind_divergence(ref_div, rt)
    tb = t_div.bind_divergence(port_div, tt)
    assert (tb.stats is None) == (rb.stats is None)
    if rb.stats is not None:
        for k in ("sphi", "sg", "sgx"):
            np.testing.assert_allclose(getattr(tb.stats, k).numpy(),
                                       np.asarray(getattr(rb.stats, k)),
                                       rtol=RTOL, atol=1e-4, err_msg=k)
    bp = r_blocks.coarsest_partition(rt)
    a, b = bp.a[:bp.n], bp.b[:bp.n]
    np.testing.assert_allclose(
        tb.block_div(tt, _t(a).long(), _t(b).long()).numpy(),
        np.asarray(rb.block_div(rt, jnp.asarray(a), jnp.asarray(b))),
        rtol=RTOL, atol=1e-4)


def test_bind_memo_and_wrong_tree_like_reference():
    r = np.random.RandomState(5)
    t1 = port_tree(r_tree.build_tree(jnp.asarray(_points(r, 17, 3))))
    t2 = port_tree(r_tree.build_tree(jnp.asarray(_points(r, 17, 3))))
    b1 = t_div.bind_divergence("kl", t1)
    assert t_div.bind_divergence("kl", t1) is b1
    assert t_div.bind_divergence(b1, t2) is b1  # bound ones pass through
    assert t_div.bind_divergence("kl", t2) is not b1
    with pytest.raises(ValueError, match="bound to a different tree"):
        b1.block_div(t2, torch.tensor([0]), torch.tensor([1]))
    with pytest.raises(ValueError, match="references another tree"):
        t_div.adopt_bound(t2, b1)
    fit = VariationalDualTree.fit(_points(r, 17, 3), max_blocks=68,
                                  divergence="kl", device="cpu")
    assert t_div.bind_divergence("kl", fit.tree) is fit.bound_divergence


def test_lower_bound_domain_mismatch_and_nonfinite_state_raise():
    r = np.random.RandomState(6)
    x = r.randn(16, 3).astype(np.float32)
    vdt = VariationalDualTree.fit(x, max_blocks=64, device="cpu")
    a, b, act = t_blocks.device_blocks(vdt.bp, "cpu")
    with pytest.raises(ValueError, match="requires strictly positive inputs"):
        t_qopt.lower_bound(vdt.tree, a, b, act, vdt.qstate.log_q, vdt.sigma,
                           divergence="itakura_saito")
    kl = VariationalDualTree.fit(_points(r, 16, 3), max_blocks=64,
                                 divergence="kl", device="cpu")
    kl.qstate = kl.qstate._replace(bound=torch.tensor(float("nan")))
    for call in (kl.dense_q, kl.lower_bound):
        with pytest.raises(ValueError, match="divergence/domain mismatch"):
            call()


# ----------------------------------------------- fit on the reference tree
@pytest.fixture(scope="module", params=["kl", "itakura_saito", "mahalanobis",
                                        SCALED])
def ref_fit(request):
    """(x, reference model) fitted under one divergence, n = 40."""
    d = 4
    x = _points(np.random.RandomState(8), 40, d)
    div = request.param
    if div == SCALED:
        div = r_div.mahalanobis(_registered_scale(d))
    return x, RefVDT.fit(x, max_blocks=4 * 40, capacity=64, divergence=div)


def test_qopt_and_sigma_match_reference_on_its_tree(ref_fit):
    x, ref = ref_fit
    port = port_model(ref)
    assert port.divergence_name == ref.divergence_name
    div_r, div_t = ref.bound_divergence, port.bound_divergence
    ja, jb, jact = (jnp.asarray(v) for v in (ref.bp.a, ref.bp.b, ref.bp.active))
    a, b, active = t_blocks.device_blocks(port.bp, "cpu")
    qs = t_qopt.optimize_q(port.tree, a, b, active, port.sigma,
                           divergence=div_t)
    assert_qstate_close(ref.qstate, qs)
    assert_state_close(
        r_qopt.block_log_G(ref.tree, ja, jb, jact, ref.sigma, divergence=div_r),
        t_qopt.block_log_G(port.tree, a, b, active, port.sigma,
                           divergence=div_t))
    np.testing.assert_allclose(float(port.lower_bound()),
                               float(ref.lower_bound()), rtol=RTOL)

    bp = r_blocks.coarsest_partition(ref.tree)
    ja, jb, jact = (jnp.asarray(v) for v in (bp.a, bp.b, bp.active))
    a, b, active = t_blocks.device_blocks(bp, "cpu")
    s0 = float(r_sigma.sigma_init(jnp.asarray(x)))
    r_sig, r_qs, r_its = r_sigma.fit_sigma_q(ref.tree, ja, jb, jact, s0,
                                             divergence=div_r)
    t_sig, t_qs, t_its = t_sigma.fit_sigma_q(port.tree, a, b, active, s0,
                                             divergence=div_t)
    assert t_its == r_its
    np.testing.assert_allclose(float(t_sig), float(r_sig), rtol=RTOL)
    assert_qstate_close(r_qs, t_qs)


def test_refinement_matches_reference_on_its_tree(ref_fit):
    _, ref = ref_fit
    port = port_model(ref)
    n = ref.tree.n_points
    bp0 = r_blocks.coarsest_partition(ref.tree, cap=int(2.5 * 5 * n))
    r_bp, t_bp = copy.deepcopy(bp0), copy.deepcopy(bp0)
    sig = float(ref.sigma)
    ja, jb, jact = (jnp.asarray(v) for v in (bp0.a, bp0.b, bp0.active))
    a, b, active = t_blocks.device_blocks(bp0, "cpu")
    r_qs0 = r_qopt.optimize_q(ref.tree, ja, jb, jact, sig,
                              divergence=ref.bound_divergence)
    t_qs0 = t_qopt.optimize_q(port.tree, a, b, active, torch.tensor(sig),
                              divergence=port.bound_divergence)
    assert_state_close(
        r_refine.refinement_gains(ref.tree, ja, jb, jact, r_qs0.log_q, sig,
                                  divergence=ref.bound_divergence),
        t_refine.refinement_gains(port.tree, a, b, active, t_qs0.log_q,
                                  torch.tensor(sig),
                                  divergence=port.bound_divergence))
    r_qs, r_sig = r_refine.refine_to_budget(
        r_bp, ref.tree, sig, 5 * n, batch=16, refit_sigma=True,
        divergence=ref.bound_divergence)
    t_qs, t_sig = t_refine.refine_to_budget(
        t_bp, port.tree, torch.tensor(sig), 5 * n, batch=16, refit_sigma=True,
        divergence=port.bound_divergence)
    np.testing.assert_allclose(float(t_sig), float(r_sig), rtol=RTOL)
    for k in ("a", "b", "mirror", "active", "refined"):
        np.testing.assert_array_equal(getattr(t_bp, k), getattr(r_bp, k))
    assert_qstate_close(r_qs, t_qs)


def test_carried_model_serves_like_reference(ref_fit):
    """Dense Q, the VDT matvec, VDT LP and exact LP (batched, per-request
    alpha) of the carried model against the reference model."""
    _, ref = ref_fit
    port = port_model(ref)
    n = ref.tree.n_points
    np.testing.assert_allclose(port.dense_q(), ref.dense_q(), rtol=RTOL,
                               atol=ATOL)
    r = np.random.RandomState(9)
    y = r.rand(n, 3).astype(np.float32)
    np.testing.assert_allclose(port.matvec(y).numpy(),
                               np.asarray(ref.matvec(jnp.asarray(y))),
                               rtol=RTOL, atol=ATOL)
    y0s = (r.rand(2, n, 2) > 0.7).astype(np.float32)
    alphas = np.array([0.1, 0.4], np.float32)
    for backend in ("vdt", "exact"):
        np.testing.assert_allclose(
            port.label_propagate(y0s, alpha=alphas, n_iters=6,
                                 backend=backend).numpy(),
            np.asarray(ref.label_propagate(y0s, alpha=alphas, n_iters=6,
                                           backend=backend)),
            rtol=RTOL, atol=ATOL, err_msg=backend)


@pytest.mark.parametrize("name", ["kl", "itakura_saito", SCALED])
def test_own_fit_matches_reference(name):
    """The port's own pipeline, tree build included, under a divergence."""
    d = 4
    x = _points(np.random.RandomState(10), 33, d)
    div_r, div_t = _pair(name, d)
    ref = RefVDT.fit(x, max_blocks=4 * 33, divergence=div_r)
    port = VariationalDualTree.fit(x, max_blocks=4 * 33, divergence=div_t,
                                   device="cpu")
    assert port.divergence_name == ref.divergence_name == div_r.name
    assert port.stats.divergence == div_r.name
    assert port.n_blocks == ref.n_blocks
    np.testing.assert_allclose(float(port.sigma), float(ref.sigma), rtol=RTOL)
    np.testing.assert_allclose(port.bound, ref.bound, rtol=RTOL)
    np.testing.assert_allclose(port.dense_q(), ref.dense_q(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(port.dense_q().sum(1), np.ones(33), rtol=5e-5)


def test_grf_bridge_takes_mahalanobis_and_refuses_kl():
    """``CSRGraph.from_points`` follows ``euclidean_after_transform``."""
    from repro.core.grf import CSRGraph as RefGraph
    from repro_torch.core.grf import CSRGraph

    d = 3
    x = _points(np.random.RandomState(11), 24, d)
    ref_m, port_m = _pair(SCALED, d)
    got = CSRGraph.from_points(x, 0.8, divergence=port_m, device="cpu")
    want = RefGraph.from_points(jnp.asarray(x), 0.8, divergence=ref_m)
    np.testing.assert_allclose(got.dense_p(), want.dense_p(), rtol=RTOL,
                               atol=ATOL)
    for name in ("kl", "itakura_saito"):
        with pytest.raises(ValueError, match="does not support divergence"):
            CSRGraph.from_points(x, 0.8, divergence=name, device="cpu")


# ---------------------------------------------- the fused kernels' tiles
@pytest.mark.parametrize("divergence", ["sqeuclidean", "kl", "itakura_saito",
                                        SCALED])
@pytest.mark.parametrize("b,c,n", [
    (2, 2, 33), (3, 1, 41),
    pytest.param(4, 3, 129, marks=pytest.mark.slow),
    pytest.param(8, 2, 257, marks=pytest.mark.slow),
])
def test_divergence_kernel_grid_matches_interpreted_pallas(divergence, b, c,
                                                           n):
    """The plain versions of K1 (folded step, scan), K3 (per-batch step) and
    K2 (matvec) on each divergence tile against the reference's interpreted
    Pallas kernels, odd N (the reference pads with the divergence's pad
    value; the plain versions slice ragged tiles)."""
    d = 5
    ref_div, port_div = _pair(divergence, d)
    r = np.random.RandomState(n + b)
    x = (r.rand(n, d) + 0.1).astype(np.float32)
    y = r.rand(b, n, c).astype(np.float32)
    y0 = r.rand(b, n, c).astype(np.float32)
    xj, yj, y0j = jnp.asarray(x), jnp.asarray(y), jnp.asarray(y0)
    xt, yt, y0t = _t(x), _t(y), _t(y0)
    for reuse in (True, False):
        want = r_step(xj, yj, y0j, 1.0, 0.1, block_m=16, block_n=16,
                      reuse=reuse, divergence=ref_div)
        got = fused_lp_step_batched(xt, yt, y0t, 1.0, 0.1, reuse=reuse,
                                    divergence=port_div)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL, err_msg=f"reuse={reuse}")
    alphas = np.linspace(0.05, 0.5, b).astype(np.float32)
    np.testing.assert_allclose(
        fused_lp_scan_batched(xt, y0t, 1.0, _t(alphas), 3,
                              divergence=port_div).numpy(),
        np.asarray(r_scan(xj, y0j, 1.0, jnp.asarray(alphas), 3, block_m=16,
                          block_n=16, divergence=ref_div)),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        fused_lp_matvec(xt, yt[0], 1.0, divergence=port_div).numpy(),
        np.asarray(r_matvec(xj, yj[0], 1.0, block_m=16, block_n=16,
                            divergence=ref_div)),
        rtol=RTOL, atol=ATOL)


def test_tile_config_and_kernel_tiles():
    """Which tile the CUDA kernels run per divergence; a divergence with no
    hand-written tile is refused for the card by name, while its plain
    version runs on the CPU."""
    for name, tile in (("sqeuclidean", "sqeuclidean"), ("mahalanobis",
                                                        "sqeuclidean"),
                       ("kl", "kl"), ("itakura_saito", "itakura_saito")):
        spec, pad, transform = tile_config(name)
        assert kernel_tile(spec) == tile
        assert pad == r_div.get_divergence(name).pad_value
        assert (transform is None) == (name == "sqeuclidean")
    custom = t_div.Divergence(
        name="sq_plus_one", _phi=lambda x: (x * x).sum(-1),
        _grad_phi=lambda x: 2.0 * x,
        _pairwise=lambda a, b: t_div.SQEUCLIDEAN._pairwise(a, b) + 1.0,
        _log_partition=lambda dim, s: torch.log(torch.as_tensor(s)))
    spec, _, _ = tile_config(custom)
    with pytest.raises(NotImplementedError, match="no tile for divergence"):
        kernel_tile(spec)
    x = _points(np.random.RandomState(12), 30, 3)
    y = np.random.RandomState(13).rand(30, 2).astype(np.float32)
    ref_custom = r_div.Divergence(
        name="sq_plus_one", _phi=lambda v: (v * v).sum(-1),
        _grad_phi=lambda v: 2.0 * v,
        _pairwise=lambda a, b: r_div._sqe_pairwise(a, b) + 1.0,
        _log_partition=r_div._gaussian_log_partition)
    np.testing.assert_allclose(
        fused_lp_matvec(_t(x), _t(y), 1.0, divergence=custom).numpy(),
        np.asarray(r_matvec(jnp.asarray(x), jnp.asarray(y), 1.0, block_m=16,
                            block_n=16, divergence=ref_custom)),
        rtol=RTOL, atol=ATOL)
