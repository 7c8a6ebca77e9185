"""The GRF backend of the port (``repro_torch``) against the reference, on the CPU.

Two kinds of checks.  Deterministic parity: the reference's uniforms,
``uniform(fold_in(split(PRNGKey(seed), W)[w], t), (2,))`` exactly as its
``walk_step`` draws them, are replayed into the port through ``draw``, so
both packages walk the same walks; then positions and halting are equal and
loads and estimates agree to float32 rounding (``rtol=1e-5, atol=1e-6``;
the feature sums run in another order than the reference's one-hot tiles).
The reference's K5 runs as its own tests run it: the Pallas kernel in
interpret mode (``impl=None``) or its gather oracle (``impl="ref"``).

Statistical checks within the port, with the port's own generator, mirror
``tests/test_grf.py``: every bound comes from ``tests/_stats.py`` (Z = 5,
derived from the sampled spread, never tuned) and every seed is fixed.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import grf as r_grf
from repro.kernels.grf.grf import grf_feature_kernel
from repro.kernels.grf.walkers import walk_step as r_walk_step
from repro_torch.core import grf as t_grf
from repro_torch.core.grf import (CSRGraph, MAX_RTOL_WALKERS,
                                  grf_label_propagate, grf_transition_action,
                                  sample_walks, walkers_for_rtol)
from repro_torch.core.label_prop import (AUTO_EXACT_MAX_N,
                                         AUTO_GRF_MAX_DENSITY,
                                         AUTO_GRF_MIN_RTOL, CONCRETE_BACKENDS,
                                         route_backend)
from repro_torch.kernels.grf import (dense_lp_ref, dense_power_action_ref,
                                     grf_feature_matvec,
                                     grf_feature_matvec_ref, grf_feature_plain,
                                     walk_step)
from repro_torch.kernels.grf.walkers import default_draw, start_state
from test_torch_fit import port_of
from tests._stats import assert_unbiased, assert_variance_decays

N = 24          # the reference harness's graph size
DEG = 4
RTOL, ATOL = 1e-5, 1e-6


def _csr_arrays(rng, n=N, deg=DEG):
    """The reference harness's random sparse digraph, as CSR numpy arrays."""
    indptr = np.arange(n + 1, dtype=np.int64) * deg
    indices = np.concatenate(
        [rng.choice(n, size=deg, replace=False) for _ in range(n)])
    weights = rng.rand(n * deg) + 0.1
    return indptr, indices, weights


@pytest.fixture(scope="module")
def csr():
    return _csr_arrays(np.random.RandomState(11))


@pytest.fixture(scope="module")
def graph(csr):
    return CSRGraph.from_csr(*csr, device="cpu")


@pytest.fixture(scope="module")
def ref_graph(csr):
    return r_grf.CSRGraph.from_csr(*csr)


@pytest.fixture(scope="module")
def dense_p(graph):
    return graph.dense_p()


_uniforms = jax.jit(jax.vmap(
    lambda k, t: jax.random.uniform(jax.random.fold_in(k, t), (2,)),
    in_axes=(0, None)))


def reference_draw(seed: int, w: int):
    """``draw(t)`` replaying the reference's step-t uniforms of its W walkers."""
    keys = jax.random.split(jax.random.PRNGKey(seed), w)
    return lambda t: torch.as_tensor(np.array(_uniforms(keys, t)))


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


# ------------------------------------------- parity under replayed uniforms
@pytest.mark.parametrize("p_halt", [0.0, 0.15])
def test_walk_step_matches_reference(graph, ref_graph, p_halt):
    m, seed = 8, 5
    w = N * m
    keys = jax.random.split(jax.random.PRNGKey(seed), w)
    draw = reference_draw(seed, w)
    pos, load, alive = start_state(N, m, "cpu")
    rpos, rload, ralive = (jnp.asarray(_np(v)) for v in (pos, load, alive))
    for t in range(1, 5):
        pos, load, alive = walk_step(graph.nbr, graph.prob, graph.deg, pos,
                                     load, alive, draw(t), p_halt)
        rpos, rload, ralive = r_walk_step(ref_graph.nbr, ref_graph.prob,
                                          ref_graph.deg, rpos, rload, ralive,
                                          keys, t, p_halt)
        np.testing.assert_array_equal(_np(pos), np.asarray(rpos))
        np.testing.assert_array_equal(_np(alive), np.asarray(ralive))
        np.testing.assert_allclose(_np(load), np.asarray(rload), rtol=1e-6)
    if p_halt:
        assert not alive.all()  # some walkers halted


@pytest.mark.parametrize("p_halt", [0.0, 0.15])
def test_sample_walks_matches_reference(graph, ref_graph, p_halt):
    pos, load = sample_walks(graph, n_steps=4, n_walkers=8, p_halt=p_halt,
                             draw=reference_draw(3, N * 8))
    rpos, rload = r_grf.sample_walks(ref_graph, n_steps=4, n_walkers=8,
                                     seed=3, p_halt=p_halt)
    np.testing.assert_array_equal(_np(pos), np.asarray(rpos))
    np.testing.assert_allclose(_np(load), np.asarray(rload), rtol=1e-6)


@pytest.mark.parametrize("impl", [None, "ref"])
@pytest.mark.parametrize("ndim", [1, 2])
def test_transition_action_matches_reference(graph, ref_graph, impl, ndim):
    rng = np.random.RandomState(13)
    y = rng.randn(N, 3).astype(np.float32)
    y = y[:, 0] if ndim == 1 else y
    est, samples = grf_transition_action(
        graph, y, t=4, n_walkers=32, impl=impl, return_samples=True,
        draw=reference_draw(2, N * 32))
    rest, rsamples = r_grf.grf_transition_action(
        ref_graph, y, t=4, n_walkers=32, seed=2, impl=impl,
        return_samples=True)
    assert est.shape == y.shape
    np.testing.assert_allclose(_np(est), np.asarray(rest), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(_np(samples), np.asarray(rsamples), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("impl", [None, "ref"])
@pytest.mark.parametrize("case", ["1d", "2d_per_column", "3d_per_request",
                                  "halting"])
def test_label_propagate_matches_reference(graph, ref_graph, impl, case):
    rng = np.random.RandomState(6)
    y0 = rng.rand(N, 2).astype(np.float32)
    alpha, p_halt = 0.3, 0.0
    if case == "1d":
        y0 = y0[:, 0]
    elif case == "2d_per_column":
        alpha = np.array([0.05, 0.6], np.float32)
    elif case == "3d_per_request":
        y0 = np.stack([y0, rng.rand(N, 2).astype(np.float32),
                       rng.rand(N, 2).astype(np.float32)])
        alpha = np.array([0.05, 0.2, 0.9], np.float32)
    else:
        p_halt = 0.15
    kw = dict(alpha=alpha, n_iters=6, n_walkers=16, p_halt=p_halt, impl=impl)
    got = grf_label_propagate(graph, y0, draw=reference_draw(12, N * 16),
                              **kw)
    want = r_grf.grf_label_propagate(ref_graph, y0, seed=12, **kw)
    assert got.shape == y0.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("s,m,n,k", [(24, 16, 24, 2), (50, 7, 33, 5),
                                     (10, 400, 40, 3), (9, 33, 300, 1),
                                     (40, 64, 50, 16), (6, 65, 70, 17)])
def test_feature_plain_matches_reference_kernel(s, m, n, k):
    """K5's plain version against the reference's Pallas kernel, interpreted."""
    rng = np.random.RandomState(s + m)
    pos = rng.randint(0, n, (s, m)).astype(np.int32)
    load = rng.rand(s, m).astype(np.float32)
    y = rng.randn(n, k).astype(np.float32)
    want = grf_feature_kernel(jnp.asarray(pos), jnp.asarray(load),
                              jnp.asarray(y), interpret=True)
    got = grf_feature_plain(torch.as_tensor(pos), torch.as_tensor(load),
                            torch.as_tensor(y))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_feature_plain_column_bits_do_not_depend_on_width():
    """Column c of a wide call equals a narrow call of the same column, bit for bit."""
    rng = np.random.RandomState(3)
    pos = torch.as_tensor(rng.randint(0, 40, (30, 70)).astype(np.int32))
    load = torch.as_tensor(rng.rand(30, 70).astype(np.float32))
    y = torch.as_tensor(rng.randn(40, 16).astype(np.float32))
    wide = grf_feature_plain(pos, load, y)
    for c in (0, 7, 15):
        assert torch.equal(wide[:, c:c + 1],
                           grf_feature_plain(pos, load, y[:, c:c + 1]))
    assert torch.equal(wide[:, 4:6], grf_feature_plain(pos, load, y[:, 4:6]))


@pytest.mark.parametrize("m", [64, 400])
def test_feature_plain_fold_parity_at_the_path_widths(m):
    """A folded batch of 8 two-column requests (K = 16, the GRF path's batch)
    gives each request's columns the bits of its K = 2 call, as the kernel
    must; both against the gather-and-mean oracle."""
    rng = np.random.RandomState(m)
    pos = rng.randint(-1, 61, (20, m)).astype(np.int32)
    load = rng.rand(20, m).astype(np.float32)
    y = rng.randn(60, 16).astype(np.float32)
    tp, tl, ty = (torch.as_tensor(a) for a in (pos, load, y))
    wide = grf_feature_plain(tp, tl, ty)
    for b in range(8):
        assert torch.equal(wide[:, 2 * b:2 * b + 2], grf_feature_plain(
            tp, tl, ty[:, 2 * b:2 * b + 2].contiguous()))
    valid = (pos >= 0) & (pos < 60)
    want = grf_feature_matvec_ref(pos * valid, load * valid, y)
    np.testing.assert_allclose(_np(wide), _np(want), rtol=RTOL, atol=ATOL)


def test_csr_arrays_match_reference(csr, graph, ref_graph):
    for port, ref in ((graph, ref_graph),
                      (CSRGraph.from_csr(*csr[:2], device="cpu"),
                       r_grf.CSRGraph.from_csr(*csr[:2]))):
        np.testing.assert_array_equal(_np(port.nbr), np.asarray(ref.nbr))
        np.testing.assert_array_equal(_np(port.prob), np.asarray(ref.prob))
        np.testing.assert_array_equal(_np(port.deg), np.asarray(ref.deg))
        assert (port.n, port.nnz, port.max_deg) == (ref.n, ref.nnz,
                                                    ref.max_deg)
        assert port.density == ref.density
        np.testing.assert_array_equal(port.dense_p(), ref.dense_p())
    p = ref_graph.dense_p()
    back, rback = CSRGraph.from_dense(p, device="cpu"), \
        r_grf.CSRGraph.from_dense(p)
    np.testing.assert_array_equal(_np(back.prob), np.asarray(rback.prob))
    np.testing.assert_array_equal(_np(back.nbr), np.asarray(rback.nbr))


def test_from_points_matches_reference(small_fitted_vdt):
    x, vdt = small_fitted_vdt
    sigma = float(vdt.sigma)
    port = CSRGraph.from_points(x, sigma, device="cpu")
    ref = r_grf.CSRGraph.from_points(x, sigma)
    np.testing.assert_allclose(port.dense_p(), ref.dense_p(), rtol=RTOL,
                               atol=ATOL)
    assert port.nnz == ref.nnz


@pytest.mark.parametrize("args,kwargs,match", [
    (([0, 2, 1], [0, 1]), {}, "monotone"),
    (([0, 1, 1], [0]), {}, "outgoing edge"),
    (([0, 1, 2], [0, 5]), {}, "indices"),
    (([0, 1, 2], [0, 1]), dict(weights=[1.0]), "weights shape"),
    (([0, 1, 2], [0, 1]), dict(weights=[1.0, -1.0]), "finite"),
    (([0, 1, 2], [0, 1]), dict(weights=[1.0, 0.0]), "zero total weight"),
    (([0], []), {}, "indptr"),
])
def test_csr_validation_errors_match_reference(args, kwargs, match):
    with pytest.raises(ValueError, match=match) as ref_err:
        r_grf.CSRGraph.from_csr(*args, **kwargs)
    with pytest.raises(ValueError, match=match) as port_err:
        CSRGraph.from_csr(*args, device="cpu", **kwargs)
    assert str(port_err.value) == str(ref_err.value)


def test_from_dense_rejects_non_square():
    with pytest.raises(ValueError, match="square"):
        CSRGraph.from_dense(np.zeros((2, 3)), device="cpu")


def test_graph_lives_on_the_device_asked_for(csr, monkeypatch):
    assert CSRGraph.from_csr(*csr, device="cpu").device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CSRGraph.from_csr(*csr)  # None means cuda, and there is no card


def test_divergence_gate():
    """As the reference: divergences that are squared Euclidean after their
    point pre-map bridge to a graph, positive-domain ones raise."""
    from repro_torch.core.divergence import mahalanobis

    x = (np.random.RandomState(5).rand(12, 3) + 0.5).astype(np.float32)
    for div in ("kl", "itakura_saito"):
        with pytest.raises(ValueError, match="does not support divergence"):
            CSRGraph.from_points(x, 1.0, divergence=div, device="cpu")
    CSRGraph.from_points(x, 1.0, device="cpu")  # euclidean path is fine
    CSRGraph.from_points(x, 1.0, divergence=mahalanobis([0.5, 1.0, 2.0]),
                         device="cpu")


# ------------------------------------------ statistics with the port's walks
@pytest.mark.parametrize("t", [0, 1, 3, 7])
def test_transition_action_unbiased(graph, dense_p, t):
    rng = np.random.RandomState(100 + t)
    y = rng.randn(N).astype(np.float32)
    oracle = dense_power_action_ref(dense_p, y, t)
    est, samples = grf_transition_action(graph, y, t=t, n_walkers=2048,
                                         seed=t, return_samples=True)
    assert_unbiased(_np(samples), _np(oracle), axis=1,
                    what=f"P^{t} y walker mean")
    np.testing.assert_allclose(_np(est), _np(samples).mean(axis=1),
                               rtol=RTOL, atol=ATOL)


def test_transition_action_unbiased_with_halting(graph, dense_p):
    y = np.random.RandomState(7).randn(N).astype(np.float32)
    oracle = dense_power_action_ref(dense_p, y, 3)
    _, samples = grf_transition_action(graph, y, t=3, n_walkers=4096, seed=5,
                                       p_halt=0.15, return_samples=True)
    assert_unbiased(_np(samples), _np(oracle), axis=1,
                    what="terminating-walk mean")


def test_variance_decays_with_walkers(graph, dense_p):
    y = np.random.RandomState(21).randn(N).astype(np.float32)
    t, reps, m_small, m_big = 3, 24, 8, 64
    oracle = _np(dense_power_action_ref(dense_p, y, t)).astype(np.float64)

    def mses(m):
        return [np.mean((_np(grf_transition_action(
            graph, y, t=t, n_walkers=m, seed=1000 + s)).astype(np.float64)
            - oracle) ** 2) for s in range(reps)]

    assert_variance_decays(mses(m_small), mses(m_big), m_small=m_small,
                           m_big=m_big)


def test_row_stochastic_and_nonnegative(graph):
    ones = np.ones(N, np.float32)
    _, samples = grf_transition_action(graph, ones, t=5, n_walkers=2048,
                                       seed=3, return_samples=True)
    assert_unbiased(_np(samples), ones, axis=1, what="row-sum estimate")
    assert (_np(samples) >= 0.0).all()
    y = np.abs(np.random.RandomState(4).randn(N, 3)).astype(np.float32)
    assert (_np(grf_transition_action(graph, y, t=4, n_walkers=64,
                                      seed=9)) >= 0.0).all()


def test_walk_loads_nonnegative_and_t0_exact(graph):
    pos, load = sample_walks(graph, n_steps=4, n_walkers=16, seed=0)
    pos, load = _np(pos), _np(load)
    assert (load >= 0.0).all()
    assert (pos[:, :, 0] == np.arange(N)[:, None]).all()
    assert (load[:, :, 0] == 1.0).all()


def test_walks_deterministic_and_prefix(graph):
    p1, l1 = sample_walks(graph, n_steps=3, n_walkers=8, seed=42)
    p2, l2 = sample_walks(graph, n_steps=3, n_walkers=8, seed=42)
    assert torch.equal(p1, p2) and torch.equal(l1, l2)
    p7, l7 = sample_walks(graph, n_steps=7, n_walkers=8, seed=42)
    assert torch.equal(p1, p7[:, :, :4]) and torch.equal(l1, l7[:, :, :4])
    p_other, _ = sample_walks(graph, n_steps=3, n_walkers=8, seed=43)
    assert not torch.equal(p1, p_other)


def test_streamed_estimator_walks_the_sampled_walks(graph):
    """``sample_walks`` and the streamed LP consume the same walks per seed."""
    y = np.random.RandomState(2).rand(N, 2).astype(np.float32)
    pos, load = sample_walks(graph, n_steps=1, n_walkers=16, seed=8)
    want = 0.5 * torch.as_tensor(y) + 0.5 * grf_feature_matvec(
        pos[:, :, 1], load[:, :, 1], torch.as_tensor(y))
    got = grf_label_propagate(graph, y, alpha=0.5, n_iters=1, n_walkers=16,
                              seed=8)
    assert torch.equal(got, want)


def test_default_draw_serves_steps_in_order():
    draw = default_draw(0, 4, "cpu")
    assert draw(1).shape == (4, 2)
    with pytest.raises(ValueError, match="in order"):
        draw(3)


def test_label_propagate_deterministic_and_fold_parity(graph):
    rng = np.random.RandomState(6)
    y0a = rng.rand(N, 2).astype(np.float32)
    y0b = rng.rand(N, 2).astype(np.float32)
    kw = dict(n_iters=6, n_walkers=16, seed=12)
    solo_a = grf_label_propagate(graph, y0a, alpha=0.05, **kw)
    assert torch.equal(solo_a, grf_label_propagate(graph, y0a, alpha=0.05,
                                                   **kw))
    solo_b = grf_label_propagate(graph, y0b, alpha=0.2, **kw)
    batched = grf_label_propagate(graph, np.stack([y0a, y0b]),
                                  alpha=np.array([0.05, 0.2]), **kw)
    assert torch.equal(batched[0], solo_a)
    assert torch.equal(batched[1], solo_b)


def test_feature_impls_agree_and_impl_is_checked(graph):
    y = np.random.RandomState(13).randn(N, 3).astype(np.float32)
    a = grf_transition_action(graph, y, t=4, n_walkers=32, seed=2)
    b = grf_transition_action(graph, y, t=4, n_walkers=32, seed=2,
                              impl="ref")
    np.testing.assert_allclose(_np(a), _np(b), rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="impl"):
        grf_transition_action(graph, y, t=1, n_walkers=4, impl="fast")


def test_lp_unbiased_vs_dense_reference(graph, dense_p):
    y0 = np.random.RandomState(17).rand(N, 2).astype(np.float32)
    alpha, n_iters, reps = 0.1, 12, 16
    oracle = _np(dense_lp_ref(dense_p, y0, alpha=alpha, n_iters=n_iters))
    ests = np.stack([_np(grf_label_propagate(
        graph, y0, alpha=alpha, n_iters=n_iters, n_walkers=256, seed=s))
        for s in range(reps)])
    assert_unbiased(ests, oracle, axis=0, what="grf LP vs dense_lp_ref")


def test_lp_alpha_zero_and_zero_iters(graph):
    y0 = np.random.RandomState(8).rand(N, 2).astype(np.float32)
    out0 = grf_label_propagate(graph, y0, alpha=0.0, n_iters=5, n_walkers=4,
                               seed=0)
    np.testing.assert_allclose(_np(out0), y0, rtol=1e-6, atol=1e-6)
    outz = grf_label_propagate(graph, y0, alpha=0.3, n_iters=0, n_walkers=4,
                               seed=0)
    np.testing.assert_allclose(_np(outz), y0, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="n_iters"):
        grf_label_propagate(graph, y0, n_iters=-1)
    with pytest.raises(ValueError, match="per-request alpha"):
        grf_label_propagate(graph, np.stack([y0, y0]), alpha=[0.1, 0.2, 0.3])
    with pytest.raises(ValueError, match="per-column alpha"):
        grf_label_propagate(graph, y0, alpha=[0.1, 0.2, 0.3])


# ------------------------------------------------------- the VDT entry point
@pytest.fixture(scope="module")
def port_vdt(small_fitted_vdt):
    return port_of(small_fitted_vdt[1])


def test_grf_backend_unbiased_vs_exact_backend(small_fitted_vdt, port_vdt):
    x, _ = small_fitted_vdt
    y0 = (np.random.RandomState(23).rand(x.shape[0], 2) > 0.7).astype(
        np.float32)
    alpha, n_iters, reps = 0.1, 6, 16
    want = _np(port_vdt.label_propagate(y0, alpha=alpha, n_iters=n_iters,
                                        backend="exact"))
    ests = np.stack([_np(port_vdt.label_propagate(
        y0, alpha=alpha, n_iters=n_iters, backend="grf", n_walkers=128,
        seed=s)) for s in range(reps)])
    assert_unbiased(ests, want, axis=0, what="grf backend vs exact backend")


def test_grf_backend_matches_reference_backend(small_fitted_vdt, port_vdt):
    """The slice end to end: the bridged graph and the streamed estimate
    against the reference model's ``label_propagate(backend="grf")``."""
    x, vdt = small_fitted_vdt
    n = x.shape[0]
    rng = np.random.RandomState(9)
    y0 = (rng.rand(2, n, 2) > 0.7).astype(np.float32)
    alpha = np.array([0.1, 0.5], np.float32)
    want = vdt.label_propagate(y0, alpha=alpha, n_iters=5, backend="grf",
                               n_walkers=16, seed=4)
    graph = port_vdt.grf_graph()
    np.testing.assert_array_equal(_np(graph.nbr), np.asarray(
        vdt.grf_graph().nbr))
    got = grf_label_propagate(graph, y0, alpha=alpha, n_iters=5,
                              n_walkers=16, draw=reference_draw(4, n * 16))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_grf_backend_deterministic_and_batched_equals_solo(port_vdt):
    n = port_vdt.x_rows.shape[0]
    rng = np.random.RandomState(1)
    ys = (rng.rand(3, n, 2) > 0.7).astype(np.float32)
    alphas = np.array([0.01, 0.3, 0.8], np.float32)
    kw = dict(n_iters=5, backend="grf", n_walkers=8, seed=3)
    batched = port_vdt.label_propagate(ys, alpha=alphas, **kw)
    assert torch.equal(batched, port_vdt.label_propagate(ys, alpha=alphas,
                                                         **kw))
    for b in range(3):
        assert torch.equal(batched[b], port_vdt.label_propagate(
            ys[b], alpha=float(alphas[b]), **kw))
    other = port_vdt.label_propagate(ys, alpha=alphas, **{**kw, "seed": 4})
    assert not torch.equal(batched, other)


def test_grf_graph_matches_exact_matrix_and_is_cached(small_fitted_vdt,
                                                      port_vdt):
    from repro.kernels.fused_lp.ref import dense_transition_ref

    x, vdt = small_fitted_vdt
    want = np.asarray(dense_transition_ref(x, float(vdt.sigma)))
    np.testing.assert_allclose(port_vdt.grf_graph().dense_p(), want,
                               rtol=RTOL, atol=ATOL)
    assert port_vdt.grf_graph() is port_vdt.grf_graph()
    assert port_vdt.grf_graph().device == port_vdt.device


def test_grf_backend_rejects_resume(port_vdt):
    y0 = np.zeros((port_vdt.x_rows.shape[0], 2), np.float32)
    with pytest.raises(ValueError, match="resume"):
        port_vdt.label_propagate_resume(y0, y0, n_iters=2, backend="grf")
    with pytest.raises(ValueError, match="batched"):
        port_vdt.label_propagate(y0, n_iters=2, backend="grf", batched=True)


# ------------------------------------------------------------------ routing
def test_walkers_for_rtol_clt_sizing():
    assert t_grf.DEFAULT_N_WALKERS == r_grf.DEFAULT_N_WALKERS
    assert MAX_RTOL_WALKERS == r_grf.MAX_RTOL_WALKERS
    for rtol in (0.1, 0.05, 1.0, 1e-9, 0.07, 0.33):
        assert walkers_for_rtol(rtol) == r_grf.walkers_for_rtol(rtol)
    assert walkers_for_rtol(0.05) == 400
    assert walkers_for_rtol(1e-9) == MAX_RTOL_WALKERS
    assert walkers_for_rtol(0.07) == math.ceil(1 / 0.07 ** 2)
    for bad in (0.0, -0.1):
        with pytest.raises(ValueError):
            walkers_for_rtol(bad)


def test_route_backend_matches_reference_grid():
    from repro.core import label_prop as r_lp

    assert (AUTO_EXACT_MAX_N, AUTO_GRF_MAX_DENSITY, AUTO_GRF_MIN_RTOL,
            CONCRETE_BACKENDS) == (r_lp.AUTO_EXACT_MAX_N,
                                   r_lp.AUTO_GRF_MAX_DENSITY,
                                   r_lp.AUTO_GRF_MIN_RTOL,
                                   r_lp.CONCRETE_BACKENDS)
    d, r = AUTO_GRF_MAX_DENSITY, AUTO_GRF_MIN_RTOL
    for requested in (None, "auto", "vdt", "exact", "grf"):
        for n in (8, AUTO_EXACT_MAX_N, AUTO_EXACT_MAX_N + 1, 10 ** 6):
            for density in (None, d / 2, d, d * 1.01):
                for rtol in (None, r * 0.99, r, 0.5):
                    kw = dict(n=n, density=density, rtol=rtol)
                    assert route_backend(requested, **kw) == \
                        r_lp.route_backend(requested, **kw), (requested, kw)


def test_route_backend_cases():
    d, r = AUTO_GRF_MAX_DENSITY, AUTO_GRF_MIN_RTOL
    assert route_backend("auto", n=AUTO_EXACT_MAX_N) == "exact"
    assert route_backend("auto", n=AUTO_EXACT_MAX_N + 1) == "vdt"
    assert route_backend("auto", n=2000, auto_exact_max_n=4096) == "exact"
    assert route_backend("auto", n=8, auto_exact_max_n=4) == "vdt"
    assert route_backend("auto", density=d, rtol=r) == "grf"
    assert route_backend("auto", n=10, density=d * 1.01, rtol=r) == "exact"
    assert route_backend("auto", n=10, density=d, rtol=r * 0.99) == "exact"
    assert route_backend("auto", n=2000, density=0.01) == "vdt"
    assert route_backend(None, "grf") == "grf"
    assert route_backend("vdt", density=0.001, rtol=0.5) == "vdt"
    with pytest.raises(ValueError, match="needs the problem size"):
        route_backend("auto")
    with pytest.raises(ValueError, match="backend must be one of"):
        route_backend("dense")


def test_feature_positions_outside_the_graph_contribute_zero():
    """As in the reference's one-hot kernel, whose selector never matches them."""
    rng = np.random.RandomState(4)
    pos = rng.randint(0, 20, (12, 9)).astype(np.int32)
    pos[0, 0], pos[3, 5], pos[7, 8] = -1, 20, 1000
    load = rng.rand(12, 9).astype(np.float32)
    y = rng.randn(20, 3).astype(np.float32)
    want = grf_feature_kernel(jnp.asarray(pos), jnp.asarray(load),
                              jnp.asarray(y), interpret=True)
    got = grf_feature_matvec(torch.as_tensor(pos), torch.as_tensor(load),
                             torch.as_tensor(y))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
