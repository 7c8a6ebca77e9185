"""The port's matvec and label propagation against the reference, on the CPU.

Both backends run on the reference's fitted state carried into the port
(``vdt_from_numpy``), on the same numpy inputs, at ``rtol=1e-4, atol=1e-5``.
Within the port, segmented walks equal monolithic ones bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import label_prop as r_lp
from repro.core import matvec as r_mv
from repro_torch import VariationalDualTree, ccr, one_hot_labels
from repro_torch.core import label_prop as t_lp
from repro_torch.core import matvec as t_mv
from test_torch_fit import port_of

RTOL, ATOL = 1e-4, 1e-5
FIXTURES = ["small_fitted_vdt", "separated_clusters_vdt"]


def _ref(request, name):
    return request.getfixturevalue(name)[-1]


def _close(port, ref):
    np.testing.assert_allclose(port.detach().cpu().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


def _seeds(n, c=2, batch=3, seed=0):
    r = np.random.RandomState(seed)
    y0 = np.zeros((n, c), np.float32)
    y0[np.arange(n), r.randint(0, c, n)] = 1.0
    y0 *= (r.rand(n) < 0.3)[:, None]
    ys = np.stack([np.roll(y0, i, axis=0) for i in range(batch)])
    return y0, ys


# ----------------------------------------------------------------- matvec
def test_fold_unfold_match_reference():
    ys = np.random.RandomState(1).randn(3, 7, 2).astype(np.float32)
    folded = t_mv.fold_batch(torch.as_tensor(ys))
    _close(folded, r_mv.fold_batch(jnp.asarray(ys)))
    torch.testing.assert_close(t_mv.unfold_batch(folded, 3, 2),
                               torch.as_tensor(ys), rtol=0, atol=0)


@pytest.mark.parametrize("fixture", FIXTURES)
def test_collect_up_and_leaforder_matvec_match_reference(request, fixture):
    ref = _ref(request, fixture)
    port = port_of(ref)
    L, n_leaves = ref.tree.L, ref.tree.n_leaves
    y_leaf = np.random.RandomState(2).randn(n_leaves, 3).astype(np.float32)
    _close(t_mv.collect_up(torch.as_tensor(y_leaf), L),
           r_mv.collect_up(jnp.asarray(y_leaf), L))
    a, b, _, q, _ = port._dispatch_buffers()
    ra, rb, _, rq, _ = ref._dispatch_buffers()
    _close(t_mv.mpt_matvec_leaforder(torch.as_tensor(y_leaf), a, b, q, L),
           r_mv.mpt_matvec_leaforder(jnp.asarray(y_leaf), ra, rb, rq, L))


@pytest.mark.parametrize("shape", [(None,), (2,), (3, 2)], ids=["1d", "2d", "3d"])
@pytest.mark.parametrize("fixture", FIXTURES)
def test_matvec_matches_reference(request, fixture, shape):
    ref = _ref(request, fixture)
    port = port_of(ref)
    n = ref.tree.n_points
    full = {(None,): (n,), (2,): (n, 2), (3, 2): (3, n, 2)}[shape]
    y = np.random.RandomState(3).randn(*full).astype(np.float32)
    _close(port.matvec(y), ref.matvec(y))
    if len(full) == 3:
        _close(port.matvec_batched(y), ref.matvec_batched(y))
        with pytest.raises(ValueError, match="batch"):
            port.matvec_batched(y[0])


# ---------------------------------------------------------- VDT backend
@pytest.mark.parametrize("alpha", ["scalar", "per_column"])
@pytest.mark.parametrize("fixture", FIXTURES)
def test_lp_scan_leaforder_matches_reference(request, fixture, alpha):
    ref = _ref(request, fixture)
    port = port_of(ref)
    n_leaves, L = ref.tree.n_leaves, ref.tree.L
    y0, _ = _seeds(ref.tree.n_points)
    al = np.float32(0.2) if alpha == "scalar" else np.array([0.1, 0.6],
                                                             np.float32)
    a, b, _, q, mask = port._dispatch_buffers()
    ra, rb, _, rq, rmask = ref._dispatch_buffers()
    y0_leaf = np.zeros((n_leaves, 2), np.float32)
    y0_leaf[np.asarray(ref.tree.slot_of)] = y0
    got = t_lp.lp_scan_leaforder(torch.as_tensor(y0_leaf), mask, a, b, q,
                                 torch.as_tensor(al), L, 9)
    want = r_lp.lp_scan_leaforder(jnp.asarray(y0_leaf), rmask, ra, rb, rq,
                                  jnp.asarray(al), L, 9)
    _close(got, want)
    mid = t_lp.lp_scan_leaforder(torch.as_tensor(y0_leaf), mask, a, b, q,
                                 torch.as_tensor(al), L, 4)
    resumed = t_lp.lp_scan_leaforder_resume(mid, torch.as_tensor(y0_leaf),
                                            mask, a, b, q, torch.as_tensor(al),
                                            L, 5)
    _close(resumed, r_lp.lp_scan_leaforder_resume(
        jnp.asarray(mid.numpy()), jnp.asarray(y0_leaf), rmask, ra, rb, rq,
        jnp.asarray(al), L, 5))
    for seg in (1, 4, 9, 20):
        segmented = t_lp.lp_scan_leaforder_segmented(
            torch.as_tensor(y0_leaf), mask, a, b, q, torch.as_tensor(al), L, 9,
            seg)
        torch.testing.assert_close(segmented, got, rtol=0, atol=0)


@pytest.mark.parametrize("fixture", FIXTURES)
def test_vdt_label_propagate_matches_reference(request, fixture):
    ref = _ref(request, fixture)
    port = port_of(ref)
    y0, ys = _seeds(ref.tree.n_points)
    alphas = np.array([0.05, 0.3, 0.9], np.float32)
    _close(port.label_propagate(y0, alpha=0.1, n_iters=15),
           ref.label_propagate(y0, alpha=0.1, n_iters=15))
    _close(port.label_propagate(y0[:, 0], alpha=0.1, n_iters=15),
           ref.label_propagate(y0[:, 0], alpha=0.1, n_iters=15))
    _close(port.label_propagate(ys, alpha=alphas, n_iters=15),
           ref.label_propagate(ys, alpha=alphas, n_iters=15))
    mid = port.label_propagate(ys, alpha=alphas, n_iters=6).numpy()
    _close(port.label_propagate_resume(mid, ys, alpha=alphas, n_iters=9),
           ref.label_propagate_resume(mid, ys, alpha=alphas, n_iters=9))


def test_label_propagate_rejects_bad_requests(small_fitted_vdt):
    port = port_of(small_fitted_vdt[-1])
    y0, ys = _seeds(port.tree.n_points)
    with pytest.raises(ValueError, match="per-request alpha"):
        port.label_propagate(ys, alpha=np.ones(2, np.float32), n_iters=2)
    with pytest.raises(ValueError, match="per-request alpha"):
        port.label_propagate(ys, alpha=np.ones(2, np.float32), n_iters=2,
                             backend="exact")
    with pytest.raises(ValueError, match="batched"):
        port.label_propagate(y0, batched=True)
    with pytest.raises(ValueError, match="carry shape"):
        port.label_propagate_resume(ys, y0)
    with pytest.raises(ValueError, match="backend"):
        port.label_propagate(y0, backend="knn")
    with pytest.raises(ValueError, match="per-request alpha"):
        port.label_propagate(ys, alpha=np.ones(2, np.float32), n_iters=2,
                             backend="grf")
    with pytest.raises(ValueError, match="resume"):
        port.label_propagate_resume(y0, y0, backend="grf")


# -------------------------------------------------------- exact backend
@pytest.mark.parametrize("fixture", FIXTURES)
def test_exact_label_propagate_matches_reference(request, fixture):
    ref = _ref(request, fixture)
    port = port_of(ref)
    y0, ys = _seeds(ref.tree.n_points)
    alphas = np.array([0.05, 0.3, 0.9], np.float32)
    _close(port.label_propagate(y0, alpha=0.2, n_iters=6, backend="exact"),
           ref.label_propagate(y0, alpha=0.2, n_iters=6, backend="exact"))
    _close(port.label_propagate(y0[:, 1], alpha=0.2, n_iters=6,
                                backend="exact"),
           ref.label_propagate(y0[:, 1], alpha=0.2, n_iters=6,
                               backend="exact"))
    _close(port.label_propagate(ys, alpha=alphas, n_iters=6, backend="exact"),
           ref.label_propagate(ys, alpha=alphas, n_iters=6, backend="exact"))
    mid = port.label_propagate(ys, alpha=alphas, n_iters=2,
                               backend="exact").numpy()
    _close(port.label_propagate_resume(mid, ys, alpha=alphas, n_iters=4,
                                       backend="exact"),
           ref.label_propagate_resume(mid, ys, alpha=alphas, n_iters=4,
                                      backend="exact"))


@pytest.mark.parametrize("alpha", ["scalar", "per_column", "per_request"])
def test_lp_scan_fused_matches_reference(small_fitted_vdt, alpha):
    x = np.asarray(small_fitted_vdt[0])
    y0, ys = _seeds(x.shape[0])
    seed = ys if alpha == "per_request" else y0
    al = {"scalar": 0.3, "per_column": np.array([0.2, 0.7], np.float32),
          "per_request": np.array([0.1, 0.5, 0.9], np.float32)}[alpha]
    got = t_lp.lp_scan_fused(torch.as_tensor(x), seed, 1.1, al, 5)
    _close(got, r_lp.lp_scan_fused(jnp.asarray(x), seed, 1.1, al, 5))
    mid = t_lp.lp_scan_fused(torch.as_tensor(x), seed, 1.1, al, 2)
    _close(t_lp.lp_scan_fused_resume(torch.as_tensor(x), mid, seed, 1.1, al, 3),
           r_lp.lp_scan_fused_resume(jnp.asarray(x), mid.numpy(), seed, 1.1,
                                     al, 3))
    for seg in (1, 2, 5, 8):
        torch.testing.assert_close(
            t_lp.lp_scan_fused_segmented(torch.as_tensor(x), seed, 1.1, al, 5,
                                         segment_iters=seg),
            got, rtol=0, atol=0)


def test_segmented_rejects_bad_segment():
    x = torch.zeros(4, 2)
    with pytest.raises(ValueError, match="segment_iters"):
        t_lp.lp_scan_fused_segmented(x, torch.zeros(4, 1), 1.0, 0.1, 3,
                                     segment_iters=0)
    with pytest.raises(ValueError, match="segment_iters"):
        t_lp.lp_scan_leaforder_segmented(None, None, None, None, None, 0.1,
                                         2, 3, 0)


# ------------------------------------------------------------ end to end
def test_end_to_end_ccr_matches_reference(separated_clusters_vdt):
    """fit -> label_propagate on both backends, CCR equal to the reference's."""
    x, labels, ref = separated_clusters_vdt
    n = x.shape[0]
    mask = np.zeros(n, bool)
    mask[np.random.RandomState(5).choice(n, 12, replace=False)] = True
    y0_ref = r_lp.one_hot_labels(labels, mask, 2)
    y0 = one_hot_labels(labels, mask, 2, device="cpu")
    _close(y0, y0_ref)
    port = VariationalDualTree.fit(x, max_blocks=6 * n, device="cpu")
    for backend in ("vdt", "exact"):
        want = ref.label_propagate(y0_ref, alpha=0.01, n_iters=40,
                                   backend=backend)
        got = port.label_propagate(y0, alpha=0.01, n_iters=40, backend=backend)
        _close(got, want)
        assert ccr(got, labels, ~mask) == r_lp.ccr(want, labels, ~mask)
        assert ccr(got, labels, ~mask) > 0.9
    assert np.isnan(ccr(got, labels, np.zeros(n, bool)))


def test_generic_label_propagate_matches_reference(small_fitted_vdt):
    ref = small_fitted_vdt[-1]
    port = port_of(ref)
    y0, _ = _seeds(ref.tree.n_points)
    _close(t_lp.label_propagate(port.matvec, torch.as_tensor(y0), 0.3, 7),
           r_lp.label_propagate(ref.matvec, jnp.asarray(y0), 0.3, 7))
