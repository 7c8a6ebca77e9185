"""K2, K3 and K4, and the all-masked-row rule, against the reference on the CPU.

The plain versions of the port's CUDA kernels (K2 ``matvec_plain``, K3
``step_batched_perbatch_plain``, K4 ``pairwise_sq_dists_plain``), reached
through the port's ops on CPU tensors, are held against the reference's
Pallas kernels run as its own tests run them: the ``repro.kernels.fused_lp``
ops (interpreted off the TPU) and ``pairwise_sq_dists_kernel(...,
interpret=True)``.  Tolerances are the reference's: ``rtol=1e-4, atol=1e-5``
for the LP kernels (``1e-3``/``1e-4`` at extreme bandwidths, ``rtol=1e-5`` for
``P @ 1 = 1``), ``1e-4`` for float32 distances and ``5e-2`` for bfloat16.
The CUDA kernels themselves run only on a card (``tests/test_torch_gpu.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import label_prop as r_lp
from repro.kernels import fused_lp as r_fl
from repro.kernels.pairwise.pairwise import pairwise_sq_dists_kernel
from repro.kernels.pairwise.ref import pairwise_sq_dists_ref as r_pw_ref
from repro_torch.core.label_prop import (lp_scan_fused,
                                         lp_scan_fused_resume)
from repro_torch.kernels.fused_lp import (alpha_row, folded_step,
                                          folded_step_plain, fused_lp_matvec,
                                          fused_lp_matvec_batched,
                                          fused_lp_step_batched,
                                          fused_lp_step_folded, matvec_plain,
                                          matvec_step, perbatch_step,
                                          step_batched_perbatch_plain)
from repro_torch.kernels.pairwise import (pairwise_sq_dists,
                                          pairwise_sq_dists_plain,
                                          pairwise_sq_dists_ref)

RTOL, ATOL = 1e-4, 1e-5
BLOCK = 16


def _close(port, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(port.detach().cpu().numpy(), np.asarray(ref),
                               rtol=rtol, atol=atol)


def _randn(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


# -------------------------------------------------------------------- K2
@pytest.mark.parametrize("n,d,c,sigma", [
    (32, 4, 2, 1.0), (100, 8, 3, 0.5), (130, 5, 1, 2.0), (64, 16, 7, 1.0),
])
def test_matvec_matches_reference_kernel(n, d, c, sigma):
    rng = np.random.RandomState(n + c)
    x, y = _randn(rng, n, d), _randn(rng, n, c)
    want = r_fl.fused_lp_matvec(jnp.asarray(x), jnp.asarray(y), sigma,
                                block_m=32, block_n=32)
    got = fused_lp_matvec(torch.as_tensor(x), torch.as_tensor(y), sigma)
    _close(got, want)
    _close(got, r_fl.fused_lp_matvec_dense_ref(jnp.asarray(x), jnp.asarray(y),
                                               sigma))
    # one tile or many: the online softmax gives the same product
    _close(matvec_plain(torch.as_tensor(x), torch.as_tensor(y),
                        1.0 / (2.0 * sigma * sigma), block_m=BLOCK,
                        block_n=BLOCK), want)


@pytest.mark.parametrize("sigma", [0.05, 10.0])
def test_matvec_extreme_sigma(sigma):
    rng = np.random.RandomState(48)
    x, y = _randn(rng, 48, 3), _randn(rng, 48, 2)
    got = fused_lp_matvec(torch.as_tensor(x), torch.as_tensor(y), sigma)
    assert torch.isfinite(got).all()
    want = r_fl.fused_lp_matvec(jnp.asarray(x), jnp.asarray(y), sigma,
                                block_m=BLOCK, block_n=BLOCK)
    _close(got, want, rtol=1e-3, atol=1e-4)


def test_matvec_row_stochastic_action():
    x = torch.as_tensor(_randn(np.random.RandomState(70), 70, 6))
    got = fused_lp_matvec(x, torch.ones((70, 1)), 1.0)
    np.testing.assert_allclose(got.numpy(), 1.0, rtol=1e-5)


# -------------------------------------------------------------------- K3
@pytest.mark.parametrize("b,n,c,alpha", [(1, 33, 1, 0.1), (3, 40, 2, 0.35),
                                         (2, 65, 5, 0.9)])
def test_perbatch_step_matches_reference_kernel(b, n, c, alpha):
    rng = np.random.RandomState(b * n)
    x = _randn(rng, n, 5)
    y, y0 = _randn(rng, b, n, c), _randn(rng, b, n, c)
    want = r_fl.fused_lp_step_batched(jnp.asarray(x), jnp.asarray(y),
                                      jnp.asarray(y0), 0.8, alpha,
                                      block_m=BLOCK, block_n=BLOCK,
                                      reuse=False)
    tx, ty, ty0 = (torch.as_tensor(v) for v in (x, y, y0))
    got = fused_lp_step_batched(tx, ty, ty0, 0.8, alpha, reuse=False)
    _close(got, want)
    _close(got, r_fl.fused_lp_step_batched_ref(jnp.asarray(x), jnp.asarray(y),
                                               jnp.asarray(y0), 0.8, alpha))
    # the reuse layout (K1 on the folded batch) computes the same step
    _close(fused_lp_step_batched(tx, ty, ty0, 0.8, alpha, reuse=True), want)


@pytest.mark.parametrize("reuse", [True, False])
def test_matvec_batched_matches_reference(reuse):
    rng = np.random.RandomState(5)
    x, ys = _randn(rng, 37, 4), _randn(rng, 3, 37, 2)
    want = r_fl.fused_lp_matvec_batched(jnp.asarray(x), jnp.asarray(ys), 1.1,
                                        block_m=BLOCK, block_n=BLOCK,
                                        reuse=reuse)
    got = fused_lp_matvec_batched(torch.as_tensor(x), torch.as_tensor(ys),
                                  1.1, reuse=reuse)
    _close(got, want)


def test_step_batched_reuse_per_request_alpha():
    rng = np.random.RandomState(8)
    x, y, y0 = _randn(rng, 30, 3), _randn(rng, 3, 30, 2), _randn(rng, 3, 30, 2)
    al = np.array([0.0, 0.3, 1.0], np.float32)
    want = r_fl.fused_lp_step_batched(jnp.asarray(x), jnp.asarray(y),
                                      jnp.asarray(y0), 0.9, jnp.asarray(al),
                                      block_m=BLOCK, block_n=BLOCK)
    got = fused_lp_step_batched(*(torch.as_tensor(v) for v in (x, y, y0)),
                                0.9, al)
    _close(got, want)


@pytest.mark.parametrize("alpha", ["scalar", "per_column"])
def test_step_folded_matches_reference(alpha):
    rng = np.random.RandomState(3)
    x, y, y0 = _randn(rng, 41, 5), _randn(rng, 41, 4), _randn(rng, 41, 4)
    al = 0.1 if alpha == "scalar" else np.array([0.0, 0.05, 0.5, 1.0],
                                                np.float32)
    want = r_fl.fused_lp_step_folded(jnp.asarray(x), jnp.asarray(y),
                                     jnp.asarray(y0), 1.0, jnp.asarray(al),
                                     block_m=BLOCK, block_n=BLOCK)
    got = fused_lp_step_folded(*(torch.as_tensor(v) for v in (x, y, y0)),
                               1.0, al)
    _close(got, want)


def test_kernel_wrappers_count_no_launch_on_the_cpu():
    rng = np.random.RandomState(12)
    x, y = torch.as_tensor(_randn(rng, 20, 3)), torch.as_tensor(
        _randn(rng, 2, 20, 4))
    before = (matvec_step.launches, perbatch_step.launches,
              pairwise_sq_dists.launches)
    torch.testing.assert_close(matvec_step(x, y[0], 0.4),
                               matvec_plain(x, y[0], 0.4), rtol=0, atol=0)
    torch.testing.assert_close(
        perbatch_step(x, y, y, 0.2, 0.4),
        step_batched_perbatch_plain(x, y, y, 0.2, 0.4), rtol=0, atol=0)
    torch.testing.assert_close(pairwise_sq_dists(x, x),
                               pairwise_sq_dists_plain(x, x), rtol=0, atol=0)
    assert (matvec_step.launches, perbatch_step.launches,
            pairwise_sq_dists.launches) == before
    for fn, args in ((matvec_step, (x.to("meta"), y[0], 0.4)),
                     (perbatch_step, (x.to("meta"), y, y, 0.2, 0.4)),
                     (pairwise_sq_dists, (x.to("meta"), x))):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(*args)


# -------------------------------------------------------------------- K4
@pytest.mark.parametrize("m,n,d", [(8, 8, 4), (100, 64, 7), (33, 70, 315)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pairwise_matches_reference_kernel(m, n, d, dtype):
    rng = np.random.RandomState(m + n + d)
    x, y = _randn(rng, m, d), _randn(rng, n, d)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, jy = jnp.asarray(x, jdt), jnp.asarray(y, jdt)
    tx, ty = torch.as_tensor(x).to(tdt), torch.as_tensor(y).to(tdt)
    want = pairwise_sq_dists_kernel(jx, jy, block_m=64, block_n=64,
                                    interpret=True)
    got = pairwise_sq_dists(tx, ty)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    tol = 1e-4 if dtype == "float32" else 5e-2
    _close(got, want, rtol=tol, atol=tol)
    _close(pairwise_sq_dists_ref(tx, ty), r_pw_ref(jx, jy), rtol=tol,
           atol=tol)
    _close(got, r_pw_ref(jx, jy), rtol=tol, atol=tol)


def test_pairwise_zero_diag_when_same():
    x = torch.as_tensor(_randn(np.random.RandomState(40), 40, 5))
    assert torch.allclose(torch.diagonal(pairwise_sq_dists(x, x)),
                          torch.zeros(40), atol=1e-3)


def test_pairwise_mixed_types_upcast():
    rng = np.random.RandomState(1)
    x, y = torch.as_tensor(_randn(rng, 9, 6)), torch.as_tensor(_randn(rng, 7, 6))
    torch.testing.assert_close(pairwise_sq_dists(x, y.to(torch.bfloat16)),
                               pairwise_sq_dists(x, y.to(torch.bfloat16)
                                                 .to(torch.float32)),
                               rtol=0, atol=0)


# ------------------------------------------- an all-masked row (N = 1)
X1 = np.array([[0.3, 0.5]], np.float32)
Y1 = np.array([[2.0, 3.0]], np.float32)
Y01 = np.array([[1.0, 5.0]], np.float32)


@pytest.mark.parametrize("op", ["folded_step", "step_folded", "matvec",
                                "perbatch", "step_batched_reuse"])
def test_single_point_matches_reference(op):
    """N = 1 masks every column; the port returns the reference's value,
    ``sum_j Y[j] / 256`` for ``P @ Y`` (256 = its padded column count)."""
    jx, jy, jy0 = (jnp.asarray(v) for v in (X1, Y1, Y01))
    tx, ty, ty0 = (torch.as_tensor(v) for v in (X1, Y1, Y01))
    if op == "folded_step":
        got = folded_step_plain(tx, tx, ty, ty0, alpha_row(0.3, 2, "cpu"), 0.5)
        assert torch.equal(got, folded_step(tx, tx, ty, ty0,
                                            alpha_row(0.3, 2, "cpu"), 0.5))
        want = r_fl.fused_lp_step_folded(jx, jy, jy0, 1.0, 0.3)
    elif op == "step_folded":
        got = fused_lp_step_folded(tx, ty, ty0, 1.0, 0.3)
        want = r_fl.fused_lp_step_folded(jx, jy, jy0, 1.0, 0.3)
    elif op == "matvec":
        got = fused_lp_matvec(tx, ty, 1.0)
        want = r_fl.fused_lp_matvec(jx, jy, 1.0)
        np.testing.assert_allclose(got.numpy(), Y1 / 256, rtol=1e-6)
    elif op == "perbatch":
        got = fused_lp_step_batched(tx, ty[None], ty0[None], 1.0, 0.3,
                                    reuse=False)
        want = r_fl.fused_lp_step_batched(jx, jy[None], jy0[None], 1.0, 0.3,
                                          reuse=False)
    else:
        got = fused_lp_step_batched(tx, ty[None], ty0[None], 1.0, 0.3)
        want = r_fl.fused_lp_step_batched(jx, jy[None], jy0[None], 1.0, 0.3)
    _close(got, want, rtol=1e-6, atol=0)


def test_single_point_lp_scan_matches_reference_first_step():
    """One exact LP iteration at N = 1 equals the reference's closed form."""
    got = lp_scan_fused(torch.as_tensor(X1), torch.as_tensor(Y01), 1.0, 0.3, 1)
    want = r_lp.lp_scan_fused(jnp.asarray(X1), jnp.asarray(Y01), 1.0, 0.3, 1)
    _close(got, want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.numpy(), 0.3 * Y01 / 256 + 0.7 * Y01,
                               rtol=1e-6)


@pytest.mark.parametrize("walk", ["scan3", "segmented1+2", "batched3",
                                  "batched_segmented1+2"])
def test_single_point_lp_scan_matches_reference_every_step(walk):
    """At N = 1 later iterations of the reference also average its 255
    padded rows, each holding ``alpha * y`` after a step; the port carries
    that row.  A segmented walk re-pads the carry with zeros in the
    reference, and does the same in the port."""
    tx, ty0 = torch.as_tensor(X1), torch.as_tensor(Y01)
    jx, jy0 = jnp.asarray(X1), jnp.asarray(Y01)
    alpha = np.array([0.3, 0.6], np.float32)
    if walk.startswith("batched"):       # (2, 1, 2): per-request alpha
        seeds = np.concatenate([Y01, 2 * Y01])[:, None]
        ty0, jy0 = torch.as_tensor(seeds), jnp.asarray(seeds)
    if walk.endswith("segmented1+2"):
        got = lp_scan_fused_resume(
            tx, lp_scan_fused(tx, ty0, 1.0, alpha, 1), ty0, 1.0, alpha, 2)
        want = r_lp.lp_scan_fused_resume(
            jx, r_lp.lp_scan_fused(jx, jy0, 1.0, jnp.asarray(alpha), 1), jy0,
            1.0, jnp.asarray(alpha), 2)
        mono = r_lp.lp_scan_fused(jx, jy0, 1.0, jnp.asarray(alpha), 3)
        assert not np.allclose(np.asarray(want), np.asarray(mono))
    else:
        got = lp_scan_fused(tx, ty0, 1.0, alpha, 3)
        want = r_lp.lp_scan_fused(jx, jy0, 1.0, jnp.asarray(alpha), 3)
    _close(got, want, rtol=1e-6, atol=0)
