"""K1, the fused exact LP step: the port's plain version against the reference.

The reference's Pallas kernel runs as its own tests run it on the CPU:
``_folded_call(..., interpret=True)`` at blocks of 16 and the
``repro.kernels.fused_lp`` ops, which interpret off-TPU.  The CUDA kernel
itself runs only on a card: ``tests/test_torch_gpu.py`` holds it against
this plain version there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_lp import batched as r_batched
from repro.kernels.fused_lp import ops as r_ops
from repro.kernels.fused_lp import ref as r_ref
from repro_torch.kernels.fused_lp import (alpha_row, dense_transition_ref,
                                          folded_step, folded_step_plain,
                                          fused_lp_scan_batched,
                                          fused_lp_scan_batched_ref,
                                          fused_lp_scan_batched_resume,
                                          fused_lp_scan_folded,
                                          fused_lp_scan_folded_resume)
from repro_torch.kernels import _build
from repro_torch.kernels.fused_lp import ops as t_ops

RTOL, ATOL = 1e-4, 1e-5
BLOCK = 16


def _close(port, ref):
    np.testing.assert_allclose(port.detach().cpu().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


def _inputs(n, d, k, seed):
    r = np.random.RandomState(seed)
    return (r.randn(n, d).astype(np.float32), r.rand(n, k).astype(np.float32),
            r.rand(n, k).astype(np.float32), r.rand(k).astype(np.float32))


def _reference_step(x, y, y0, alpha, sigma, row_lo, row_hi):
    """The reference's ``_folded_call`` on padded operands, valid rows only."""
    n, k = y.shape
    rows = x[row_lo:row_hi]
    m = rows.shape[0]
    mp = -(-m // BLOCK) * BLOCK
    np_ = -(-n // BLOCK) * BLOCK
    out = r_batched._folded_call(
        jnp.pad(rows, ((0, mp - m), (0, 0))), jnp.pad(x, ((0, np_ - n), (0, 0))),
        jnp.pad(y, ((0, np_ - n), (0, 0))),
        jnp.pad(y0[row_lo:row_hi], ((0, mp - m), (0, 0))),
        r_batched._alpha_row(alpha, k),
        inv_two_sigma_sq=float(1.0 / (2.0 * sigma * sigma)), n_valid=n,
        block_m=BLOCK, block_n=BLOCK, interpret=True,
        row_base=None if row_lo == 0 else row_lo)
    return np.asarray(out)[:m]


@pytest.mark.parametrize("row_base", [0, 11])
@pytest.mark.parametrize("alpha", ["scalar", "per_column"])
@pytest.mark.parametrize("n,d,k", [(37, 3, 1), (37, 5, 2), (53, 4, 16)])
def test_plain_step_matches_reference_kernel(n, d, k, alpha, row_base):
    x, y, y0, al_col = _inputs(n, d, k, seed=n + k)
    al = np.float32(0.35) if alpha == "scalar" else al_col
    sigma = 1.3
    row_hi = n if row_base == 0 else row_base + 20
    want = _reference_step(x, y, y0, al, sigma, row_base, row_hi)
    tx, ty, ty0 = (torch.as_tensor(v) for v in (x, y, y0))
    got = folded_step_plain(tx[row_base:row_hi], tx, ty, ty0[row_base:row_hi],
                            alpha_row(al, k, "cpu"),
                            1.0 / (2.0 * sigma * sigma), row_base,
                            block_m=BLOCK, block_n=BLOCK)
    _close(got, want)
    # one tile or many: the online softmax gives the same step
    whole = folded_step_plain(tx[row_base:row_hi], tx, ty, ty0[row_base:row_hi],
                              alpha_row(al, k, "cpu"),
                              1.0 / (2.0 * sigma * sigma), row_base)
    _close(whole, want)


@pytest.mark.parametrize("sigma", [0.05, 10.0])
def test_plain_step_extreme_sigma_matches_dense(sigma):
    """Tiny bandwidths give huge logits; the online softmax stays stable."""
    x, y, y0, _ = _inputs(48, 3, 2, seed=4)
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    got = folded_step_plain(tx, tx, ty, ty, alpha_row(1.0, 2, "cpu"),
                            1.0 / (2.0 * sigma * sigma), block_m=BLOCK,
                            block_n=BLOCK)
    assert torch.isfinite(got).all()
    _close(got, dense_transition_ref(tx, sigma) @ ty)
    _close(dense_transition_ref(tx, sigma),
           r_ref.dense_transition_ref(jnp.asarray(x), sigma))


def test_dense_scan_oracle_matches_reference():
    x, _, _, _ = _inputs(30, 4, 2, seed=6)
    ys = np.random.RandomState(7).rand(3, 30, 2).astype(np.float32)
    al = np.array([0.1, 0.5, 0.9], np.float32)
    _close(fused_lp_scan_batched_ref(torch.as_tensor(x), torch.as_tensor(ys),
                                     0.8, al, 4),
           r_ref.fused_lp_scan_batched_ref(jnp.asarray(x), jnp.asarray(ys),
                                           0.8, al, 4))


@pytest.mark.parametrize("k,alpha", [(1, "scalar"), (2, "per_column"),
                                     (16, "per_column")])
def test_folded_scan_matches_reference(k, alpha):
    x, _, y0, al_col = _inputs(41, 5, k, seed=k)
    al = 0.25 if alpha == "scalar" else al_col
    tx, ty0 = torch.as_tensor(x), torch.as_tensor(y0)
    got = fused_lp_scan_folded(tx, ty0, 1.2, al, 4)
    _close(got, r_ops.fused_lp_scan_folded(jnp.asarray(x), jnp.asarray(y0),
                                           1.2, jnp.asarray(al), 4,
                                           block_m=BLOCK, block_n=BLOCK))
    mid = fused_lp_scan_folded(tx, ty0, 1.2, al, 1)
    resumed = fused_lp_scan_folded_resume(tx, mid, ty0, 1.2, al, 3)
    torch.testing.assert_close(resumed, got, rtol=0, atol=0)
    _close(resumed, r_ops.fused_lp_scan_folded_resume(
        jnp.asarray(x), jnp.asarray(mid.numpy()), jnp.asarray(y0), 1.2,
        jnp.asarray(al), 3, block_m=BLOCK, block_n=BLOCK))


def test_batched_scan_matches_reference():
    x, _, _, _ = _inputs(33, 4, 2, seed=9)
    ys = np.random.RandomState(10).rand(4, 33, 2).astype(np.float32)
    al = np.array([0.05, 0.2, 0.6, 0.95], np.float32)
    tx, tys = torch.as_tensor(x), torch.as_tensor(ys)
    got = fused_lp_scan_batched(tx, tys, 0.9, al, 3)
    _close(got, r_ops.fused_lp_scan_batched(jnp.asarray(x), jnp.asarray(ys),
                                            0.9, jnp.asarray(al), 3))
    _close(got, fused_lp_scan_batched_ref(tx, tys, 0.9, al, 3))
    mid = fused_lp_scan_batched(tx, tys, 0.9, al, 1)
    torch.testing.assert_close(
        fused_lp_scan_batched_resume(tx, mid, tys, 0.9, al, 2), got,
        rtol=0, atol=0)


def test_cpu_dispatch_runs_plain_and_counts_no_launch():
    x, y, y0, al = _inputs(20, 3, 4, seed=12)
    tx, ty, ty0 = (torch.as_tensor(v) for v in (x, y, y0))
    before = folded_step.launches
    got = folded_step(tx, tx, ty, ty0, torch.as_tensor(al), 0.4)
    assert folded_step.launches == before
    torch.testing.assert_close(
        got, folded_step_plain(tx, tx, ty, ty0, torch.as_tensor(al), 0.4),
        rtol=0, atol=0)
    with pytest.raises(ValueError, match="unsupported device"):
        folded_step(tx.to("meta"), tx, ty, ty0, torch.as_tensor(al), 0.4)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "device"])
def test_kernel_operand_checks(bad):
    t = torch.zeros(6, 4)
    want_shape = (6, 4)
    if bad == "dtype":
        t = t.double()
    elif bad == "shape":
        want_shape = (6, 5)
    elif bad == "contiguous":
        t = torch.zeros(4, 6).T
    with pytest.raises(ValueError):
        _build.check_operand("y", t, want_shape, torch.device("meta")
                             if bad == "device" else t.device)


def test_kernel_source_and_build_flags():
    """The kernel is built from the package's own source, for sm_90a."""
    assert t_ops.KERNEL_SOURCE.is_file()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build.BUILD_DIR.parts[-2:] == ("build", "repro_torch")
    text = t_ops.KERNEL_SOURCE.read_text()
    assert 'extern "C" int folded_lp_step' in text
    assert "batched.py:231" in text
