"""Tests of the port that need a CUDA card; they skip without one.

Run them on the card with ``python -m pytest -m gpu tests/test_torch_gpu.py``.
This file imports neither JAX nor the reference package, so it runs where
only the port's dependencies are installed.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain,
                                                 flash_attention_ref)
from repro_torch.kernels.fused_lp import (alpha_row, folded_step,
                                          folded_step_plain, fused_lp_matvec,
                                          fused_lp_scan_folded,
                                          fused_lp_scan_folded_resume,
                                          fused_lp_step_batched, matvec_plain,
                                          matvec_step, perbatch_step,
                                          step_batched_perbatch_plain)
from repro_torch.kernels.grf import grf_feature_matvec, grf_feature_plain
from repro_torch.kernels.pairwise import (pairwise_sq_dists,
                                          pairwise_sq_dists_plain,
                                          pairwise_sq_dists_ref)

RTOL, ATOL = 1e-4, 1e-5


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _inputs(n, d, k, seed):
    r = np.random.RandomState(seed)
    return (r.randn(n, d).astype(np.float32), r.rand(n, k).astype(np.float32),
            r.rand(n, k).astype(np.float32), r.rand(k).astype(np.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,k,row_base", [(1000, 315, 2, 0),
                                            (4099, 64, 16, 0),
                                            (257, 8, 300, 0),
                                            (300, 16, 5, 37)])
def test_cuda_kernel_matches_plain(n, d, k, row_base):
    """K1 on the card against its plain version, at the tolerance stated."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, y, y0, al = (torch.as_tensor(v).cuda()
                    for v in _inputs(n, d, k, seed=n))
    rows, y0r = x[row_base:].contiguous(), y0[row_base:].contiguous()
    inv = 1.0 / (2.0 * d)
    before = folded_step.launches
    got = folded_step(rows, x, y, y0r, al, inv, row_base)
    torch.cuda.synchronize()
    assert folded_step.launches == before + 1
    want = folded_step_plain(rows, x, y, y0r, al, inv, row_base)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    scan = fused_lp_scan_folded(x, y0, math.sqrt(d), al, 3)
    resumed = fused_lp_scan_folded_resume(
        x, fused_lp_scan_folded(x, y0, math.sqrt(d), al, 1), y0,
        math.sqrt(d), al, 2)
    assert torch.equal(scan, resumed)


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,c", [(1000, 315, 2), (257, 8, 300), (130, 5, 1)])
def test_cuda_matvec_kernel_matches_plain(n, d, c):
    """K2 against its plain version; P is row-stochastic through it."""
    _card()
    x, y, _, _ = (torch.as_tensor(v).cuda() for v in _inputs(n, d, c, seed=n))
    inv = 1.0 / (2.0 * d)
    before = matvec_step.launches
    got = matvec_step(x, y, inv)
    torch.cuda.synchronize()
    assert matvec_step.launches == before + 1
    torch.testing.assert_close(got, matvec_plain(x, y, inv), rtol=RTOL,
                               atol=ATOL)
    ones = torch.ones((n, 1), device="cuda")
    torch.testing.assert_close(fused_lp_matvec(x, ones, math.sqrt(d)),
                               ones, rtol=1e-5, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,d,c", [(3, 1000, 315, 2), (2, 257, 8, 17)])
def test_cuda_perbatch_kernel_matches_plain(b, n, d, c):
    """K3 against its plain version and against K1 on the folded batch."""
    _card()
    r = np.random.RandomState(n + b)
    x = torch.as_tensor(r.randn(n, d).astype(np.float32)).cuda()
    y, y0 = (torch.as_tensor(r.rand(b, n, c).astype(np.float32)).cuda()
             for _ in range(2))
    inv = 1.0 / (2.0 * d)
    before = perbatch_step.launches
    got = perbatch_step(x, y, y0, 0.3, inv)
    torch.cuda.synchronize()
    assert perbatch_step.launches == before + 1
    torch.testing.assert_close(
        got, step_batched_perbatch_plain(x, y, y0, 0.3, inv), rtol=RTOL,
        atol=ATOL)
    torch.testing.assert_close(
        got, fused_lp_step_batched(x, y, y0, math.sqrt(d), 0.3, reuse=True),
        rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_cuda_all_masked_row_matches_plain():
    """N = 1: K1, K2 and K3 divide by the reference's padded column count."""
    _card()
    x = torch.tensor([[0.3, 0.5]], device="cuda")
    y = torch.tensor([[2.0, 3.0]], device="cuda")
    y0 = torch.tensor([[1.0, 5.0]], device="cuda")
    al = alpha_row(0.3, 2, "cuda")
    want = 0.3 * y / 256 + 0.7 * y0
    for got, plain in (
            (folded_step(x, x, y, y0, al, 0.5),
             folded_step_plain(x, x, y, y0, al, 0.5)),
            (matvec_step(x, y, 0.5), matvec_plain(x, y, 0.5)),
            (perbatch_step(x, y[None], y0[None], 0.3, 0.5)[0],
             step_batched_perbatch_plain(x, y[None], y0[None], 0.3, 0.5)[0])):
        torch.testing.assert_close(got, plain, rtol=1e-6, atol=0)
    torch.testing.assert_close(folded_step(x, x, y, y0, al, 0.5), want,
                               rtol=1e-6, atol=0)
    torch.testing.assert_close(matvec_step(x, y, 0.5), y / 256, rtol=1e-6,
                               atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("s,m,n,k", [(24, 16, 24, 2), (1000, 64, 1000, 16),
                                     (4099, 7, 3000, 300), (50, 400, 80, 3)])
def test_cuda_grf_feature_kernel_matches_plain(s, m, n, k):
    """K5 against its plain version; a column's bits do not depend on K."""
    _card()
    r = np.random.RandomState(s + m)
    pos = torch.as_tensor(r.randint(0, n, (s, m)).astype(np.int32)).cuda()
    load = torch.as_tensor(r.rand(s, m).astype(np.float32)).cuda()
    y = torch.as_tensor(r.randn(n, k).astype(np.float32)).cuda()
    before = grf_feature_matvec.launches
    got = grf_feature_matvec(pos, load, y)
    torch.cuda.synchronize()
    assert grf_feature_matvec.launches == before + 1
    torch.testing.assert_close(got, grf_feature_plain(pos, load, y),
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got, grf_feature_matvec(pos, load, y,
                                                       impl="ref"),
                               rtol=1e-5, atol=1e-6)
    if k >= 2:
        two = grf_feature_matvec(pos, load, y[:, :2].contiguous())
        assert torch.equal(got[:, :2], two)


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,d", [(8, 8, 4), (100, 64, 7), (257, 129, 16),
                                   (64, 300, 315)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_pairwise_kernel_matches_plain(m, n, d, dtype):
    """K4 against its plain version and the direct-difference oracle."""
    _card()
    r = np.random.RandomState(m + n)
    x = torch.as_tensor(r.randn(m, d).astype(np.float32)).to("cuda", dtype)
    y = torch.as_tensor(r.randn(n, d).astype(np.float32)).to("cuda", dtype)
    before = pairwise_sq_dists.launches
    got = pairwise_sq_dists(x, y)
    torch.cuda.synchronize()
    assert pairwise_sq_dists.launches == before + 1
    assert got.dtype == torch.float32
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(got, pairwise_sq_dists_plain(x, y), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(got, pairwise_sq_dists_ref(x, y), rtol=tol,
                               atol=tol)


@pytest.mark.gpu
def test_cuda_grf_feature_kernel_skips_positions_outside_the_graph():
    _card()
    r = np.random.RandomState(2)
    pos = r.randint(0, 30, (40, 20)).astype(np.int32)
    pos[0, 0], pos[5, 19], pos[39, 7] = -3, 30, 10 ** 6
    pos, load, y = (torch.as_tensor(v).cuda() for v in (
        pos, r.rand(40, 20).astype(np.float32),
        r.randn(30, 4).astype(np.float32)))
    got = grf_feature_matvec(pos, load, y)
    torch.testing.assert_close(got, grf_feature_plain(pos, load, y),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window", [
    (1, 2, 2, 64, 64, True, 0), (2, 3, 1, 65, 64, True, 0),
    (2, 4, 1, 130, 128, True, 16), (1, 4, 1, 97, 256, True, 0),
    (1, 15, 5, 200, 64, True, 0), (2, 3, 1, 65, 64, False, 0),
    (1, 4, 2, 100, 128, False, 24), (1, 8, 2, 257, 256, True, 48)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_kernel_matches_plain(b, hq, hkv, s, d, causal,
                                                   window, dtype):
    """K6 against its plain version and the naive oracle, at the reference's
    tolerances (2e-4 in float32, 5e-2 in bfloat16); two launches agree bit
    for bit."""
    _card()
    r = np.random.RandomState(s + d)
    q, k, v = (torch.as_tensor(r.randn(b, h, s, d).astype(np.float32))
               .to("cuda", dtype) for h in (hq, hkv, hkv))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    tol = 2e-4 if dtype == torch.float32 else 5e-2
    for want in (flash_attention_plain(q, k, v, causal, window),
                 flash_attention_ref(q, k, v, causal, window)):
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
    assert torch.equal(got, flash_attention(q, k, v, causal=causal,
                                            window=window))


@pytest.mark.gpu
def test_cuda_flash_attention_rejects_what_the_kernel_does_not_take():
    _card()
    q = torch.zeros((1, 2, 8, 32), device="cuda")
    with pytest.raises(ValueError, match="head width"):
        flash_attention(q, q, q)
    q = torch.zeros((1, 3, 8, 64), device="cuda")
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, q[:, :2], q[:, :2])
    with pytest.raises(ValueError, match="bfloat16"):
        flash_attention(q, q.double(), q)
