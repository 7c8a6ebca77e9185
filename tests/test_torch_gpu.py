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
# K6's bfloat16 route against its plain version, which repeats its
# recurrence and rounds p to bfloat16 as it does: elementwise rtol=atol, and
# the RMS error of each 64-row block over the RMS of its output
K6_BF16_PLAIN_TOL, K6_BLOCK_RMS = 1e-2, 1e-2
# the precision gate that tells 3xTF32 from one TF32 product: a kernel's max
# and RMS errors against float64 at most GATE_RATIO x the plain float32
# version's, on dense Gaussian points at d = 315
GATE_RATIO, GATE_D = 2.0, 315


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _assert_k6_bf16_matches_plain(got, want):
    """The two differ by roundings of single bfloat16 values; a dropped key
    tile or a wrong rescale moves a whole block of rows."""
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=K6_BF16_PLAIN_TOL, atol=K6_BF16_PLAIN_TOL)
    b, h, s, d = want.shape
    pad = (0, 0, 0, -s % 64)
    err, ref = (torch.nn.functional.pad(t, pad).reshape(b, h, -1, 64 * d)
                for t in (got.double() - want.double(), want.double()))
    ratio = err.norm(dim=-1) / ref.norm(dim=-1)
    assert float(ratio.max()) <= K6_BLOCK_RMS, float(ratio.max())


def _assert_gate(got, plain, ref):
    """K1-K4 against float64: no worse than 2 x the plain float32 version."""
    def errors(t):
        err = (t.double() - ref).abs()
        return float(err.max()), float(err.square().mean().sqrt())

    (k_max, k_rms), (p_max, p_rms) = errors(got), errors(plain)
    assert k_max <= GATE_RATIO * p_max, (k_max, p_max)
    assert k_rms <= GATE_RATIO * p_rms, (k_rms, p_rms)


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
    on_route = folded_step.launches_by_route["tf32x3"]
    got = folded_step(rows, x, y, y0r, al, inv, row_base)
    torch.cuda.synchronize()
    assert folded_step.launches == before + 1
    assert folded_step.launches_by_route["tf32x3"] == on_route + 1
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
    on_route = matvec_step.launches_by_route["tf32x3"]
    got = matvec_step(x, y, inv)
    torch.cuda.synchronize()
    assert matvec_step.launches == before + 1
    assert matvec_step.launches_by_route["tf32x3"] == on_route + 1
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
    on_route = perbatch_step.launches_by_route["tf32x3"]
    got = perbatch_step(x, y, y0, 0.3, inv)
    torch.cuda.synchronize()
    assert perbatch_step.launches == before + 1
    assert perbatch_step.launches_by_route["tf32x3"] == on_route + 1
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
    route = "tf32x3" if dtype == torch.float32 else "tf32x1_bf16"
    on_route = pairwise_sq_dists.launches_by_route[route]
    got = pairwise_sq_dists(x, y)
    torch.cuda.synchronize()
    assert pairwise_sq_dists.launches == before + 1
    assert pairwise_sq_dists.launches_by_route[route] == on_route + 1
    assert got.dtype == torch.float32
    assert torch.equal(got, pairwise_sq_dists(x, y))
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(got, pairwise_sq_dists_plain(x, y), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(got, pairwise_sq_dists_ref(x, y), rtol=tol,
                               atol=tol)


@pytest.mark.gpu
def test_cuda_pairwise_kernel_precision_gate():
    """K4 at the kNN block shape on Gaussian points, where one TF32 product
    (not 3xTF32) would show: within 2 x float32's error against float64."""
    _card()
    r = np.random.RandomState(15)
    x = torch.as_tensor(r.randn(2_048, GATE_D).astype(np.float32)).cuda()
    y = torch.as_tensor(r.randn(83_679, GATE_D).astype(np.float32)).cuda()
    xd, yd = x.double(), y.double()
    ref = ((xd * xd).sum(1)[:, None] + (yd * yd).sum(1)[None, :]
           - 2.0 * (xd @ yd.T)).clamp_min(0.0)
    _assert_gate(pairwise_sq_dists(x, y), pairwise_sq_dists_plain(x, y), ref)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [2, 16])
def test_cuda_kernel_precision_gate(k):
    """K1 at N = 16,384 on Gaussian points with logits spanning tens of units
    (1 / (2 sigma^2) = 0.1), against the plain recurrence in float64."""
    _card()
    r = np.random.RandomState(16 + k)
    x = torch.as_tensor(r.randn(16_384, GATE_D).astype(np.float32)).cuda()
    y = torch.as_tensor(r.rand(16_384, k).astype(np.float32)).cuda()
    al = torch.as_tensor(r.rand(k).astype(np.float32)).cuda()
    ref = folded_step_plain(x.double(), x.double(), y.double(), y.double(),
                            al.double(), 0.1)
    assert ref.dtype == torch.float64
    _assert_gate(folded_step(x, x, y, y, al, 0.1),
                 folded_step_plain(x, x, y, y, al, 0.1), ref)


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
    tolerances (2e-4 in float32, 5e-2 in bfloat16), and in bfloat16 against
    its plain version at the tighter limits above; two launches agree bit for
    bit."""
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
    if dtype == torch.bfloat16:
        _assert_k6_bf16_matches_plain(
            got, flash_attention_plain(q, k, v, causal, window))
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


@pytest.mark.gpu
@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window", [
    (1, 1, 1, 64, 64, True, 0), (2, 3, 1, 33, 64, True, 0),
    (1, 4, 1, 130, 64, False, 0), (2, 3, 3, 200, 64, True, 16),
    (1, 6, 2, 257, 64, True, 63), (1, 2, 1, 1100, 64, True, 1024),
    (1, 2, 2, 64, 128, False, 0), (2, 3, 1, 97, 128, True, 63),
    (1, 8, 2, 300, 128, True, 1024), (1, 4, 4, 33, 128, False, 16),
    (1, 1, 1, 64, 256, True, 0), (1, 3, 1, 130, 256, True, 16),
    (2, 4, 1, 70, 256, False, 63), (1, 4, 1, 1100, 256, True, 1024)])
def test_cuda_flash_attention_sm90_route(b, hq, hkv, s, d, causal, window):
    """K6's bfloat16 route (the tensor-core kernel) against its plain version
    at the tighter limits above and against the naive oracle at the
    reference's bfloat16 tolerance, 5e-2: head widths 64, 128 and 256; GQA
    ratios 1, 3 and 4; causal and not; windows of 16, BK - 1 = 63 and 1,024;
    S below, at and past the 64-key tile.  One launch, counted on the
    tensor-core route alone; a second launch equal to the first bit for
    bit."""
    _card()
    r = np.random.RandomState(7 * s + d)
    q, k, v = (torch.as_tensor(r.randn(b, h, s, d).astype(np.float32))
               .to("cuda", torch.bfloat16) for h in (hq, hkv, hkv))
    routes = dict(flash_attention.launches_by_route)
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches_by_route == {
        "sm90_bf16": routes["sm90_bf16"] + 1,
        "sm90_tf32x3": routes["sm90_tf32x3"]}
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _assert_k6_bf16_matches_plain(
        got, flash_attention_plain(q, k, v, causal, window))
    torch.testing.assert_close(
        got.float(), flash_attention_ref(q, k, v, causal, window).float(),
        rtol=5e-2, atol=5e-2)
    assert torch.equal(got, flash_attention(q, k, v, causal=causal,
                                            window=window))


@pytest.mark.gpu
def test_cuda_flash_attention_routes_by_dtype():
    """float32 goes to the 3xTF32 kernel, bfloat16 to the bfloat16 kernel;
    ``launches`` counts both."""
    _card()
    q = torch.randn(1, 2, 70, 64, device="cuda")
    before, routes = flash_attention.launches, \
        dict(flash_attention.launches_by_route)
    flash_attention(q, q, q)
    flash_attention(q.bfloat16(), q.bfloat16(), q.bfloat16())
    flash_attention(q.bfloat16(), q.bfloat16(), q.bfloat16(), causal=False)
    assert flash_attention.launches == before + 3
    assert flash_attention.launches_by_route == {
        "sm90_bf16": routes["sm90_bf16"] + 2,
        "sm90_tf32x3": routes["sm90_tf32x3"] + 1}


@pytest.mark.gpu
def test_cuda_flash_attention_sm90_takes_unaligned_and_strided_views():
    """A bfloat16 operand whose storage is not 16-byte aligned (TMA's rule) or
    not contiguous is copied, not refused."""
    _card()
    r = np.random.RandomState(3)
    base = torch.as_tensor(r.randn(2 * 3 * 65 * 64 + 1).astype(np.float32)) \
        .to("cuda", torch.bfloat16)
    q = base[1:].view(2, 3, 65, 64)
    assert q.data_ptr() % 16 != 0
    k = torch.as_tensor(r.randn(2, 65, 3, 64).astype(np.float32)) \
        .to("cuda", torch.bfloat16).transpose(1, 2)
    assert not k.is_contiguous()
    got = flash_attention(q, k, k)
    _assert_k6_bf16_matches_plain(got, flash_attention_plain(q, k, k))
    torch.testing.assert_close(
        got.float(), flash_attention_ref(q, k, k).float(), rtol=5e-2,
        atol=5e-2)


@pytest.mark.gpu
def test_cuda_flash_attention_sm90_rejects_what_it_does_not_take():
    _card()
    q = torch.zeros((1, 2, 8, 32), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head width"):
        flash_attention(q, q, q)
    q = torch.zeros((1, 3, 8, 64), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, q[:, :2], q[:, :2])
    with pytest.raises(ValueError, match="bfloat16"):
        flash_attention(q, q.float(), q)
    with pytest.raises(ValueError, match="bfloat16"):
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, q, q, window=-1)


@pytest.mark.gpu
@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window", [
    (1, 1, 1, 64, 64, True, 0), (2, 3, 1, 33, 64, True, 0),
    (1, 4, 1, 130, 64, False, 0), (2, 3, 3, 200, 64, True, 16),
    (1, 6, 2, 257, 64, True, 63), (1, 2, 1, 1100, 64, True, 1024),
    (1, 2, 2, 64, 128, False, 0), (2, 3, 1, 97, 128, True, 63),
    (1, 8, 2, 300, 128, True, 1024), (1, 4, 4, 33, 128, False, 16),
    (1, 1, 1, 64, 256, True, 0), (1, 3, 1, 130, 256, True, 16),
    (2, 4, 1, 70, 256, False, 63), (1, 4, 1, 1100, 256, True, 1024)])
def test_cuda_flash_attention_tf32x3_route(b, hq, hkv, s, d, causal, window):
    """K6's float32 route (3xTF32 on the tensor cores) against its plain
    version and the naive oracle at the reference's float32 tolerance,
    2e-4: head widths 64, 128 and 256; GQA ratios 1, 3 and 4; causal and
    not; windows of 16, BK - 1 = 63 and 1,024; S below, at and past the
    64-key tile and the 128-row block.  One launch, counted on
    ``sm90_tf32x3`` alone; a second launch equal to the first bit for bit."""
    _card()
    r = np.random.RandomState(11 * s + d)
    q, k, v = (torch.as_tensor(r.randn(b, h, s, d).astype(np.float32))
               .cuda() for h in (hq, hkv, hkv))
    routes = dict(flash_attention.launches_by_route)
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches_by_route == {
        "sm90_bf16": routes["sm90_bf16"],
        "sm90_tf32x3": routes["sm90_tf32x3"] + 1}
    assert got.dtype == torch.float32 and got.shape == q.shape
    for want in (flash_attention_plain(q, k, v, causal, window),
                 flash_attention_ref(q, k, v, causal, window)):
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    assert torch.equal(got, flash_attention(q, k, v, causal=causal,
                                            window=window))


@pytest.mark.gpu
@pytest.mark.parametrize("hq,hkv,s,d,window", [(15, 5, 2_048, 64, 0),
                                               (4, 1, 2_048, 256, 1_024)])
def test_cuda_flash_attention_tf32x3_precision_gate(hq, hkv, s, d, window):
    """K6's float32 route at the LM path's shapes (smollm-360m, gemma3-1b's
    local layer) on Gaussian q, k, v, against the plain recurrence in float64:
    within 2 x the plain float32 version's error, which one TF32 product
    (not 3xTF32) would fail."""
    _card()
    assert not torch.backends.cuda.matmul.allow_tf32
    r = np.random.RandomState(s + d)
    q, k, v = (torch.as_tensor(r.randn(2, h, s, d).astype(np.float32))
               .cuda() for h in (hq, hkv, hkv))
    ref = flash_attention_plain(q.double(), k.double(), v.double(), True,
                                window)
    assert ref.dtype == torch.float64
    _assert_gate(flash_attention(q, k, v, window=window),
                 flash_attention_plain(q, k, v, True, window), ref)


@pytest.mark.gpu
@pytest.mark.parametrize("s,m,n", [(83, 64, 500), (77, 400, 300),
                                   (130, 33, 64), (9, 1, 5)])
@pytest.mark.parametrize("k", [1, 2, 3, 8, 16, 17])
def test_cuda_grf_feature_kernel_ragged_and_fold_parity(s, m, n, k):
    """K5 at ragged m (one walker, a round and one, 64 and 400, the path's)
    and K (every vector width and column grouping the kernel picks) against
    its plain version; every column's bits equal a one-column call's, and a
    second launch the first's."""
    _card()
    r = np.random.RandomState(7 * s + m + k)
    pos = torch.as_tensor(r.randint(-2, n + 2, (s, m)).astype(np.int32)) \
        .cuda()
    load = torch.as_tensor(r.rand(s, m).astype(np.float32)).cuda()
    y = torch.as_tensor(r.randn(n, k).astype(np.float32)).cuda()
    got = grf_feature_matvec(pos, load, y)
    torch.testing.assert_close(got, grf_feature_plain(pos, load, y),
                               rtol=1e-5, atol=1e-6)
    assert torch.equal(got, grf_feature_matvec(pos, load, y))
    for c in range(k):
        assert torch.equal(got[:, c:c + 1], grf_feature_matvec(
            pos, load, y[:, c:c + 1].contiguous()))


@pytest.mark.gpu
def test_cuda_grf_feature_kernel_takes_an_unaligned_y():
    """y whose storage is not 16-byte aligned gets narrower vector loads."""
    _card()
    r = np.random.RandomState(4)
    base = torch.as_tensor(r.randn(50 * 16 + 1).astype(np.float32)).cuda()
    y = base[1:].view(50, 16)
    assert y.data_ptr() % 16 != 0
    pos = torch.as_tensor(r.randint(0, 50, (40, 64)).astype(np.int32)).cuda()
    load = torch.as_tensor(r.rand(40, 64).astype(np.float32)).cuda()
    got = grf_feature_matvec(pos, load, y)
    torch.testing.assert_close(got, grf_feature_plain(pos, load, y),
                               rtol=1e-5, atol=1e-6)
    assert torch.equal(got, grf_feature_matvec(pos, load, y.clone()))
