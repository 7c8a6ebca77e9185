"""Tests of the port that need a CUDA card; they skip without one.

Run them on the card with ``python -m pytest -m gpu tests/test_torch_gpu.py``.
This file imports neither JAX nor the reference package, so it runs where
only the port's dependencies are installed.
"""
import dataclasses
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
@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window,n", [
    (1, 15, 5, 2_048, 64, True, 0, 16), (2, 4, 1, 1_024, 128, True, 300, 4),
    (1, 4, 2, 768, 256, False, 0, 3), (2, 8, 2, 512, 64, False, 100, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_stripes_match_plain_and_the_whole(
        b, hq, hkv, s, d, causal, window, n, dtype):
    """K6's query stripes (``row_base``) on both routes: each stripe against
    the plain version at its offset (2e-4 in float32; bfloat16 at the
    limits above), the stripes concatenated equal to the whole launch bit
    for bit (each stripe a multiple of both kernels' query tiles), and a
    stripe at a ``row_base`` that is no multiple of 64 within tolerance;
    every launch on the dtype's route."""
    _card()
    from repro_torch.kernels.flash_attention.ops import flash_attention_fwd

    route = "sm90_bf16" if dtype == torch.bfloat16 else "sm90_tf32x3"
    r = np.random.RandomState(s + d + n)
    q, k, v = (torch.as_tensor(r.randn(b, h, s, d).astype(np.float32))
               .to("cuda", dtype) for h in (hq, hkv, hkv))
    rows = s // n
    before = dict(flash_attention.launches_by_route)
    total = flash_attention.launches
    whole = flash_attention(q, k, v, causal=causal, window=window)
    parts = []
    for i in range(n):
        qs = q[:, :, i * rows:(i + 1) * rows].contiguous()
        got = flash_attention_fwd(qs, k, v, causal, window, i * rows)
        want = flash_attention_plain(qs, k, v, causal, window, i * rows)
        if dtype == torch.bfloat16:
            _assert_k6_bf16_matches_plain(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
        parts.append(got)
    assert torch.equal(torch.cat(parts, dim=2), whole)
    r0 = s // 2 + 37
    qs = q[:, :, r0:r0 + rows // 2].contiguous()
    got = flash_attention_fwd(qs, k, v, causal, window, r0)
    want = flash_attention_plain(qs, k, v, causal, window, r0)
    if dtype == torch.bfloat16:
        _assert_k6_bf16_matches_plain(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(
        got.float(), flash_attention_ref(qs, k, v, causal, window,
                                         r0).float(),
        rtol=2e-4 if dtype == torch.float32 else 5e-2,
        atol=2e-4 if dtype == torch.float32 else 5e-2)
    assert flash_attention.launches - total == n + 2
    assert flash_attention.launches_by_route[route] - before[route] == n + 2


@pytest.mark.gpu
def test_cuda_flash_attention_tf32x3_gate_at_a_row_base():
    """The float32 route's precision gate on a stripe: the last half of
    smollm-360m's rows (``row_base`` 1,024) against the plain recurrence in
    float64 at that offset, within 2 x the plain float32 version's error."""
    _card()
    from repro_torch.kernels.flash_attention.ops import flash_attention_fwd

    r = np.random.RandomState(5)
    q, k, v = (torch.as_tensor(r.randn(2, h, 2_048, 64).astype(np.float32))
               .cuda() for h in (15, 5, 5))
    qs = q[:, :, 1_024:].contiguous()
    ref = flash_attention_plain(qs.double(), k.double(), v.double(), True, 0,
                                1_024)
    _assert_gate(flash_attention_fwd(qs, k, v, True, 0, 1_024),
                 flash_attention_plain(qs, k, v, True, 0, 1_024), ref)


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


# ------------------------------------------------- the serving engine
@pytest.fixture(scope="module")
def card_vdt():
    """A small model fitted on the card (the engine runs where it lies)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch import VariationalDualTree

    x = np.random.RandomState(40).randn(700, 12).astype(np.float32)
    return VariationalDualTree.fit(x, max_blocks=4 * 700)


def _engine_requests(n, seed, count=6, widths=(1, 2, 3), **extra):
    from repro_torch.serving import PropagateRequest

    rng = np.random.RandomState(seed)
    return [PropagateRequest(
        (rng.rand(n, int(rng.choice(widths))) > 0.7).astype(np.float32),
        alpha=float(rng.choice((0.01, 0.05, 0.2))), n_iters=10, **extra)
        for _ in range(count)]


def _capturing_engine(vdt, **kw):
    """A ``PropagateEngine`` that keeps a copy of every monolithic scan's
    padded stack, alphas and output."""
    from repro_torch.serving import PropagateEngine

    class Capturing(PropagateEngine):
        def _scan(self, vdt, stack, alphas, n_iters, backend, *,
                  n_walkers=None):
            out = super()._scan(vdt, stack, alphas, n_iters, backend,
                                n_walkers=n_walkers)
            self.scans.append((stack.clone(), np.array(alphas), out.clone(),
                               int(n_iters), n_walkers))
            return out

    eng = Capturing(vdt, start=False, **kw)
    eng.scans = []
    return eng


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["exact", "grf"])
def test_cuda_engine_equals_direct_call_bit_for_bit(card_vdt, backend):
    """K1 (exact) and K5 (grf) have no atomics: the engine's answers are a
    direct batched call on the same padded stack, bit for bit."""
    extra = dict(n_walkers=16) if backend == "grf" else {}
    eng = _capturing_engine(card_vdt, max_batch=8, backend=backend,
                            n_walkers=8, grf_seed=3)
    futs = [eng.submit(r) for r in
            _engine_requests(card_vdt.tree.n_points, 1, **extra)]
    launches = (folded_step if backend == "exact"
                else grf_feature_matvec).launches
    eng.flush()
    assert len(eng.scans) == 1
    stack, alphas, out, n_iters, n_walkers = eng.scans[0]
    assert stack.is_cuda and out.is_cuda
    assert (folded_step if backend == "exact"
            else grf_feature_matvec).launches - launches == n_iters
    kw = dict(n_walkers=n_walkers, seed=3) if backend == "grf" else {}
    direct = card_vdt.label_propagate(stack, alpha=alphas, n_iters=n_iters,
                                      batched=True, backend=backend, **kw)
    torch.testing.assert_close(out, direct, rtol=0, atol=0)
    for k, f in enumerate(futs):
        got = f.result(timeout=0)
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, out[k, :, :got.shape[1]].cpu())


@pytest.mark.gpu
def test_cuda_segmented_edf_exact_equals_monolithic(card_vdt):
    from repro_torch.serving import PropagateEngine

    reqs = _engine_requests(card_vdt.tree.n_points, 2, count=3, widths=(2,))
    seg = PropagateEngine(card_vdt, start=False, max_batch=4, policy="edf",
                          segment_iters=3, backend="exact")
    mono = PropagateEngine(card_vdt, start=False, max_batch=4,
                           backend="exact")
    got = [seg.submit(r) for r in reqs]
    want = [mono.submit(r) for r in reqs]
    seg.flush()
    mono.flush()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.result(timeout=0), w.result(timeout=0))


@pytest.mark.gpu
def test_cuda_vdt_engine_matches_a_cpu_copy(card_vdt):
    from repro_torch.serving import PropagateEngine

    reqs = _engine_requests(card_vdt.tree.n_points, 3)
    futs = {}
    for name, vdt in (("card", card_vdt), ("cpu", card_vdt.to("cpu"))):
        eng = PropagateEngine(vdt, start=False, max_batch=8)
        futs[name] = [eng.submit(r) for r in reqs]
        eng.flush()
    for g, w in zip(futs["card"], futs["cpu"]):
        np.testing.assert_allclose(g.result(timeout=0), w.result(timeout=0),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_cuda_background_engine_answers(card_vdt):
    """``start=True``: CUDA work launched from the scheduler thread."""
    from repro_torch.serving import PropagateEngine, propagate_many

    reqs = _engine_requests(card_vdt.tree.n_points, 4, count=5)
    with PropagateEngine(card_vdt, max_batch=4, max_wait_ms=1.0,
                         backend="exact") as eng:
        futs = [eng.submit(r) for r in reqs]
        got = [f.result(timeout=120) for f in futs]
    want = propagate_many(card_vdt, [dataclasses.replace(r, backend="exact")
                                     for r in reqs])
    for g, w, r in zip(got, want, reqs):
        assert g.shape == r.y0.shape
        np.testing.assert_allclose(g, w.cpu().numpy(), rtol=RTOL, atol=ATOL)
    assert eng.metrics().completed == 5


# ------------------------------------------ K1-K3 on the divergence tiles
def _positive(n, d, seed):
    """Points in every divergence's domain: |N(0, 1)| + 0.1."""
    r = np.random.RandomState(seed)
    return (np.abs(r.randn(n, d)) + 0.1).astype(np.float32)


def _divergence(name, d):
    from repro_torch.core.divergence import mahalanobis

    if name == "mahalanobis-scaled":
        return mahalanobis(np.linspace(0.5, 2.0, d))
    return name


DIV_TILES = ["kl", "itakura_saito", "mahalanobis-scaled"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", DIV_TILES)
@pytest.mark.parametrize("n,d,k,row_base", [(1000, 315, 2, 0),
                                            (4099, 64, 16, 0),
                                            (257, 5, 33, 0),
                                            (300, 16, 5, 37)])
def test_cuda_divergence_tiles_match_plain(name, n, d, k, row_base):
    """K1 on each divergence's tile against its plain version; the launch is
    counted on route tf32x3 and under the tile it ran."""
    _card()
    from repro_torch.kernels.fused_lp import kernel_tile, tile_config

    tile, _, transform = tile_config(_divergence(name, d))
    x = torch.as_tensor(_positive(n, d, seed=n)).cuda()
    if transform is not None:
        x = transform(x).contiguous()
    _, y, y0, al = (torch.as_tensor(v).cuda()
                    for v in _inputs(n, d, k, seed=n))
    rows, y0r = x[row_base:].contiguous(), y0[row_base:].contiguous()
    inv = 0.5 / d
    before = dict(folded_step.launches_by_tile)
    on_route = folded_step.launches_by_route["tf32x3"]
    got = folded_step(rows, x, y, y0r, al, inv, row_base, tile=tile)
    torch.cuda.synchronize()
    assert folded_step.launches_by_route["tf32x3"] == on_route + 1
    ran = kernel_tile(tile)
    assert folded_step.launches_by_tile[ran] == before[ran] + 1
    want = folded_step_plain(rows, x, y, y0r, al, inv, row_base,
                             tile_fn=None if tile is None else tile.tile)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("name", DIV_TILES)
def test_cuda_divergence_matvec_and_perbatch_match_plain(name):
    """K2 and K3 on each tile: against their plain versions, P row-stochastic,
    and K3 against K1 on the folded batch."""
    _card()
    n, d, b, c = 517, 40, 3, 2
    div = _divergence(name, d)
    x = torch.as_tensor(_positive(n, d, seed=5)).cuda()
    r = np.random.RandomState(6)
    y, y0 = (torch.as_tensor(r.rand(b, n, c).astype(np.float32)).cuda()
             for _ in range(2))
    sigma = math.sqrt(d)
    k2 = fused_lp_matvec(x, y[0], sigma, divergence=div)
    k3 = fused_lp_step_batched(x, y, y0, sigma, 0.3, reuse=False,
                               divergence=div)
    x_cpu = x.cpu()
    torch.testing.assert_close(k2.cpu(), fused_lp_matvec(
        x_cpu, y[0].cpu(), sigma, divergence=div), rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(k3.cpu(), fused_lp_step_batched(
        x_cpu, y.cpu(), y0.cpu(), sigma, 0.3, reuse=False, divergence=div),
        rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(k3, fused_lp_step_batched(
        x, y, y0, sigma, 0.3, reuse=True, divergence=div), rtol=RTOL,
        atol=ATOL)
    ones = torch.ones((n, 1), device="cuda")
    torch.testing.assert_close(fused_lp_matvec(x, ones, sigma, divergence=div),
                               ones, rtol=1e-5, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["kl", "itakura_saito"])
@pytest.mark.parametrize("k", [2, 16])
def test_cuda_divergence_tile_precision_gate(name, k):
    """The float64 gate per divergence tile, on positive Gaussian points."""
    _card()
    from repro_torch.core.divergence import get_divergence

    tile = get_divergence(name)
    n = 2_048
    x = torch.as_tensor(_positive(n, GATE_D, seed=23 + k)).cuda()
    r = np.random.RandomState(k)
    y = torch.as_tensor(r.rand(n, k).astype(np.float32)).cuda()
    al = torch.as_tensor(r.rand(k).astype(np.float32)).cuda()
    xd = x.double()
    span = tile.tile(xd[:64], xd)
    inv = 37.0 / float((span.amax(1) - span.amin(1)).mean())
    ref = folded_step_plain(xd, xd, y.double(), y.double(), al.double(), inv,
                            tile_fn=tile.tile)
    _assert_gate(folded_step(x, x, y, y, al, inv, tile=tile),
                 folded_step_plain(x, x, y, y, al, inv, tile_fn=tile.tile),
                 ref)


@pytest.mark.gpu
def test_cuda_custom_divergence_raises_on_the_exact_backend():
    """A registered divergence with no hand-written tile runs on the CPU's
    plain version, never on the card's in its place."""
    _card()
    from repro_torch.core.divergence import Divergence

    custom = Divergence(
        name="sq_plus_one", _phi=lambda x: (x * x).sum(-1),
        _grad_phi=lambda x: 2.0 * x,
        _pairwise=lambda a, b: ((a[:, None] - b[None]) ** 2).sum(-1) + 1.0,
        _log_partition=lambda dim, s: torch.log(torch.as_tensor(s)))
    x = torch.as_tensor(_positive(50, 4, seed=1))
    y = torch.rand(50, 2)
    fused_lp_matvec(x, y, 1.0, divergence=custom)  # plain twin on the CPU
    with pytest.raises(NotImplementedError, match="no tile for divergence"):
        fused_lp_matvec(x.cuda(), y.cuda(), 1.0, divergence=custom)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["kl", "itakura_saito", "mahalanobis-scaled"])
def test_cuda_divergence_fit_stream_and_exact_match_a_cpu_copy(name):
    """A fit on the card under each divergence, then an insert and a delete:
    each epoch against a CPU copy given the same mutation, and the exact
    backend through K1 against the plain version."""
    _card()
    from repro_torch import VariationalDualTree

    n, d = 300, 12
    div = _divergence(name, d)
    x = _positive(n, d, seed=9)
    vdt = VariationalDualTree.fit(x, max_blocks=4 * n, capacity=512,
                                  divergence=div)
    cpu = vdt.to("cpu")
    x_new = _positive(20, d, seed=10)
    epochs = []
    for model in (vdt, cpu):
        upd = model.insert_points(x_new)
        upd = upd.vdt.delete_points(np.arange(0, 60, 3))
        epochs.append(upd)
    card, host = epochs
    assert card.touched_blocks == host.touched_blocks
    assert card.stale_blocks == host.stale_blocks
    np.testing.assert_array_equal(card.vdt.bp.active, host.vdt.bp.active)
    lq_c = card.vdt.qstate.log_q.cpu().numpy()
    lq_h = host.vdt.qstate.log_q.numpy()
    np.testing.assert_array_equal(np.isfinite(lq_c), np.isfinite(lq_h))
    fin = np.isfinite(lq_h)
    np.testing.assert_allclose(lq_c[fin], lq_h[fin], rtol=1e-3, atol=5e-4)
    m = card.vdt.tree.n_points
    y0 = (np.random.RandomState(3).rand(m, 2) > 0.8).astype(np.float32)
    before = folded_step.launches
    got = card.vdt.label_propagate(y0, alpha=0.1, n_iters=4, backend="exact")
    assert folded_step.launches == before + 4
    want = host.vdt.label_propagate(y0, alpha=0.1, n_iters=4, backend="exact")
    torch.testing.assert_close(got.cpu(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        card.vdt.label_propagate(y0, alpha=0.1, n_iters=4).cpu().numpy(),
        host.vdt.label_propagate(y0, alpha=0.1, n_iters=4).numpy(),
        rtol=RTOL, atol=ATOL)


# ------------------------------------------------- the sharded engine
@pytest.mark.gpu
@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("segmented", [False, True])
def test_cuda_sharded_exact_engine_equals_the_single_engine(card_vdt,
                                                            n_shards,
                                                            segmented):
    """D shards on one card: each stripe is one K1 launch with its
    ``row_base``, bit for bit the single engine's answers."""
    from repro_torch.serving import PropagateEngine, ShardedPropagateEngine

    reqs = _engine_requests(card_vdt.tree.n_points, 5, count=4)
    kw = dict(policy="edf", segment_iters=3) if segmented else {}
    single = PropagateEngine(card_vdt, start=False, max_batch=4,
                             backend="exact")
    sharded = ShardedPropagateEngine(card_vdt, devices=["cuda:0"] * n_shards,
                                     start=False, max_batch=4,
                                     backend="exact", **kw)
    want = [single.submit(r) for r in reqs]
    single.flush()
    got = [sharded.submit(r) for r in reqs]
    before = folded_step.launches
    sharded.flush()
    assert folded_step.launches - before == n_shards * reqs[0].n_iters
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.result(timeout=0), w.result(timeout=0))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["kl", "mahalanobis-scaled"])
def test_cuda_sharded_exact_engine_keeps_the_divergence(name):
    """Under a divergence the stripes run K1 on its tile (Mahalanobis: on
    the pre-mapped points), bit for bit the single engine's answers."""
    _card()
    from repro_torch import VariationalDualTree
    from repro_torch.kernels.fused_lp import kernel_tile, tile_config
    from repro_torch.serving import PropagateEngine, ShardedPropagateEngine

    div = _divergence(name, 12)
    vdt = VariationalDualTree.fit(_positive(700, 12, seed=41),
                                  max_blocks=4 * 700, divergence=div)
    reqs = _engine_requests(vdt.tree.n_points, 7, count=4)
    single = PropagateEngine(vdt, start=False, max_batch=4, backend="exact")
    want = [single.submit(r) for r in reqs]
    single.flush()
    sharded = ShardedPropagateEngine(vdt, devices=["cuda:0"] * 4,
                                     start=False, max_batch=4,
                                     backend="exact")
    got = [sharded.submit(r) for r in reqs]
    ran = kernel_tile(tile_config(vdt.bound_divergence.div)[0])
    before = folded_step.launches_by_tile[ran]
    sharded.flush()
    assert folded_step.launches_by_tile[ran] - before == 4 * reqs[0].n_iters
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.result(timeout=0), w.result(timeout=0))


@pytest.mark.gpu
def test_cuda_sharded_vdt_engine_matches_the_single_engine(card_vdt):
    """``index_add_`` reduces with atomics on the card: within tolerance."""
    from repro_torch.serving import PropagateEngine, ShardedPropagateEngine

    reqs = _engine_requests(card_vdt.tree.n_points, 6, count=4)
    futs = {}
    for name, eng in (("single", PropagateEngine(card_vdt, start=False,
                                                 max_batch=4)),
                      ("sharded", ShardedPropagateEngine(
                          card_vdt, devices=["cuda:0"] * 4, start=False,
                          max_batch=4))):
        futs[name] = [eng.submit(r) for r in reqs]
        eng.flush()
    for g, w in zip(futs["sharded"], futs["single"]):
        np.testing.assert_allclose(g.result(timeout=0), w.result(timeout=0),
                                   rtol=RTOL, atol=ATOL)


# ------------------------------------------------------- the MoE layer
@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mixtral-8x7b"])
def test_cuda_moe_apply_matches_a_cpu_copy(arch):
    """The smoke-width MoE layer on the card against the same parameters on
    the CPU, in float32: the same routing, outputs within 2e-3."""
    _card()
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(4)
    params = moe.moe_init(gen, cfg, device="cuda")
    host = {k: ({kk: vv.cpu() for kk, vv in v.items()}
                if isinstance(v, dict) else v.cpu())
            for k, v in params.items()}
    x = torch.randn(2, 40, cfg.d_model, generator=gen, device="cuda")
    y, aux = moe.moe_apply(params, x, cfg, torch.float32)
    y_cpu, aux_cpu = moe.moe_apply(host, x.cpu(), cfg, torch.float32)
    top = [torch.topk(torch.softmax(t.reshape(-1, cfg.d_model)
                                    @ p["router"], -1),
                      cfg.experts_per_token)[1].cpu()
           for t, p in ((x, params), (x.cpu(), host))]
    assert torch.equal(*top)
    torch.testing.assert_close(y.cpu(), y_cpu, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(aux.cpu(), aux_cpu, rtol=1e-5, atol=1e-6)


# ------------------------------------ the SSM, hybrid and vlm families
def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("arch,k6_launches", [("mamba2-130m", 0),
                                              ("zamba2-1.2b", 2),
                                              ("internvl2-1b", 2)])
def test_cuda_ssm_hybrid_and_vlm_serve_like_a_cpu_copy(arch, k6_launches):
    """The smoke configuration at d_model 128 with heads of 64 (K6 takes
    D = 64): prefill (chunks of 16 over 48 tokens; zamba2's window 16
    through K6) and three decode steps in float32 on the card against the
    same parameters on the CPU at 2e-3; K6 launched once per attention point
    a prefill, on its float32 route, and in bfloat16 on its bf16 route."""
    _card()
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import transformer
    from repro_torch.serving import decode

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                              d_model=128, n_heads=2,
                              n_kv_heads=1 if arch == "internvl2-1b" else 2,
                              d_ff=256, ssm_chunk=16)
    host = transformer.init_lm(cfg, 5, device="cpu")
    card = _to(host, "cuda")
    rng = np.random.RandomState(5)
    tokens = rng.randint(0, cfg.vocab_size, (2, 51))
    patches = (torch.as_tensor(rng.randn(2, cfg.n_patches, 128)
                               .astype(np.float32))
               if cfg.n_patches else None)
    results = []
    for params, dev in ((card, "cuda"), (host, "cpu")):
        before = dict(flash_attention.launches_by_route)
        logits, state = decode.prefill(
            params, tokens[:, :48], cfg,
            patches=None if patches is None else patches.to(dev))
        after = flash_attention.launches_by_route
        if dev == "cuda":
            assert after.get("sm90_tf32x3", 0) - before.get(
                "sm90_tf32x3", 0) == k6_launches
            assert sum(after.values()) - sum(before.values()) == k6_launches
        steps = [logits]
        for t in range(48, 51):
            logits, state = decode.decode_step(params, tokens[:, t:t + 1],
                                               state, cfg)
            steps.append(logits)
        results.append(torch.stack(steps).cpu())
    torch.testing.assert_close(results[0], results[1], rtol=2e-3, atol=2e-3)
    bf16 = dataclasses.replace(cfg, dtype="bfloat16")
    before = dict(flash_attention.launches_by_route)
    logits, _ = decode.prefill(card, tokens[:, :48], bf16, patches=None
                               if patches is None else patches.cuda())
    after = flash_attention.launches_by_route
    assert after.get("sm90_bf16", 0) - before.get("sm90_bf16", 0) == \
        k6_launches
    assert sum(after.values()) - sum(before.values()) == k6_launches
    assert bool(torch.isfinite(logits.float()).all())


# ------------------------------- K6's gradient, the audio family, training
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window", [
    (2, 15, 5, 130, 64, True, 0), (1, 4, 1, 200, 128, True, 48),
    (2, 4, 4, 100, 256, False, 0), (1, 6, 2, 1_500, 64, False, 0)])
def test_cuda_k6_gradient_matches_autograd_reference(b, hq, hkv, s, d, causal,
                                                     window, dtype):
    """dq, dk, dv through K6's autograd route (the kernel's forward, one
    counted launch; the float32 torch backward, none) against autograd
    through ``ref.py``'s dense float32 softmax: ``2e-4`` in float32,
    ``1e-2`` in bfloat16 (the gradients' own rounding)."""
    _card()
    tol = 2e-4 if dtype == torch.float32 else 1e-2
    g = torch.Generator().manual_seed(s + d)
    q, k, v = (torch.randn(b, h, s, d, generator=g).to("cuda", dtype)
               .requires_grad_() for h in (hq, hkv, hkv))
    dout = torch.randn(b, hq, s, d, generator=g).to("cuda", dtype)
    before = flash_attention.launches
    got = torch.autograd.grad(flash_attention(q, k, v, causal, window),
                              (q, k, v), dout)
    assert flash_attention.launches == before + 1
    ref_in = [t.detach().float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention_ref(*ref_in, causal, window),
                               ref_in, dout.float())
    for a, w in zip(got, want):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), w, rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_k6_bidirectional_at_the_whisper_encoder_shape(dtype):
    """whisper-medium's encoder attention (16/16 heads of 64, S = 1,500, not
    a multiple of the 64-key tile, ``causal=False``) against K6's plain
    version."""
    _card()
    g = torch.Generator().manual_seed(15)
    q, k, v = (torch.randn(2, 16, 1_500, 64, generator=g).to("cuda", dtype)
               for _ in range(3))
    got = flash_attention(q, k, v, causal=False)
    want = flash_attention_plain(q, k, v, causal=False)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    else:
        _assert_k6_bf16_matches_plain(got, want)


def _small(arch):
    from repro_torch.configs.registry import get_smoke_config

    return dataclasses.replace(get_smoke_config(arch), dtype="float32",
                               d_model=128, n_heads=2, n_kv_heads=2,
                               d_ff=256)


@pytest.mark.gpu
def test_cuda_whisper_serves_like_a_cpu_copy():
    """whisper at d_model 128 (heads of 64, 100 frames): ``encdec_forward``,
    prefill and three decode steps in float32 on the card against the same
    parameters on the CPU at 2e-3; K6 launched at every encoder and decoder
    layer of a prefill on its float32 route."""
    _card()
    from repro_torch.models import whisper
    from repro_torch.serving import decode

    cfg = dataclasses.replace(_small("whisper-medium"), encoder_frames=100)
    host = whisper.init_encdec(cfg, 6, device="cpu")
    card = _to(host, "cuda")
    rng = np.random.RandomState(6)
    tokens = rng.randint(0, cfg.vocab_size, (2, 23))
    frames = torch.as_tensor(rng.randn(2, 100, 128).astype(np.float32))
    results = []
    for params, dev in ((card, "cuda"), (host, "cpu")):
        full, _ = whisper.encdec_forward(params, tokens, frames.to(dev), cfg)
        before = dict(flash_attention.launches_by_route)
        logits, state = decode.prefill(params, tokens[:, :20], cfg,
                                       frames=frames.to(dev))
        after = flash_attention.launches_by_route
        if dev == "cuda":
            n = cfg.n_layers + cfg.n_encoder_layers
            assert after["sm90_tf32x3"] - before["sm90_tf32x3"] == n
            assert sum(after.values()) - sum(before.values()) == n
        steps = [logits]
        for t in range(20, 23):
            logits, state = decode.decode_step(params, tokens[:, t:t + 1],
                                               state, cfg)
            steps.append(logits)
        results.append((full.cpu(), torch.stack(steps).cpu()))
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, rtol=2e-3, atol=2e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["smollm-360m", "whisper-medium"])
def test_cuda_train_step_matches_a_cpu_copy(arch):
    """One ``make_train_step`` step in float32 on the card (K6's float32
    route forward, its torch backward) against the same step on a CPU copy:
    loss, grad norm and every updated parameter at 2e-3."""
    _card()
    from repro_torch.models import transformer, whisper
    from repro_torch.training import (AdamWConfig, init_train_state,
                                      make_train_step)

    cfg = _small(arch)
    if arch == "whisper-medium":
        cfg = dataclasses.replace(cfg, encoder_frames=100)
        host = whisper.init_encdec(cfg, 7, device="cpu")
    else:
        host = transformer.init_lm(cfg, 7, device="cpu")
    rng = np.random.RandomState(7)
    batch = {"tokens": torch.as_tensor(rng.randint(0, cfg.vocab_size,
                                                   (2, 41)))}
    if arch == "whisper-medium":
        batch["frames"] = torch.as_tensor(
            rng.randn(2, 100, 128).astype(np.float32))
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    step = make_train_step(cfg, opt)
    got, m_got = step(init_train_state(_to(host, "cuda"), opt),
                      _to(batch, "cuda"))
    want, m_want = step(init_train_state(host, opt), batch)
    for name in ("loss", "grad_norm"):
        torch.testing.assert_close(m_got[name].cpu(), m_want[name],
                                   rtol=2e-3, atol=2e-3)
    for a, b in zip(transformer.leaves(got.params),
                    transformer.leaves(want.params)):
        torch.testing.assert_close(a.cpu(), b, rtol=2e-3, atol=2e-3)


def _random_state(cfg, seed, device):
    """A train state of ``cfg`` on ``device`` with seeded parameters and
    moments, each leaf distinct (so that a swap would show)."""
    from repro_torch._tree import map_leaves
    from repro_torch.models import transformer
    from repro_torch.training import AdamWConfig, init_train_state

    state = init_train_state(transformer.init_lm(cfg, seed, device="cpu"),
                             AdamWConfig())
    g = torch.Generator().manual_seed(seed)
    for tree in (state.opt.mu, state.opt.nu):
        for t in transformer.leaves(tree):
            t.copy_(torch.randn(t.shape, generator=g))
    return map_leaves(lambda t: t.to(device), state)


@pytest.mark.gpu
def test_cuda_checkpoint_moves_between_the_card_and_the_cpu(tmp_path):
    """A card train state saved, restored onto the CPU, saved from there and
    restored onto the card: every leaf bit for bit, on the asked device."""
    _card()
    from repro_torch._tree import flatten
    from repro_torch.runtime import checkpoint as ckpt

    state = _random_state(_small("smollm-360m"), 8, "cuda")
    ckpt.save(tmp_path / "card", 3, state, fingerprint="fp")
    host, step = ckpt.restore(tmp_path / "card", state, device="cpu",
                              expect_fingerprint="fp")
    ckpt.save(tmp_path / "host", step, host, fingerprint="fp")
    back, _ = ckpt.restore(tmp_path / "host", host, device="cuda")
    want = flatten(state)[0]
    for a, b, c in zip(want, flatten(host)[0], flatten(back)[0]):
        assert b.device.type == "cpu" and c.device.type == "cuda"
        assert a.dtype == b.dtype == c.dtype
        assert torch.equal(a.cpu(), b) and torch.equal(a, c)


@pytest.mark.gpu
def test_cuda_compress_tree_matches_a_cpu_copy():
    """bf16 bit for bit; int8 bit for bit under the same uniforms, and with
    the card's own generator within one quantisation step a tensor."""
    _card()
    from repro_torch.distributed.compression import (compress_tree,
                                                     decompress_tree)

    g = torch.Generator().manual_seed(12)
    host = {"layers": {"w": torch.randn(4, 96, 80, generator=g) * 3},
            "embed": torch.randn(1000, 96, generator=g) * 1e-3,
            "ln": torch.zeros(96)}
    card = _to(host, "cuda")
    got, want = (compress_tree(t, "bf16")[0] for t in (card, host))
    assert torch.equal(got["embed"].cpu().view(torch.int16),
                       want["embed"].view(torch.int16))
    assert torch.equal(got["layers"]["w"].cpu().view(torch.int16),
                       want["layers"]["w"].view(torch.int16))
    uniforms = {"layers": {"w": torch.rand(4, 96, 80, generator=g)},
                "embed": torch.rand(1000, 96, generator=g),
                "ln": torch.rand(96, generator=g)}
    (q_c, s_c), (q_h, s_h) = (compress_tree(t, "int8", uniforms=u) for t, u
                              in ((card, _to(uniforms, "cuda")),
                                  (host, uniforms)))
    for key in ("embed", "ln"):
        assert torch.equal(q_c[key].cpu(), q_h[key])
        assert torch.equal(s_c[key].cpu(), s_h[key])
    assert torch.equal(q_c["layers"]["w"].cpu(), q_h["layers"]["w"])
    q, s = compress_tree(card, "int8",
                         generator=torch.Generator("cuda").manual_seed(1))
    deq = decompress_tree(q, s, "int8")
    for d, x, step, qq in ((deq["embed"], card["embed"], s["embed"],
                            q["embed"]),
                           (deq["layers"]["w"], card["layers"]["w"],
                            s["layers"]["w"], q["layers"]["w"])):
        assert qq.dtype == torch.int8
        assert float((d - x).abs().max()) <= float(step) * (1 + 1e-6)


def _stage_fn(cfg, per_stage):
    """``pipeline_forward``'s stage: ``per_stage`` layers of the LM."""
    from repro_torch.models import transformer
    from repro_torch.models.layers import Dtypes

    windows = transformer.layer_windows(cfg)

    def stage_fn(sp, x, s):
        b, t, _ = x.shape
        positions = torch.arange(t, device=x.device)[None].expand(b, t)
        for i in range(per_stage):
            x, _ = transformer._layer({}, transformer.layer_params(sp, i), x,
                                      positions, cfg, Dtypes.compute(cfg),
                                      windows[s * per_stage + i], 0)
        return x
    return stage_fn


@pytest.mark.gpu
def test_cuda_pipeline_forward_equals_the_stages_in_sequence():
    """8 layers at d_model 128 as 4 stages of 2 on ``["cuda:0"] * 4``, 6
    microbatches: bit for bit the stages run one after another on each
    microbatch; K6 launched once a layer and microbatch."""
    _card()
    from repro_torch._tree import map_leaves
    from repro_torch.distributed.pipeline import pipeline_forward
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import transformer

    cfg = dataclasses.replace(_small("smollm-360m"), n_layers=8)
    params = transformer.init_lm(cfg, 9, device="cuda")
    stages = map_leaves(lambda v: v.reshape(4, 2, *v.shape[1:]),
                        params["layers"])
    x = torch.randn(6, 2, 40, 128, device="cuda")
    stage_fn = _stage_fn(cfg, 2)
    before = flash_attention.launches_by_route["sm90_tf32x3"]
    got = pipeline_forward(stage_fn, stages, x, make_local_mesh(
        data=4, devices=["cuda:0"] * 4), axis="data")
    assert flash_attention.launches_by_route["sm90_tf32x3"] - before == 48
    for m in range(6):
        h = x[m]
        for s in range(4):
            h = stage_fn(map_leaves(lambda p: p[s], stages), h, s)
        assert torch.equal(got[m], h)


@pytest.mark.gpu
def test_cuda_launcher_steps_match_a_cpu_copy(tmp_path, monkeypatch, capsys):
    """Two launcher steps at d_model 128 on the card and on the CPU, both
    resumed from one step-0 checkpoint: the final checkpoints agree at the
    train-step tolerance (parameters 2e-3, moments 2e-3 of each tensor's
    largest magnitude), K6 launched once a layer a step on the card."""
    _card()
    from repro_torch.launch import train
    from repro_torch.models import transformer
    from repro_torch.runtime import checkpoint as ckpt
    from repro_torch.training import AdamWConfig, init_train_state

    cfg = _small("smollm-360m")
    monkeypatch.setattr(train, "get_smoke_config", lambda arch: cfg)
    start = init_train_state(transformer.init_lm(cfg, 3, device="cpu"),
                             AdamWConfig())
    out = {}
    for dev in ("cuda", "cpu"):
        ckpt.save(tmp_path / dev, 0, start,
                  fingerprint=ckpt.config_fingerprint(cfg))
        before = flash_attention.launches
        assert train.main(["--arch", "smollm-360m", "--smoke", "--steps", "2",
                           "--batch", "2", "--seq", "64", "--ckpt-every", "5",
                           "--device", dev, "--ckpt-dir",
                           str(tmp_path / dev)]) == 0
        if dev == "cuda":
            assert flash_attention.launches - before == 2 * cfg.n_layers
        assert "resumed from step 0" in capsys.readouterr().out
        out[dev], _ = ckpt.restore(tmp_path / dev, start, device="cpu")
    for a, b in zip(transformer.leaves(out["cuda"].params),
                    transformer.leaves(out["cpu"].params)):
        torch.testing.assert_close(a, b, rtol=2e-3, atol=2e-3)
    for tree in ("mu", "nu"):
        for a, b in zip(transformer.leaves(getattr(out["cuda"].opt, tree)),
                        transformer.leaves(getattr(out["cpu"].opt, tree))):
            torch.testing.assert_close(
                a, b, rtol=2e-3, atol=2e-3 * float(b.abs().max()))
    assert int(out["cuda"].step) == int(out["cpu"].step) == 2


@pytest.mark.gpu
@pytest.mark.parametrize("shape,k6", [("prefill_32k", 2), ("decode_32k", 0),
                                      ("train_4k", 2)])
def test_cuda_counted_work_equals_the_meta_count(shape, k6):
    """``launch/dryrun.py::count_work`` of one cell's step (smollm cut to
    d_model 128, heads of 64, batch 1) counts on the card what it counts on
    meta tensors, FLOPs and bytes; K6 launches once a layer (float32 route),
    counted by its formula and not by what runs inside it."""
    _card()
    from repro_torch.launch import dryrun

    cfg = _small("smollm-360m")
    fn, args, *_ = dryrun.build_cell("smollm-360m", shape, False,
                                     cfg_override=cfg, batch_override=1)
    want = dryrun.count_work(fn, *args)
    fn, args, *_ = dryrun.build_cell("smollm-360m", shape, False,
                                     cfg_override=cfg, batch_override=1,
                                     device="cuda")
    before = flash_attention.launches_by_route.get("sm90_tf32x3", 0)
    got = dryrun.count_work(fn, *args)
    torch.cuda.synchronize()
    assert got == want
    assert flash_attention.launches_by_route.get("sm90_tf32x3", 0) == \
        before + k6


@pytest.mark.gpu
def test_cuda_spmd_one_rank_mesh_matches_plain_tensors(tmp_path):
    """smollm cut to d_model 128 (heads of 64) as DTensors over a one-rank
    NCCL mesh: a float32 prefill and train step equal the same calls on
    plain tensors (``rtol=1e-5``, ``atol`` 1e-6 of the largest magnitude, at
    least 1), K6 launched once a layer in the prefill, twice in the step
    (``remat``), all on its float32 route."""
    _card()
    from repro_torch._device import is_dtensor
    from repro_torch.distributed.sharding import (ShardCtx, shard_batch,
                                                  shard_params, use_ctx)
    from repro_torch.launch.mesh import device_mesh, file_process_group
    from repro_torch.models.transformer import init_lm
    from repro_torch.serving.decode import prefill
    from repro_torch.training import (AdamWConfig, init_train_state,
                                      make_train_step)

    cfg = dataclasses.replace(_small("smollm-360m"), remat=True)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-4)
    torch.cuda.set_device(0)
    params = init_lm(cfg, 0, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (2, 65),
                           generator=torch.Generator().manual_seed(0)).cuda()
    step = make_train_step(cfg, opt)

    def close(got, want):
        got = got.full_tensor() if is_dtensor(got) else got
        atol = 1e-6 * max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got, want, rtol=1e-5, atol=atol)

    with file_process_group("nccl", 0, 1, tmp_path / "store",
                            device="cuda:0"):
        ctx = ShardCtx(mesh=device_mesh((1, 1), ("data", "model"), "cuda"))
        want = prefill(params, tokens[:, :-1], cfg)[0]
        plain, pm = step(init_train_state(params, opt), {"tokens": tokens})
        sharded = shard_params(params, ctx)
        before = flash_attention.launches_by_route.get("sm90_tf32x3", 0)
        with use_ctx(ctx):
            got = prefill(sharded, shard_batch(tokens[:, :-1], ctx), cfg)[0]
            new, m = step(init_train_state(sharded, opt),
                          {"tokens": shard_batch(tokens, ctx)})
        torch.cuda.synchronize()
        assert flash_attention.launches_by_route.get("sm90_tf32x3", 0) == \
            before + 3 * cfg.n_layers
        close(got, want)
        close(m["loss"], pm["loss"])
        close(m["grad_norm"], pm["grad_norm"])
        for k in ("embed", "unembed"):
            close(new.params[k], plain.params[k])
        for k, w in plain.params["layers"]["attn"].items():
            close(new.params["layers"]["attn"][k], w)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_cuda_spmd_count_on_a_fake_group_equals_meta(shape):
    """The dry run's sharded cell (``build_sharded_cell``, smollm cut to
    d_model 128, heads of 64, batch 2, train with remat) counted per device
    on a fake 2 x 2 group: CUDA shards and meta shards give the same
    FLOPs, bytes, collective records and argument bytes."""
    _card()
    from repro_torch.launch.dryrun import build_sharded_cell, count_sharded
    from repro_torch.launch.mesh import device_mesh, fake_process_group

    cfg = dataclasses.replace(_small("smollm-360m"),
                              remat=shape == "train_4k")
    works = []
    with fake_process_group(4):
        mesh = device_mesh((2, 2), ("data", "model"), "cuda")
        for device in ("cuda", "meta"):
            fn, args, arg_bytes, *_ = build_sharded_cell(
                "smollm-360m", shape, False, cfg_override=cfg,
                batch_override=2, device=device, mesh=mesh)
            work = count_sharded(fn, *args)
            works.append((work.flops, work.bytes, work.collectives,
                          arg_bytes))
        torch.cuda.synchronize()
    card, meta = works
    assert card == meta
    assert card[0] > 0 and card[1] > 0 and card[2]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_k6_on_head_shards_matches_plain(dtype):
    """K6 through its DTensor rule with q, k, v sharded by heads over a
    fake 2-rank axis: rank 0's shard is the kernel on the first half of the
    heads (GQA 4 / 2), equal to the plain version on those heads."""
    _card()
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.launch.mesh import device_mesh, fake_process_group

    g = torch.Generator().manual_seed(3)
    q = torch.randn(2, 4, 256, 64, generator=g).to("cuda", dtype)
    k, v = (torch.randn(2, 2, 256, 64, generator=g).to("cuda", dtype)
            for _ in range(2))
    with fake_process_group(2):
        mesh = device_mesh((2,), ("model",), "cuda")
        dq, dk, dv = (DTensor.from_local(t[:, :t.shape[1] // 2], mesh,
                                         [Shard(1)], run_check=False,
                                         shape=t.shape, stride=t.stride())
                      for t in (q, k, v))
        out = flash_attention(dq, dk, dv, causal=True)
        assert tuple(out.placements) == (Shard(1),)
        got = out.to_local()
        torch.cuda.synchronize()
    want = flash_attention_plain(q[:, :2], k[:, :1], v[:, :1], causal=True)
    if dtype == torch.bfloat16:
        _assert_k6_bf16_matches_plain(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


SPMD_FAMILIES = ("deepseek-moe-16b", "mamba2-130m", "zamba2-1.2b")


def _small_family(arch):
    """``_small`` with an SSD chunk of 16 (prompts of 64 tokens)."""
    return dataclasses.replace(_small(arch), ssm_chunk=16)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", SPMD_FAMILIES)
def test_cuda_spmd_family_one_rank_mesh_matches_plain_tensors(arch,
                                                              tmp_path):
    """The MoE, SSM and hybrid SMOKE models at d_model 128 (heads of 64) as
    DTensors over a one-rank NCCL mesh: a float32 prefill of 2 x 64 tokens
    and 3 decode steps equal the same calls on plain tensors (``rtol=1e-5``,
    ``atol`` 1e-6 of the largest magnitude, at least 1); K6 launched once a
    prefill's attention layer (the hybrid's shared block), on its float32
    route."""
    _card()
    from repro_torch._device import is_dtensor
    from repro_torch.distributed.sharding import (ShardCtx, shard_batch,
                                                  shard_params, use_ctx)
    from repro_torch.launch.mesh import device_mesh, file_process_group
    from repro_torch.models.transformer import init_lm
    from repro_torch.serving.decode import decode_step, prefill

    cfg = _small_family(arch)
    torch.cuda.set_device(0)
    params = init_lm(cfg, 0, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (2, 64 + 3),
                           generator=torch.Generator().manual_seed(0)).cuda()
    k6 = {"moe": cfg.n_layers, "ssm": 0,
          "hybrid": sum(cfg.layer_is_attn(i) for i in range(cfg.n_layers))}

    def close(got, want):
        got = got.full_tensor() if is_dtensor(got) else got
        atol = 1e-6 * max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got, want, rtol=1e-5, atol=atol)

    with file_process_group("nccl", 0, 1, tmp_path / "store",
                            device="cuda:0"):
        ctx = ShardCtx(mesh=device_mesh((1, 1), ("data", "model"), "cuda"))
        want, state = prefill(params, tokens[:, :64], cfg)
        sharded = shard_params(params, ctx,
                               expert_parallel=cfg.expert_parallel)
        before = flash_attention.launches_by_route.get("sm90_tf32x3", 0)
        with use_ctx(ctx):
            got, sstate = prefill(sharded, shard_batch(tokens[:, :64], ctx),
                                  cfg)
        torch.cuda.synchronize()
        assert flash_attention.launches_by_route.get("sm90_tf32x3", 0) == \
            before + k6[cfg.family]
        close(got, want)
        for i in range(64, 67):
            want, state = decode_step(params, tokens[:, i:i + 1], state, cfg)
            with use_ctx(ctx):
                got, sstate = decode_step(
                    sharded, shard_batch(tokens[:, i:i + 1], ctx), sstate,
                    cfg)
            close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", SPMD_FAMILIES)
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_cuda_spmd_family_count_on_a_fake_group_equals_meta(arch, shape):
    """The dry run's sharded cell of an MoE, SSM or hybrid model (its SMOKE
    configuration at d_model 128, heads of 64, 2 layers (the hybrid 4), 64
    tokens, batch 2, train with remat) counted per device on a fake 2 x 2
    group: CUDA shards and meta shards give the same FLOPs, bytes,
    collective records and argument bytes."""
    _card()
    from repro_torch.configs import shapes
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import device_mesh, fake_process_group

    cfg = dataclasses.replace(_small_family(arch),
                              remat=shape == "train_4k")
    spec = dryrun.SHAPES[shape]
    works = []
    try:
        dryrun.SHAPES[shape] = shapes.ShapeSpec(shape, 64, 2, spec.kind)
        with fake_process_group(4):
            mesh = device_mesh((2, 2), ("data", "model"), "cuda")
            for device in ("cuda", "meta"):
                fn, args, arg_bytes, *_ = dryrun.build_sharded_cell(
                    arch, shape, False, cfg_override=cfg, batch_override=2,
                    device=device, mesh=mesh)
                work = dryrun.count_sharded(fn, *args)
                works.append((work.flops, work.bytes, work.collectives,
                              arg_bytes))
            torch.cuda.synchronize()
    finally:
        dryrun.SHAPES[shape] = spec
    card, meta = works
    assert card == meta
    assert card[0] > 0 and card[1] > 0 and card[2]


ENCDEC = ("internvl2-1b", "whisper-medium")


def _encdec_extras(cfg, batch: int, seed: int) -> dict:
    """A vlm's patch or an audio model's frame embeddings, seeded."""
    name, n = (("frames", cfg.encoder_frames) if cfg.family == "audio"
               else ("patches", cfg.n_patches))
    return {name: torch.as_tensor(np.random.RandomState(seed).randn(
        batch, n, cfg.d_model).astype(np.float32))}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ENCDEC)
def test_cuda_spmd_encdec_one_rank_mesh_matches_plain_tensors(arch,
                                                              tmp_path):
    """internvl2-1b and whisper-medium at d_model 128 (heads of 64) as
    DTensors over a one-rank NCCL mesh, their patch or frame embeddings
    sharded by batch: a float32 prefill of 2 x 64 tokens, 3 decode steps
    and a train step (remat) equal the same calls on plain tensors
    (``rtol=1e-5``, ``atol`` 1e-6 of the largest magnitude, at least 1);
    K6 launched once a prefill's self-attention layer (whisper's encoder
    layers too) and twice in the step, on its float32 route."""
    _card()
    from repro_torch._device import is_dtensor
    from repro_torch.distributed.sharding import (ShardCtx, shard_batch,
                                                  shard_params, use_ctx)
    from repro_torch.launch.mesh import device_mesh, file_process_group
    from repro_torch.models.transformer import init_lm, leaves
    from repro_torch.models.whisper import init_encdec
    from repro_torch.serving.decode import decode_step, prefill
    from repro_torch.training import (AdamWConfig, init_train_state,
                                      make_train_step)

    cfg = dataclasses.replace(_small(arch), remat=True)
    audio = cfg.family == "audio"
    torch.cuda.set_device(0)
    params = (init_encdec if audio else init_lm)(cfg, 0, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (2, 64 + 3),
                           generator=torch.Generator().manual_seed(0)).cuda()
    extras = {k: v.cuda() for k, v in _encdec_extras(cfg, 2, 0).items()}
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-4)
    step = make_train_step(cfg, opt)
    k6 = cfg.n_layers + (cfg.n_encoder_layers if audio else 0)

    def close(got, want):
        got = got.full_tensor() if is_dtensor(got) else got
        atol = 1e-6 * max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got, want, rtol=1e-5, atol=atol)

    with file_process_group("nccl", 0, 1, tmp_path / "store",
                            device="cuda:0"):
        ctx = ShardCtx(mesh=device_mesh((1, 1), ("data", "model"), "cuda"))
        want, state = prefill(params, tokens[:, :64], cfg, **extras)
        plain, pm = step(init_train_state(params, opt),
                         {"tokens": tokens, **extras})
        sharded = shard_params(params, ctx)
        sextras = {k: shard_batch(v, ctx) for k, v in extras.items()}
        before = flash_attention.launches_by_route.get("sm90_tf32x3", 0)
        with use_ctx(ctx):
            got, sstate = prefill(sharded, shard_batch(tokens[:, :64], ctx),
                                  cfg, **sextras)
            new, m = step(init_train_state(sharded, opt),
                          {"tokens": shard_batch(tokens, ctx), **sextras})
        torch.cuda.synchronize()
        assert flash_attention.launches_by_route.get("sm90_tf32x3", 0) == \
            before + 3 * k6
        close(got, want)
        close(m["loss"], pm["loss"])
        close(m["grad_norm"], pm["grad_norm"])
        for a, b in zip(leaves(new.params), leaves(plain.params)):
            close(a, b)
        for i in range(64, 67):
            want, state = decode_step(params, tokens[:, i:i + 1], state, cfg)
            with use_ctx(ctx):
                got, sstate = decode_step(
                    sharded, shard_batch(tokens[:, i:i + 1], ctx), sstate,
                    cfg)
            close(got, want)


@pytest.mark.gpu
def test_cuda_spmd_paper_step_one_rank_mesh_matches_plain(tmp_path):
    """The paper's LP step (N = 2^14, C = 8, |B| = 4N, seeded blocks) with
    every input's rows over a one-rank NCCL mesh equals the plain step
    within ``rtol=1e-4, atol=1e-5`` (``index_add_`` adds with atomics on
    the card), bfloat16 carriers within ``5e-2``, and a 3-step scan too;
    the result keeps the rows' placements."""
    _card()
    from torch.distributed.tensor import Shard

    from repro_torch.core.distributed import (label_propagate_distributed,
                                              lp_step_leaforder, shard_rows)
    from repro_torch.launch.mesh import device_mesh, file_process_group

    L, c = 14, 8
    n, nb, n_nodes = 1 << L, 4 << L, (2 << L) - 1
    g = torch.Generator().manual_seed(4)
    args = [torch.rand(n, c, generator=g), torch.rand(n, c, generator=g),
            torch.randint(0, n_nodes, (nb,), generator=g),
            torch.randint(0, n_nodes, (nb,), generator=g),
            torch.rand(nb, generator=g)]
    args = [t.cuda() for t in args]
    torch.cuda.set_device(0)
    with file_process_group("nccl", 0, 1, tmp_path / "store",
                            device="cuda:0"):
        mesh = device_mesh((1, 1), ("data", "model"), "cuda")
        sargs = [shard_rows(t, mesh) for t in args]
        for dt, tol in ((None, dict(rtol=1e-4, atol=1e-5)),
                        (torch.bfloat16, dict(rtol=5e-2, atol=5e-2))):
            got = lp_step_leaforder(*sargs, 0.3, L, carrier_dtype=dt)
            assert tuple(got.placements) == (Shard(0), Shard(0))
            torch.testing.assert_close(
                got.full_tensor(),
                lp_step_leaforder(*args, 0.3, L, carrier_dtype=dt), **tol)
        got = label_propagate_distributed(*sargs[1:], 0.3, L, 3)
        torch.testing.assert_close(
            got.full_tensor(),
            label_propagate_distributed(*args[1:], 0.3, L, 3),
            rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,shape", [("paper-vdt", None),
                                        ("internvl2-1b", "prefill_32k"),
                                        ("whisper-medium", "train_4k"),
                                        ("whisper-medium", "decode_32k")])
def test_cuda_spmd_encdec_count_on_a_fake_group_equals_meta(arch, shape):
    """The dry run's paper cell at full size, and the sharded cells of the
    vlm and audio families (d_model 128, heads of 64, 64 tokens, batch 2,
    train with remat), counted per device on a fake 2 x 2 group: CUDA
    shards and meta shards give the same FLOPs, bytes and collective
    records (and argument bytes)."""
    _card()
    from repro_torch.configs import shapes
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import device_mesh, fake_process_group

    works = []
    with fake_process_group(4):
        mesh = device_mesh((2, 2), ("data", "model"), "cuda")
        if shape is None:
            for device in ("cuda", "meta"):
                work = dryrun.count_sharded(
                    dryrun.vdt_step_fn(),
                    *dryrun.vdt_sharded_inputs(mesh, device=device))
                works.append((work.flops, work.bytes, work.collectives))
        else:
            cfg = dataclasses.replace(_small(arch),
                                      remat=shape == "train_4k")
            spec = dryrun.SHAPES[shape]
            try:
                dryrun.SHAPES[shape] = shapes.ShapeSpec(shape, 64, 2,
                                                        spec.kind)
                for device in ("cuda", "meta"):
                    fn, args, arg_bytes, *_ = dryrun.build_sharded_cell(
                        arch, shape, False, cfg_override=cfg,
                        batch_override=2, device=device, mesh=mesh)
                    work = dryrun.count_sharded(fn, *args)
                    works.append((work.flops, work.bytes, work.collectives,
                                  arg_bytes))
            finally:
                dryrun.SHAPES[shape] = spec
        torch.cuda.synchronize()
    card, meta = works
    assert card == meta
    assert card[1] > 0 and card[2]


GLOO_CASES = {"smollm-360m": {}, "deepseek-moe-16b": {},
              "deepseek-moe-16b@drop": {"capacity_factor": 1.0},
              "mixtral-8x7b": {}, "mamba2-130m": {},
              "mamba2-130m@3heads": {"d_model": 24}, "zamba2-1.2b": {},
              "internvl2-1b": {}, "whisper-medium": {},
              # sequence parallelism (#seq: seq_shard; #both: and
              # attn_seq_shard, K6's query stripes where the heads do not
              # divide the model axis)
              "smollm-360m#both": {}, "deepseek-moe-16b#seq": {},
              "mamba2-130m#seq": {}, "zamba2-1.2b#both": {},
              "internvl2-1b#both": {},
              "whisper-medium@15frames#seq": {"encoder_frames": 15}}
GLOO_SWITCHES = {"seq": {"seq_shard": True},
                 "both": {"seq_shard": True, "attn_seq_shard": True}}
# the paper's LP step (tests/_spmd_paper_worker.py): depth L, classes C
GLOO_PAPER = dict(L=10, C=4, alpha=0.3, n_iters=4)


@pytest.fixture(scope="module")
def gloo_mesh_run(tmp_path_factory):
    """``tests/_spmd_worker.py`` over a 2 x 2 gloo mesh of four spawned CPU
    ranks, in this host's PyTorch, on each case's SMOKE configuration
    (float32, seeded port parameters; internvl2-1b's patches and
    whisper-medium's frames seeded), and ``tests/_spmd_paper_worker.py`` on
    the paper's LP step at ``GLOO_PAPER`` (seeded blocks, |B| = 4N)."""
    _card()
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models.transformer import init_lm
    from repro_torch.models.whisper import init_encdec

    def flat(tree, pre=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{pre}{k}/")
            else:
                yield pre + k, v

    out = tmp_path_factory.mktemp("gloo")
    for case, over in GLOO_CASES.items():
        arch, _, switches = case.partition("#")
        cfg = dataclasses.replace(get_smoke_config(arch.split("@")[0]),
                                  dtype="float32", **over)
        r = np.random.RandomState(0)
        init = init_encdec if cfg.family == "audio" else init_lm
        extras = {} if cfg.family not in ("vlm", "audio") else {
            k: v.numpy() for k, v in _encdec_extras(cfg, 4, 1).items()}
        np.savez(out / f"{case}_inputs.npz",
                 **{f"p/{k}": v.numpy() for k, v in
                    flat(init(cfg, 0, device="cpu"))},
                 tokens=r.randint(0, cfg.vocab_size, (4, 17)).astype(np.int32),
                 decode=r.randint(0, cfg.vocab_size, (4, 4)).astype(np.int32),
                 overrides=np.array(json.dumps(over)),
                 ctx=np.array(json.dumps(GLOO_SWITCHES.get(switches, {}))),
                 **extras)
    L, c = GLOO_PAPER["L"], GLOO_PAPER["C"]
    r = np.random.RandomState(2)
    nb, n_nodes = 4 << L, (2 << L) - 1
    np.savez(out / "paper-vdt_inputs.npz",
             y=r.rand(1 << L, c).astype(np.float32),
             y0=r.rand(1 << L, c).astype(np.float32),
             a=r.randint(0, n_nodes, nb), b=r.randint(0, n_nodes, nb),
             q=r.rand(nb).astype(np.float32), **GLOO_PAPER)
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=str(root / "src"))
    for worker, cases in (("_spmd_worker.py", GLOO_CASES),
                          ("_spmd_paper_worker.py", ["paper-vdt"])):
        proc = subprocess.run(
            [sys.executable, str(root / "tests" / worker), str(out),
             *cases], capture_output=True, text=True, timeout=300, env=env)
        assert proc.returncode == 0, proc.stderr[-4000:]
    return {case: dict(np.load(out / f"{case}_out.npz"))
            for case in [*GLOO_CASES, "paper-vdt"]}


@pytest.mark.gpu
@pytest.mark.parametrize("case", [*GLOO_CASES, "paper-vdt"])
def test_cuda_host_gloo_mesh_matches_plain_tensors(case, gloo_mesh_run):
    """The card machine's PyTorch (DTensor's rules differ by version) runs
    the sharded train step, prefill and 4 decode steps of each case over a
    2 x 2 gloo mesh equal to plain tensors (with ``seq_shard`` and
    ``attn_seq_shard`` for the ``#`` cases, decode with ``seq_shard`` off),
    as ``test_torch_spmd.py`` and ``test_torch_spmd_seq.py`` hold them on
    the CPU host: ``rtol=1e-5``, ``atol`` 1e-6 of the largest
    magnitude (at least 1; a first moment 1e-5 of its own).  PyTorch 2.11
    differentiated a reduction that DTensor inserts before a ``log``
    wrongly: every gradient was off until the cross-entropy reduced its
    vocabulary sums explicitly.  The paper's LP step and its scan, rows
    over the whole mesh, likewise; its bfloat16 carriers within ``5e-2``."""
    _card()
    res = gloo_mesh_run[case]
    names = sorted(k[6:] for k in res if k.startswith("plain/"))
    if case == "paper-vdt":
        np.testing.assert_allclose(res["spmd/step_bf16"],
                                   res["plain/step_bf16"], rtol=5e-2,
                                   atol=5e-2)
        names = ["scan", "step"]
    assert len(names) > (1 if case == "paper-vdt" else 10)
    for name in names:
        want = res[f"plain/{name}"]
        scale = float(np.abs(want).max())
        atol = 1e-5 * scale if name.startswith("mu/") else \
            1e-6 * max(1.0, scale)
        np.testing.assert_allclose(res[f"spmd/{name}"], want, rtol=1e-5,
                                   atol=atol, err_msg=name)


@pytest.mark.gpu
def test_cuda_host_gloo_launcher_matches_one_rank(tmp_path):
    """The training launcher on four gloo CPU ranks in the card machine's
    PyTorch (DTensor's rules differ by version), against its own one-rank
    run, as ``tests/test_torch_launch_multi.py`` holds them on the CPU
    host: smollm-360m ``SMOKE`` in float32, 4 steps, a checkpoint every 2;
    each step's loss and both checkpoints' leaves at that file's
    tolerance (``rtol=1e-5``, ``atol`` 1e-6 of each tensor's largest
    magnitude, a parameter's at least 1e-3 of the summed learning
    rates)."""
    _card()
    from test_torch_launch_multi import Run, _arrays, _assert_spmd_close, \
        _port

    four = Run(_port(tmp_path / "r4", 4), tmp_path / "r4")
    one = Run(_port(tmp_path / "r1", 1), tmp_path / "r1")
    four.wait(), one.wait()
    assert four.out.count("done: loss") == one.out.count("done: loss") == 1
    np.testing.assert_allclose(four.losses, one.losses, rtol=1e-5, atol=0)
    for steps in (2, 4):
        name = f"step_{steps:08d}"
        _assert_spmd_close(_arrays(four.dir / name), _arrays(one.dir / name),
                           steps)
