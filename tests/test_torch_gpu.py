"""Tests of the port that need a CUDA card; they skip without one.

Run them on the card with ``python -m pytest -m gpu tests/test_torch_gpu.py``.
This file imports neither JAX nor the reference package, so it runs where
only the port's dependencies are installed.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.fused_lp import (folded_step, folded_step_plain,
                                          fused_lp_scan_folded,
                                          fused_lp_scan_folded_resume)

RTOL, ATOL = 1e-4, 1e-5


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
