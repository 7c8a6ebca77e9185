"""The numerics of K1-K4's tensor-core route, on the CPU.

K1-K4 compute the cross term of their squared distances as three TF32
products of a split operand, ``hi.hi + hi.lo + lo.hi``
(``src/repro_torch/kernels/csrc/tf32x3.cuh``).  These tests hold the split's
plain twin (``repro_torch.kernels.tf32x3``) to its contract and emulate the
kernels' arithmetic in numpy: products of TF32 values are exact, each 32-wide
chunk of d is summed in k-steps of 8 into a fresh float32 accumulator that
truncates (round toward zero, the worst case for the tensor cores' float32
sums), and the chunk is added to a float32 master with round-to-nearest.
Against float64, that stays within 1.5 x a float32 product's error, while
one TF32 product is at least 50 x worse: the card's precision gate (2 x)
tells the two apart.  The build digest test checks that an edited shared
header rebuilds the kernels.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pairwise import pairwise_sq_dists_plain
from repro_torch.kernels.tf32x3 import (padded_width, tf32_round,
                                        tf32_split_plain)

LOW13 = 0x1FFF


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 7.5e3, 1e30])
def test_plain_split_rounds_hi_and_lo_and_sums_back(scale):
    r = np.random.RandomState(1)
    x = torch.as_tensor((r.randn(37, 45) * scale).astype(np.float32))
    hi, lo, nrm = tf32_split_plain(x)
    assert hi.shape == lo.shape == (37, padded_width(45)) == (37, 64)
    assert int((_bits(hi) & LOW13).abs().max()) == 0
    assert int((_bits(lo) & LOW13).abs().max()) == 0
    assert torch.equal(hi[:, 45:], torch.zeros(37, 19))
    assert torch.equal(lo[:, 45:], torch.zeros(37, 19))
    err = (hi[:, :45].double() + lo[:, :45].double() - x.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())
    torch.testing.assert_close(nrm, (x * x).sum(-1), rtol=0, atol=0)


def test_tf32_round_is_nearest_ties_away():
    one = 1.0
    step = 2.0 ** -10                    # TF32's step at 1
    x = torch.tensor([one + step / 2, -(one + step / 2), one + step / 2
                      - 2.0 ** -23, one + 1.5 * step, 3.0, 0.0],
                     dtype=torch.float32)
    want = torch.tensor([one + step, -(one + step), one, one + 2 * step, 3.0,
                         0.0], dtype=torch.float32)
    assert torch.equal(tf32_round(x), want)
    assert padded_width(0) == padded_width(1) == padded_width(32) == 32
    assert padded_width(315) == 320


def _rz32(v):
    """float64 -> the float32 nearest to it toward zero, as float64."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f.astype(np.float64)


def _emulated_cross(x, y, terms):
    """x.y^T as the kernels compute it, from ``terms`` TF32 products."""
    xh, xl, _ = (t.double().numpy() for t in tf32_split_plain(x))
    yh, yl, _ = (t.double().numpy() for t in tf32_split_plain(y))
    prods = [(xh, yh), (xh, yl), (xl, yh)][:terms]
    master = np.zeros((x.shape[0], y.shape[0]), np.float32)
    for c0 in range(0, xh.shape[1], 32):
        acc = np.zeros(master.shape)
        for k0 in range(c0, c0 + 32, 8):
            for a, b in prods:
                acc = _rz32(acc + a[:, k0:k0 + 8] @ b[:, k0:k0 + 8].T)
        master = master + acc.astype(np.float32)
    return torch.as_tensor(master)


@pytest.fixture(scope="module")
def gaussian_errors():
    """Max and RMS errors against float64 at 512 x 4,096 x 315, Gaussian:
    the plain float32 version's, 3xTF32's and one TF32 product's."""
    r = np.random.RandomState(15)
    x = torch.as_tensor(r.randn(512, 315).astype(np.float32))
    y = torch.as_tensor(r.randn(4_096, 315).astype(np.float32))
    xd, yd = x.double(), y.double()
    ref = ((xd * xd).sum(1)[:, None] + (yd * yd).sum(1)[None, :]
           - 2.0 * (xd @ yd.T)).clamp_min(0.0)
    xx, yy = (x * x).sum(-1), (y * y).sum(-1)

    def errors(d2):
        err = (d2.double() - ref).abs()
        return float(err.max()), float(err.square().mean().sqrt())

    def emulated(terms):
        cross = _emulated_cross(x, y, terms)
        return errors(torch.clamp_min(xx[:, None] + yy[None, :] - 2.0 * cross,
                                      0.0))

    return dict(f32=errors(pairwise_sq_dists_plain(x, y)), x3=emulated(3),
                x1=emulated(1))


@pytest.mark.parametrize("which", ["max", "rms"])
def test_three_tf32_products_keep_float32_accuracy(gaussian_errors, which):
    i = ["max", "rms"].index(which)
    f32, x3 = gaussian_errors["f32"][i], gaussian_errors["x3"][i]
    assert x3 <= 1.5 * f32, (x3, f32)


@pytest.mark.parametrize("which", ["max", "rms"])
def test_one_tf32_product_fails_the_gate(gaussian_errors, which):
    i = ["max", "rms"].index(which)
    f32, x1 = gaussian_errors["f32"][i], gaussian_errors["x1"][i]
    assert x1 >= 50.0 * f32, (x1, f32)


def test_build_digest_follows_the_shared_headers(tmp_path):
    """An edited header of the include directory builds the kernels anew."""
    source = tmp_path / "k.cu"
    source.write_text('#include "h.cuh"\n')
    header = tmp_path / "h.cuh"
    header.write_text("#define A 1\n")
    first = _build.digest(source, tmp_path)
    assert _build.digest(source, tmp_path) == first
    header.write_text("#define A 2\n")
    second = _build.digest(source, tmp_path)
    assert second != first
    (tmp_path / "more.cuh").write_text("\n")
    assert _build.digest(source, tmp_path) not in (first, second)
    assert _build.INCLUDE_DIR.name == "csrc"
    assert (_build.INCLUDE_DIR / "tf32x3.cuh").is_file()
    assert (_build.INCLUDE_DIR / "sm90.cuh").is_file()
