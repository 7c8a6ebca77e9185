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
tells the two apart.  K6's float32 route (``flash_attention_tf32x3.cu``)
uses the same split for both of its products; its emulation here sums each
32-wide chunk of D of ``q k^T`` and each key tile of ``p v`` into a fresh
truncating accumulator, the two small products first, and holds the result
to the same limits against the plain recurrence in float64.  The build
digest test checks that an edited shared header rebuilds the kernels.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.flash_attention.flash_attention import (KV_TILE,
                                                                 LOG2E)
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


def _split64(x):
    """float32 ``x`` (rows, n) -> its TF32 hi and lo as float64 arrays."""
    hi, lo, _ = tf32_split_plain(torch.as_tensor(x))
    n = x.shape[1]
    return hi[:, :n].double().numpy(), lo[:, :n].double().numpy()


def _emulated_cross(x, y, terms, chunk=32, small_first=False):
    """x.y^T, float32 (M, n) by (N, n), as the tensor-core kernels sum it from
    ``terms`` TF32 products: per ``chunk`` of n a fresh accumulator that
    truncates after every k-step of 8, the chunks added to a float32 master
    with round-to-nearest, in order.  K1-K4 take each k-step's hi.hi, hi.lo
    and lo.hi in turn; K6's float32 kernel (``small_first``) takes the
    chunk's hi.lo and lo.hi first, interleaved by k-step, then its hi.hi."""
    xh, xl = _split64(x)
    yh, yl = _split64(y)
    big, small = (xh, yh), [(xh, yl), (xl, yh)][:terms - 1]
    master = np.zeros((x.shape[0], y.shape[0]), np.float32)
    for c0 in range(0, x.shape[1], chunk):
        steps = range(c0, c0 + chunk, 8)
        if small_first:
            order = [(k, a, b) for k in steps for a, b in small]
            order += [(k, *big) for k in steps]
        else:
            order = [(k, a, b) for k in steps for a, b in [big, *small]]
        acc = np.zeros(master.shape)
        for k, a, b in order:
            acc = _rz32(acc + a[:, k:k + 8] @ b[:, k:k + 8].T)
        master = master + acc.astype(np.float32)
    return master


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
        cross = torch.as_tensor(_emulated_cross(x, y, terms))
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


def _emulated_attention(q, k, v, terms, window):
    """One causal head (S, D) through K6's float32 kernel's arithmetic."""
    s, d = q.shape
    c = np.float32(d ** -0.5 * LOG2E)
    m = np.full(s, -1e30, np.float32)
    tot = np.zeros(s, np.float32)
    acc = np.zeros((s, d), np.float32)
    i = np.arange(s)[:, None]
    for k0 in range(0, s, KV_TILE):
        j = np.arange(k0, k0 + KV_TILE)[None, :]
        logits = _emulated_cross(q, k[k0:k0 + KV_TILE], terms,
                                 small_first=True)
        keep = (j <= i) & ((i - j < window) if window else True)
        logits = np.where(keep, logits, -np.inf).astype(np.float32)
        m_new = np.maximum(m, logits.max(1) * c)
        alpha = np.exp2(m - m_new).astype(np.float32)
        # one fused multiply-add, then 2^x rounded to float32
        p = np.exp2((logits.astype(np.float64) * c - m_new[:, None])
                    .astype(np.float32)).astype(np.float32)
        tot = tot * alpha + p.sum(1, dtype=np.float32)
        part = _emulated_cross(p, np.ascontiguousarray(v[k0:k0 + KV_TILE].T),
                               terms, KV_TILE, small_first=True)
        acc = (acc.astype(np.float64) * alpha[:, None] + part).astype(
            np.float32)
        m = m_new
    return acc / np.maximum(tot, 1e-38)[:, None]


@pytest.fixture(scope="module")
def attention_errors():
    """Max and RMS errors against the plain recurrence in float64, Gaussian
    q, k, v, causal: smollm-360m's head width (S = 256, D = 64) and
    gemma3-1b's local layer's (S = 192, D = 256, window 96); the plain
    float32 version's, 3xTF32's and one TF32 product's."""
    r = np.random.RandomState(16)
    out = {"f32": [], "x3": [], "x1": []}
    for s, d, window in ((256, 64, 0), (192, 256, 96)):
        for _ in range(2):
            q, k, v = (r.randn(s, d).astype(np.float32) for _ in range(3))
            tq, tk, tv = (torch.as_tensor(a)[None, None] for a in (q, k, v))
            ref = flash_attention_plain(tq.double(), tk.double(), tv.double(),
                                        True, window)[0, 0].numpy()
            out["f32"].append(flash_attention_plain(tq, tk, tv, True, window)
                              [0, 0].numpy() - ref)
            for name, terms in (("x3", 3), ("x1", 1)):
                out[name].append(_emulated_attention(q, k, v, terms, window)
                                 - ref)
    flat = {name: np.concatenate([x.ravel() for x in e])
            for name, e in out.items()}
    return {name: (float(np.abs(e).max()), float(np.sqrt(np.square(e).mean())))
            for name, e in flat.items()}


@pytest.mark.parametrize("which", ["max", "rms"])
def test_attention_three_tf32_products_keep_float32_accuracy(
        attention_errors, which):
    i = ["max", "rms"].index(which)
    f32, x3 = attention_errors["f32"][i], attention_errors["x3"][i]
    assert x3 <= 1.5 * f32, (x3, f32)


@pytest.mark.parametrize("which", ["max", "rms"])
def test_attention_one_tf32_product_fails_the_gate(attention_errors, which):
    i = ["max", "rms"].index(which)
    f32, x1 = attention_errors["f32"][i], attention_errors["x1"][i]
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
