"""K6's plain version against the reference's flash-attention kernel and its
oracle, on the CPU.

The port's ``flash_attention`` on CPU tensors runs the plain tile walk
(``kernels/flash_attention/flash_attention.py``); it is held against the
reference's ``repro.kernels.flash_attention.flash_attention`` (the Pallas
kernel, interpreted off the TPU, as ``tests/test_kernels.py`` runs it) and
against ``flash_attention_ref``, on the same numpy inputs and the shapes of
the reference's own tests, at the reference's tolerances: ``2e-4`` in
float32, ``5e-2`` in bfloat16.  The plain version walks the recurrence of
both tensor-core kernels (64-key tiles at every head width, the scale on the
float32 logits, ``exp2``), and in bfloat16 rounds p to bfloat16 before
``p @ v``.  The CUDA kernels themselves run only on a card
(``tests/test_torch_gpu.py``); the float32 kernel's 3xTF32 arithmetic is
emulated in ``tests/test_torch_tf32_split.py``.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as r_flash
from repro.kernels.flash_attention import flash_attention_ref as r_flash_ref
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain,
                                                 flash_attention_ref, KV_TILE)


def _qkv(seed, b, hq, hkv, s, d, dtype=np.float32):
    r = np.random.RandomState(seed)
    return tuple(r.randn(b, h, s, d).astype(dtype) for h in (hq, hkv, hkv))


def _both(arrays, jdtype=jnp.float32, tdtype=torch.float32):
    return ([jnp.asarray(a, jdtype) for a in arrays],
            [torch.as_tensor(a).to(tdtype) for a in arrays])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("b,hq,hkv,s,d", [
    (1, 2, 2, 64, 16), (2, 4, 2, 96, 32), (1, 8, 1, 128, 16), (2, 3, 1, 65, 8),
    (1, 3, 1, 80, 64)])
def test_plain_matches_reference_kernel_causal(b, hq, hkv, s, d):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(s + d, b, hq, hkv, s, d))
    got = flash_attention(tq, tk, tv)
    _close(got, r_flash(jq, jk, jv, block_q=32, block_k=32), 2e-4)
    _close(got, r_flash_ref(jq, jk, jv), 2e-4)
    _close(got, flash_attention_ref(tq, tk, tv), 2e-4)


@pytest.mark.parametrize("window", [16, 48])
def test_plain_matches_reference_kernel_sliding_window(window):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(window, 1, 2, 2, 128, 16))
    got = flash_attention(tq, tk, tv, window=window)
    _close(got, r_flash(jq, jk, jv, window=window, block_q=32, block_k=32),
           2e-4)
    _close(got, r_flash_ref(jq, jk, jv, window=window), 2e-4)


def test_plain_matches_reference_kernel_bf16():
    arrays = _qkv(5, 1, 2, 2, 64, 32)
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, jnp.bfloat16, torch.bfloat16)
    got = flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    _close(got, r_flash(jq, jk, jv, block_q=32, block_k=32), 5e-2)
    _close(got, r_flash_ref(jq, jk, jv), 5e-2)


@pytest.mark.parametrize("s,window", [(65, 0), (40, 0), (65, 7)])
def test_plain_non_causal_ragged_matches_oracle(s, window):
    """``causal=False`` at a ragged S is held against ``ref.py`` only: the
    reference kernel lets its zero-padded keys into the softmax there (ROADMAP
    Queue 3), which the port does not copy."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(s, 2, 3, 1, s, 8))
    got = flash_attention(tq, tk, tv, causal=False, window=window)
    _close(got, r_flash_ref(jq, jk, jv, causal=False, window=window), 2e-4)
    _close(got, flash_attention_ref(tq, tk, tv, causal=False, window=window),
           2e-4)


def test_cpu_tensors_run_the_plain_version_and_do_not_count():
    tq, tk, tv = (torch.as_tensor(a) for a in _qkv(1, 1, 4, 2, 33, 64))
    before = flash_attention.launches
    assert torch.equal(flash_attention(tq, tk, tv, window=5),
                       flash_attention_plain(tq, tk, tv, window=5))
    assert flash_attention.launches == before
    assert KV_TILE == 64


def test_other_devices_raise():
    """K6 runs its kernel on CUDA tensors and its plain version on CPU ones;
    a tensor on any other device that reaches it raises.  ``meta`` tensors
    (shapes only, the dry run's) do not reach it: the operator's fake gives
    the output's shape and type."""
    from repro_torch.kernels._build import on_card

    q = torch.zeros((1, 1, 4, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        on_card("flash_attention", q)
    out = flash_attention(q, q, q)
    assert out.device.type == "meta" and out.shape == q.shape


@pytest.mark.parametrize("b,hq,hkv,s,d,window", [
    (1, 2, 2, 64, 64, 0), (1, 3, 1, 80, 128, 0), (1, 2, 1, 72, 256, 0),
    (2, 3, 1, 96, 64, 16), (1, 6, 2, 130, 128, 40), (1, 3, 1, 100, 256, 24)])
def test_plain_bf16_recurrence_matches_reference_kernel(b, hq, hkv, s, d,
                                                        window):
    """The bfloat16 route's tile walk against the reference's kernel and both
    oracles, at the reference's bfloat16 tolerance: head widths 64, 128 and
    256, GQA ratios 1, 2 and 3, windows narrower than the 64-key tile."""
    arrays = _qkv(s * d + window, b, hq, hkv, s, d)
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, jnp.bfloat16, torch.bfloat16)
    got = flash_attention(tq, tk, tv, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    _close(got, r_flash(jq, jk, jv, window=window, block_q=32, block_k=32),
           5e-2)
    _close(got, r_flash_ref(jq, jk, jv, window=window), 5e-2)
    _close(got, flash_attention_ref(tq, tk, tv, window=window).float(), 5e-2)


@pytest.mark.parametrize("b,hq,hkv,s,d,window", [
    (1, 2, 2, 64, 64, 0), (2, 3, 1, 97, 64, 16), (1, 3, 1, 80, 128, 0),
    (1, 6, 2, 130, 128, 40), (1, 2, 1, 72, 256, 0), (1, 3, 1, 100, 256, 24)])
def test_plain_f32_recurrence_matches_reference_kernel(b, hq, hkv, s, d,
                                                       window):
    """The float32 route's tile walk (64-key tiles, the scale on the float32
    logits, ``exp2``) against the reference's kernel and both oracles at the
    reference's float32 tolerance, 2e-4: head widths 64, 128 and 256, GQA
    ratios 1, 2 and 3, windows narrower than the tile, ragged S."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(s * d + window + 1, b, hq, hkv,
                                            s, d))
    got = flash_attention(tq, tk, tv, window=window)
    assert got.dtype == torch.float32 and got.shape == tq.shape
    _close(got, r_flash(jq, jk, jv, window=window, block_q=32, block_k=32),
           2e-4)
    _close(got, r_flash_ref(jq, jk, jv, window=window), 2e-4)
    _close(got, flash_attention_ref(tq, tk, tv, window=window), 2e-4)


@pytest.mark.parametrize("s,d,window", [(65, 64, 0), (33, 128, 0),
                                        (97, 256, 7), (130, 64, 63)])
def test_plain_f32_non_causal_ragged_matches_oracle(s, d, window):
    """``causal=False`` at a ragged S, in float32, against ``ref.py`` only
    (the reference kernel pads keys into the softmax there)."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(s + d + 1, 1, 3, 1, s, d))
    got = flash_attention(tq, tk, tv, causal=False, window=window)
    _close(got, r_flash_ref(jq, jk, jv, causal=False, window=window), 2e-4)
    _close(got, flash_attention_ref(tq, tk, tv, causal=False,
                                    window=window), 2e-4)


def test_plain_float64_is_the_gate_reference():
    """float64 operands walk the same recurrence in float64 (the card's
    precision gate holds the float32 kernel to it): far closer to the naive
    float64 attention than float32 is."""
    q, k, v = (torch.as_tensor(a).double() for a in _qkv(2, 1, 2, 1, 150,
                                                         64))
    got = flash_attention_plain(q, k, v, window=40)
    assert got.dtype == torch.float64
    logits = (q @ k.transpose(-1, -2)) * 64 ** -0.5
    i, j = torch.arange(150)[:, None], torch.arange(150)[None, :]
    logits = logits.masked_fill(~((j <= i) & (i - j < 40)), float("-inf"))
    want = torch.softmax(logits, -1) @ v
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("s,d,window", [(65, 64, 0), (33, 128, 0),
                                        (97, 256, 7), (130, 64, 63)])
def test_plain_bf16_non_causal_ragged_matches_oracle(s, d, window):
    """``causal=False`` at a ragged S, in bfloat16, against ``ref.py`` only
    (the reference kernel pads keys into the softmax there)."""
    arrays = _qkv(s + d, 1, 3, 1, s, d)
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, jnp.bfloat16, torch.bfloat16)
    got = flash_attention(tq, tk, tv, causal=False, window=window)
    _close(got, r_flash_ref(jq, jk, jv, causal=False, window=window), 5e-2)
    _close(got, flash_attention_ref(tq, tk, tv, causal=False,
                                    window=window).float(), 5e-2)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_plain_bf16_one_tile_is_softmax_with_p_rounded(d):
    """At S <= 64 the bfloat16 route is one tile: t = (q k^T) D^-1/2 log2 e,
    p = 2^(t - max t), out = bf16(p) v / sum p, computed here in float64 from
    the same bfloat16 inputs; the kernel's tile is 64 keys at every width."""
    assert KV_TILE == 64
    tq, tk, tv = (torch.as_tensor(a).to(torch.bfloat16)
                  for a in _qkv(d, 1, 2, 1, 40, d))
    got = flash_attention(tq, tk, tv, causal=False)
    t = (tq.double() @ tk.double().transpose(-1, -2)) * (d ** -0.5) \
        * math.log2(math.e)
    p = torch.exp2(t - t.amax(-1, keepdim=True))
    want = (p.to(torch.bfloat16).double() @ tv.double()) / p.sum(-1)[..., None]
    torch.testing.assert_close(got.double(), want, rtol=8e-3, atol=1e-3)
