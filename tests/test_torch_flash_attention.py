"""K6's plain version against the reference's flash-attention kernel and its
oracle, on the CPU.

The port's ``flash_attention`` on CPU tensors runs the plain tile walk
(``kernels/flash_attention/flash_attention.py``); it is held against the
reference's ``repro.kernels.flash_attention.flash_attention`` (the Pallas
kernel, interpreted off the TPU, as ``tests/test_kernels.py`` runs it) and
against ``flash_attention_ref``, on the same numpy inputs and the shapes of
the reference's own tests, at the reference's tolerances: ``2e-4`` in
float32, ``5e-2`` in bfloat16.  The CUDA kernel itself runs only on a card
(``tests/test_torch_gpu.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as r_flash
from repro.kernels.flash_attention import flash_attention_ref as r_flash_ref
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain,
                                                 flash_attention_ref, kv_tile)


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
    assert [kv_tile(d) for d in (64, 128, 256)] == [64, 64, 32]


def test_other_devices_raise():
    q = torch.zeros((1, 1, 4, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q, q, q)
