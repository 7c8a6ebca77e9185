"""``repro_torch/kernels/flash_attention/ops.py`` ↔ ``repro/kernels/flash_attention/ops.py``.

:func:`flash_attention` is the wrapper of K6, the hand-written CUDA kernel
``csrc/flash_attention.cu``.  On CUDA tensors it launches the kernel,
counting the launch in ``flash_attention.launches``, or raises; it never
falls back.  On CPU tensors it runs the plain version
``flash_attention.flash_attention_plain``.  The kernel takes float32 or
bfloat16 (all three operands alike) and head widths 64, 128 and 256, those
of the ported dense configurations.  The reference's ``block_q``/``block_k``
arguments are TPU tile sizes and are not taken: the kernel's tiles are fixed
(``kv_tile``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import (check_operand, launch, load_library,
                                        on_card)
from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention_plain

__all__ = ["HEAD_DIMS", "KERNEL_SOURCE", "flash_attention", "kernel_library"]

KERNEL_SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (64, 128, 256)
_DTYPES = (torch.float32, torch.bfloat16)


def kernel_library():
    """Build (at first use) and load K6; returns a ``_build.BuiltLibrary``."""
    built = load_library(KERNEL_SOURCE)
    fn = built.lib.flash_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return built


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """``q`` (B, Hq, S, D), ``k``/``v`` (B, Hkv, S, D) -> (B, Hq, S, D).

    Query head ``h`` attends with key/value head ``h // (Hq // Hkv)``;
    ``window`` > 0 keeps keys with ``i - j < window``.
    """
    if not on_card("flash_attention", q):
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head width {d} is not one of "
                         f"{HEAD_DIMS}")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"flash_attention: {hq} query heads are not a "
                         f"multiple of {hkv} key/value heads")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention: q, k and v must all be float32 or "
                         f"all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if window < 0:
        raise ValueError(f"flash_attention: window must be >= 0, got {window}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    check_operand("q", q, (b, hq, s, d), q.device, _DTYPES)
    check_operand("k", k, (b, hkv, s, d), q.device, _DTYPES)
    check_operand("v", v, (b, hkv, s, d), q.device, _DTYPES)
    out = torch.empty_like(q)
    launch(kernel_library(), "flash_attention", q.device, q.data_ptr(),
           k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv, s, d,
           int(bool(causal)), int(window), int(q.dtype == torch.bfloat16),
           float(d) ** -0.5)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0  # K6 launches; the CPU path does not count
