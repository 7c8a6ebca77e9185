"""``repro_torch/kernels/pairwise/ops.py`` ↔ ``repro/kernels/pairwise/ops.py``.

:func:`pairwise_sq_dists` is the wrapper of K4, the hand-written CUDA kernel
``csrc/pairwise.cu``.  On CUDA tensors it launches the kernel, counting the
launch in ``pairwise_sq_dists.launches``, or raises; it never falls back.  On
CPU tensors it runs the plain version ``pairwise.pairwise_sq_dists_plain``.
Float32 and bfloat16 inputs go to the kernel as they are and are upcast on
load; an input of another type, or two inputs of different types, are upcast
to float32 first, which is exact for bfloat16 as the reference's in-kernel
``astype`` is.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import (check_operand, launch, load_library,
                                        on_card)
from repro_torch.kernels.pairwise.pairwise import pairwise_sq_dists_plain

__all__ = ["KERNEL_SOURCE", "kernel_library", "pairwise_sq_dists"]

KERNEL_SOURCE = Path(__file__).resolve().parent / "csrc" / "pairwise.cu"
_ENTRY = {torch.float32: "pairwise_sq_dists_f32",
          torch.bfloat16: "pairwise_sq_dists_bf16"}


def kernel_library():
    """Build (at first use) and load K4; returns a ``_build.BuiltLibrary``."""
    built = load_library(KERNEL_SOURCE)
    for name in _ENTRY.values():
        fn = getattr(built.lib, name)
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return built


def pairwise_sq_dists(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(M, d), (N, d) -> (M, N) float32 ``max(|x|^2 + |y|^2 - 2 x.y^T, 0)``."""
    if not on_card("pairwise_sq_dists", x):
        return pairwise_sq_dists_plain(x, y)
    if x.dtype != y.dtype or x.dtype not in _ENTRY:
        x, y = x.to(torch.float32), y.to(torch.float32)
    x, y = x.contiguous(), y.contiguous()
    (m, d), n = x.shape, y.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    for name, t, shape in (("x", x, (m, d)), ("y", y, (n, d))):
        check_operand(name, t, shape, x.device, tuple(_ENTRY))
    launch(kernel_library(), _ENTRY[x.dtype], x.device, x.data_ptr(),
           y.data_ptr(), out.data_ptr(), m, n, d)
    pairwise_sq_dists.launches += 1
    return out


pairwise_sq_dists.launches = 0  # K4 launches; the CPU path does not count
