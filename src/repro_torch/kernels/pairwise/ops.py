"""``repro_torch/kernels/pairwise/ops.py`` ↔ ``repro/kernels/pairwise/ops.py``.

:func:`pairwise_sq_dists` is the wrapper of K4, the hand-written CUDA kernel
``csrc/pairwise.cu``, whose cross term runs on Hopper's tensor cores
(``kernels/tf32x3.py``).  On CUDA tensors it launches the kernel, counting the
launch in ``pairwise_sq_dists.launches`` and in
``pairwise_sq_dists.launches_by_route`` under the route the entry point
reports, or raises; it never falls back.  The routes: float32 operands take
``"tf32x3"`` (three TF32 products, float32 accuracy), bfloat16 ones
``"tf32x1_bf16"`` (one product: a bfloat16 value is exact in TF32).  On CPU
tensors it runs the plain version ``pairwise.pairwise_sq_dists_plain``.  An
input of another type, or two inputs of different types, are upcast to float32
first, which is exact for bfloat16 as the reference's in-kernel ``astype`` is.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import (check_operand, launch, load_library,
                                        on_card)
from repro_torch.kernels.pairwise.pairwise import pairwise_sq_dists_plain
from repro_torch.kernels.tf32x3 import count_route, split_scratch

__all__ = ["KERNEL_SOURCE", "kernel_library", "pairwise_sq_dists"]

KERNEL_SOURCE = Path(__file__).resolve().parent / "csrc" / "pairwise.cu"
_ENTRY = {torch.float32: "pairwise_sq_dists_f32",
          torch.bfloat16: "pairwise_sq_dists_bf16"}
_SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16"}  # of the route name


def kernel_library():
    """Build (at first use) and load K4; returns a ``_build.BuiltLibrary``."""
    built = load_library(KERNEL_SOURCE)
    for name in _ENTRY.values():
        fn = getattr(built.lib, name)
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
                ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
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
    with_lo = x.dtype == torch.float32
    xhi, xlo, xn, d_pad = split_scratch(x, with_lo)
    yhi, ylo, yn, _ = split_scratch(y, with_lo)
    products = ctypes.c_int(0)
    launch(kernel_library(), _ENTRY[x.dtype], x.device, x.data_ptr(),
           y.data_ptr(), xhi.data_ptr(), _ptr(xlo), xn.data_ptr(),
           yhi.data_ptr(), _ptr(ylo), yn.data_ptr(), out.data_ptr(), m, n, d,
           d_pad, ctypes.byref(products))
    pairwise_sq_dists.launches += 1
    count_route(pairwise_sq_dists, products, _SUFFIX[x.dtype])
    return out


def _ptr(t):
    return None if t is None else t.data_ptr()


# K4 launches, in all and by route; the CPU path does not count
pairwise_sq_dists.launches = 0
pairwise_sq_dists.launches_by_route = {"tf32x3": 0, "tf32x1_bf16": 0}
