"""``repro_torch/kernels/grf/ops.py`` ↔ ``repro/kernels/grf/ops.py``.

:func:`grf_feature_matvec` is the wrapper of K5, the hand-written CUDA kernel
``csrc/grf_feature.cu``.  With ``impl=None`` it launches the kernel on CUDA
tensors, counting the launch in ``grf_feature_matvec.launches``, or raises
(it never falls back), and runs the plain version ``grf.grf_feature_plain``
on CPU tensors.  ``impl="ref"`` selects the gather-and-mean oracle
``ref.grf_feature_matvec_ref`` on any device, as in the reference.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels._build import (check_operand, launch, load_library,
                                        on_card)
from repro_torch.kernels.grf.grf import grf_feature_plain
from repro_torch.kernels.grf.ref import grf_feature_matvec_ref

__all__ = ["KERNEL_SOURCE", "grf_feature_matvec", "kernel_library"]

KERNEL_SOURCE = Path(__file__).resolve().parent / "csrc" / "grf_feature.cu"


def kernel_library():
    """Build (at first use) and load K5; returns a ``_build.BuiltLibrary``."""
    built = load_library(KERNEL_SOURCE)
    fn = built.lib.grf_feature
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return built


def grf_feature_matvec(pos: torch.Tensor, load: torch.Tensor, y: torch.Tensor,
                       *, impl: Optional[str] = None) -> torch.Tensor:
    """Walker-mean feature product ``(S, m) x (N, K) -> (S, K)``.

    ``pos`` holds node ids (int32 on the card; other integer types are
    converted), ``load`` and ``y`` float32.  A position outside ``[0, N)``
    contributes 0, as in the reference's one-hot kernel.
    """
    if impl == "ref":
        return grf_feature_matvec_ref(pos, load, y)
    if impl is not None:
        raise ValueError(f"impl must be None or 'ref', got {impl!r}")
    if not on_card("grf_feature_matvec", y):
        return grf_feature_plain(pos, load, y)
    (s, m), (n, k) = pos.shape, y.shape
    if m < 1:
        raise ValueError("grf_feature_matvec needs at least one walker per row")
    pos = pos.to(torch.int32).contiguous()
    load, y = load.to(torch.float32).contiguous(), y.contiguous()
    out = torch.empty((s, k), dtype=torch.float32, device=y.device)
    check_operand("pos", pos, (s, m), y.device, (torch.int32,))
    check_operand("load", load, (s, m), y.device)
    check_operand("y", y, (n, k), y.device)
    launch(kernel_library(), "grf_feature", y.device, pos.data_ptr(),
           load.data_ptr(), y.data_ptr(), out.data_ptr(), s, m, n, k,
           float(1.0 / m))
    grf_feature_matvec.launches += 1
    return out


grf_feature_matvec.launches = 0  # K5 launches; the CPU path does not count
