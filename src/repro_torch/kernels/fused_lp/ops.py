"""``repro_torch/kernels/fused_lp/ops.py`` ↔ ``repro/kernels/fused_lp/ops.py``.

:func:`folded_step` is the wrapper of K1, the hand-written CUDA kernel
``csrc/folded_lp.cu`` (the port of the reference's ``_folded_call``).  On a
CUDA tensor it launches the kernel, counting the launch in
``folded_step.launches``, or raises; it never falls back.  On a CPU tensor it
runs the plain-torch version ``batched.folded_step_plain``.

The scans are Python loops of :func:`folded_step` with ``Y`` kept on the
device in the folded ``(N, K = B*C)`` layout; run on CPU tensors they are
the same loops over the plain version.  The kernel has no atomics, so a walk
split into resumed segments is bit-identical to the monolithic scan.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.core.matvec import fold_batch, unfold_batch
from repro_torch.kernels.fused_lp.batched import alpha_row, folded_step_plain

__all__ = ["KERNEL_SOURCE", "folded_step", "fused_lp_scan_batched",
           "fused_lp_scan_batched_resume", "fused_lp_scan_folded",
           "fused_lp_scan_folded_resume", "kernel_library"]

KERNEL_SOURCE = Path(__file__).resolve().parent / "csrc" / "folded_lp.cu"


def kernel_library():
    """Build (at first use) and load K1; returns a ``_build.BuiltLibrary``."""
    from repro_torch.kernels._build import load_library

    built = load_library(KERNEL_SOURCE)
    fn = built.lib.folded_lp_step
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        built.lib.folded_lp_error_string.argtypes = [ctypes.c_int]
        built.lib.folded_lp_error_string.restype = ctypes.c_char_p
    return built


def _check(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32 on {device}, "
                         f"got {t.dtype} on {t.device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _folded_step_cuda(rows, cols, y, y0, alpha, inv_two_sigma_sq, row_base):
    dev = rows.device
    (m, d), n, k = rows.shape, cols.shape[0], y.shape[1]
    for name, t, shape in (("rows", rows, (m, d)), ("cols", cols, (n, d)),
                           ("y", y, (n, k)), ("y0", y0, (m, k)),
                           ("alpha", alpha, (k,))):
        _check(name, t, shape, dev)
    if max(m * d, n * d, n * k, m * k) >= 2 ** 31:
        raise ValueError("folded_step: operand too large for int32 indexing")
    out = torch.empty((m, k), dtype=torch.float32, device=dev)
    lib = kernel_library().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.folded_lp_step(rows.data_ptr(), cols.data_ptr(), y.data_ptr(),
                                 y0.data_ptr(), alpha.data_ptr(), out.data_ptr(),
                                 m, n, d, k, int(row_base),
                                 float(inv_two_sigma_sq), stream)
    if err != 0:
        raise RuntimeError("folded_lp kernel launch failed: "
                           + lib.folded_lp_error_string(err).decode())
    folded_step.launches += 1
    return out


def folded_step(rows: torch.Tensor, cols: torch.Tensor, y: torch.Tensor,
                y0: torch.Tensor, alpha: torch.Tensor, inv_two_sigma_sq: float,
                row_base: int = 0) -> torch.Tensor:
    """One eq.-15 step in the folded layout (the ``_folded_call`` contract).

    ``rows`` (M, d) with global row ids ``row_base ..``, ``cols`` (N, d),
    ``y`` (N, K), ``y0`` (M, K), ``alpha`` (K,); returns (M, K).  CUDA
    tensors launch K1 (float32, contiguous, one device); CPU tensors run
    ``folded_step_plain``.
    """
    if rows.is_cuda:
        return _folded_step_cuda(rows, cols, y, y0, alpha, inv_two_sigma_sq,
                                 row_base)
    if rows.device.type != "cpu":
        raise ValueError(f"folded_step: unsupported device {rows.device}")
    return folded_step_plain(rows, cols, y, y0, alpha, inv_two_sigma_sq,
                             row_base)


folded_step.launches = 0  # kernel launches; the CPU path does not count


def fused_lp_scan_folded_resume(x: torch.Tensor, y: torch.Tensor,
                                y0: torch.Tensor, sigma: float, alpha,
                                n_iters: int) -> torch.Tensor:
    """``n_iters`` folded eq.-15 steps entered from a mid-walk carry ``y``.

    ``x`` (N, d), ``y``/``y0`` (N, K), ``alpha`` a scalar or (K,).
    """
    x, y0 = x.contiguous(), y0.contiguous()
    al = alpha_row(alpha, y0.shape[1], x.device)
    inv = float(1.0 / (2.0 * sigma * sigma))
    y = y.contiguous()
    for _ in range(int(n_iters)):
        y = folded_step(x, x, y, y0, al, inv)
    return y


def fused_lp_scan_folded(x: torch.Tensor, y0: torch.Tensor, sigma: float,
                         alpha, n_iters: int) -> torch.Tensor:
    """``n_iters`` folded eq.-15 steps from the seed ``y0`` (N, K)."""
    return fused_lp_scan_folded_resume(x, y0, y0, sigma, alpha, n_iters)


def _folded_alpha(alpha, c: int, device) -> torch.Tensor:
    al = torch.as_tensor(alpha, dtype=torch.float32, device=device)
    # folded column b*C + ch belongs to request b (see fold_batch)
    return al.repeat_interleave(c) if al.ndim == 1 else al


def fused_lp_scan_batched_resume(x: torch.Tensor, ys: torch.Tensor,
                                 y0s: torch.Tensor, sigma: float, alpha,
                                 n_iters: int) -> torch.Tensor:
    """Batched LP segment over a (B, N, C) carry stack; alpha scalar or (B,)."""
    batch, _, c = y0s.shape
    out = fused_lp_scan_folded_resume(
        x, fold_batch(ys), fold_batch(y0s), sigma,
        _folded_alpha(alpha, c, x.device), n_iters)
    return unfold_batch(out, batch, c)


def fused_lp_scan_batched(x: torch.Tensor, y0s: torch.Tensor, sigma: float,
                          alpha, n_iters: int) -> torch.Tensor:
    """Whole batched LP run over a (B, N, C) stack: fold, scan, unfold."""
    return fused_lp_scan_batched_resume(x, y0s, y0s, sigma, alpha, n_iters)
