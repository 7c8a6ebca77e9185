"""``repro_torch/kernels/fused_lp/ops.py`` ↔ ``repro/kernels/fused_lp/ops.py``.

Wrappers of the three hand-written CUDA kernels in ``csrc/folded_lp.cu``:

* :func:`folded_step`, K1 (the reference's ``_folded_call``): one eq.-15 step
  in the folded ``(N, K = B*C)`` layout, per-column alpha;
* :func:`matvec_step`, K2 (``fused_lp_matvec_kernel``): ``P @ Y``;
* :func:`perbatch_step`, K3 (``fused_lp_step_batched_kernel``): the
  per-batch-recompute eq.-15 step over a ``(B, N, C)`` stack, one alpha.

On a CUDA tensor each launches its kernel, counting the launch in its own
``.launches``, or raises; none falls back.  On a CPU tensor each runs its
plain-torch version (``batched.folded_step_plain``,
``fused_lp.matvec_plain``, ``batched.step_batched_perbatch_plain``).

The reference's public ops sit on top, with its signatures:
``fused_lp_matvec`` (K2), ``fused_lp_step_folded`` (K1),
``fused_lp_step_batched``/``fused_lp_matvec_batched`` (K1 folded with
``reuse=True``, K3 with ``reuse=False`` and a static float alpha), and the
scans.  The scans are Python loops of :func:`folded_step` with ``Y`` kept on
the device in the folded layout; run on CPU tensors they are the same loops
over the plain version.  The kernels have no atomics, so a walk split into
resumed segments is bit-identical to the monolithic scan.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.core.matvec import fold_batch, unfold_batch
from repro_torch.kernels._build import (check_operand, launch, load_library,
                                        on_card)
from repro_torch.kernels.fused_lp.batched import (alpha_row, folded_step_plain,
                                                  step_batched_perbatch_plain)
from repro_torch.kernels.fused_lp.fused_lp import (matvec_plain,
                                                   ref_padded_columns)

__all__ = ["KERNEL_SOURCE", "folded_step", "fused_lp_matvec",
           "fused_lp_matvec_batched", "fused_lp_scan_batched",
           "fused_lp_scan_batched_resume", "fused_lp_scan_folded",
           "fused_lp_scan_folded_resume", "fused_lp_step_batched",
           "fused_lp_step_folded", "kernel_library", "matvec_step",
           "perbatch_step"]

KERNEL_SOURCE = Path(__file__).resolve().parent / "csrc" / "folded_lp.cu"


def kernel_library():
    """Build (at first use) and load K1-K3; returns a ``_build.BuiltLibrary``."""
    built = load_library(KERNEL_SOURCE)
    lib = built.lib
    if lib.folded_lp_step.argtypes is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.folded_lp_step.argtypes = [ptr] * 6 + [i32] * 5 + [f32, i32, ptr]
        lib.fused_lp_matvec.argtypes = [ptr] * 3 + [i32] * 3 + [f32, i32, ptr]
        lib.fused_lp_step_perbatch.argtypes = [ptr] * 4 + [i32] * 4 + [
            f32, f32, i32, ptr]
        for fn in (lib.folded_lp_step, lib.fused_lp_matvec,
                   lib.fused_lp_step_perbatch):
            fn.restype = ctypes.c_int
    return built


def _launch(operands, out: torch.Tensor, fn_name: str, *args) -> None:
    for name, t, shape in operands:
        check_operand(name, t, shape, out.device)
    launch(kernel_library(), fn_name, out.device, *args)


def folded_step(rows: torch.Tensor, cols: torch.Tensor, y: torch.Tensor,
                y0: torch.Tensor, alpha: torch.Tensor, inv_two_sigma_sq: float,
                row_base: int = 0) -> torch.Tensor:
    """One eq.-15 step in the folded layout (the ``_folded_call`` contract).

    ``rows`` (M, d) with global row ids ``row_base ..``, ``cols`` (N, d),
    ``y`` (N, K), ``y0`` (M, K), ``alpha`` (K,); returns (M, K).  CUDA
    tensors launch K1 (float32, contiguous, one device); CPU tensors run
    ``folded_step_plain``.
    """
    if not on_card("folded_step", rows):
        return folded_step_plain(rows, cols, y, y0, alpha, inv_two_sigma_sq,
                                 row_base)
    (m, d), n, k = rows.shape, cols.shape[0], y.shape[1]
    out = torch.empty((m, k), dtype=torch.float32, device=rows.device)
    _launch((("rows", rows, (m, d)), ("cols", cols, (n, d)), ("y", y, (n, k)),
             ("y0", y0, (m, k)), ("alpha", alpha, (k,))), out, "folded_lp_step",
            rows.data_ptr(), cols.data_ptr(), y.data_ptr(), y0.data_ptr(),
            alpha.data_ptr(), out.data_ptr(), m, n, d, k, int(row_base),
            float(inv_two_sigma_sq), ref_padded_columns(n))
    folded_step.launches += 1
    return out


folded_step.launches = 0  # kernel launches; the CPU path does not count


def matvec_step(x: torch.Tensor, y: torch.Tensor,
                inv_two_sigma_sq: float) -> torch.Tensor:
    """``P @ y`` for points ``x`` (N, d) and labels ``y`` (N, C); returns (N, C).

    CUDA tensors launch K2; CPU tensors run ``fused_lp.matvec_plain``.
    """
    if not on_card("matvec_step", x):
        return matvec_plain(x, y, inv_two_sigma_sq)
    (n, d), c = x.shape, y.shape[1]
    out = torch.empty((n, c), dtype=torch.float32, device=x.device)
    _launch((("x", x, (n, d)), ("y", y, (n, c))), out,
            "fused_lp_matvec", x.data_ptr(), y.data_ptr(), out.data_ptr(), n,
            d, c, float(inv_two_sigma_sq), ref_padded_columns(n))
    matvec_step.launches += 1
    return out


matvec_step.launches = 0  # K2 launches


def perbatch_step(x: torch.Tensor, y: torch.Tensor, y0: torch.Tensor,
                  alpha: float, inv_two_sigma_sq: float) -> torch.Tensor:
    """One eq.-15 step for each element of a (B, N, C) stack, recomputed per element.

    ``alpha`` is one float.  CUDA tensors launch K3; CPU tensors run
    ``batched.step_batched_perbatch_plain``.
    """
    if not on_card("perbatch_step", x):
        return step_batched_perbatch_plain(x, y, y0, float(alpha),
                                           inv_two_sigma_sq)
    (n, d), (batch, _, c) = x.shape, y.shape
    out = torch.empty((batch, n, c), dtype=torch.float32, device=x.device)
    _launch((("x", x, (n, d)), ("y", y, (batch, n, c)),
             ("y0", y0, (batch, n, c))), out,
            "fused_lp_step_perbatch", x.data_ptr(), y.data_ptr(),
            y0.data_ptr(), out.data_ptr(), batch, n, d, c, float(alpha),
            float(inv_two_sigma_sq), ref_padded_columns(n))
    perbatch_step.launches += 1
    return out


perbatch_step.launches = 0  # K3 launches


def _inv(sigma: float) -> float:
    return float(1.0 / (2.0 * float(sigma) * float(sigma)))


def fused_lp_matvec(x: torch.Tensor, y: torch.Tensor,
                    sigma: float) -> torch.Tensor:
    """``P @ Y`` without materializing P (K2); ``x`` (N, d), ``y`` (N, C)."""
    return matvec_step(x.contiguous(), y.contiguous(), _inv(sigma))


def fused_lp_step_folded(x: torch.Tensor, y: torch.Tensor, y0: torch.Tensor,
                         sigma: float, alpha=1.0) -> torch.Tensor:
    """One eq.-15 step in the folded (N, K) layout (K1); alpha scalar or (K,)."""
    x = x.contiguous()
    return folded_step(x, x, y.contiguous(), y0.contiguous(),
                       alpha_row(alpha, y.shape[1], x.device), _inv(sigma))


def fused_lp_step_batched(x: torch.Tensor, y: torch.Tensor, y0: torch.Tensor,
                          sigma: float, alpha=0.01,
                          reuse: bool = True) -> torch.Tensor:
    """One fused eq.-15 update for a (B, N, C) stack of label matrices.

    ``reuse=True`` folds the batch and runs K1, which computes each distance
    tile once for the whole batch; alpha is a scalar or per-request (B,).
    ``reuse=False`` runs K3, which recomputes it per batch element, with one
    float alpha.
    """
    if not reuse:
        return perbatch_step(x.contiguous(), y.contiguous(), y0.contiguous(),
                             float(alpha), _inv(sigma))
    batch, _, c = y.shape
    out = fused_lp_step_folded(x, fold_batch(y), fold_batch(y0), sigma,
                               _folded_alpha(alpha, c, x.device))
    return unfold_batch(out, batch, c)


def fused_lp_matvec_batched(x: torch.Tensor, ys: torch.Tensor, sigma: float,
                            reuse: bool = True) -> torch.Tensor:
    """``P @ Y[b]`` for a (B, N, C) stack: the LP step at alpha = 1."""
    return fused_lp_step_batched(x, ys, ys, sigma, 1.0, reuse=reuse)


def fused_lp_scan_folded_resume(x: torch.Tensor, y: torch.Tensor,
                                y0: torch.Tensor, sigma: float, alpha,
                                n_iters: int) -> torch.Tensor:
    """``n_iters`` folded eq.-15 steps entered from a mid-walk carry ``y``.

    ``x`` (N, d), ``y``/``y0`` (N, K), ``alpha`` a scalar or (K,).

    At N = 1 the reference's scan also carries its ``R - 1 = 255`` padded
    rows (``R = ref_padded_columns(1)``): each sees the one point as its only
    unmasked column, so after a step it holds ``alpha * y`` (its seed is 0),
    and the point's all-masked row averages all ``R`` rows.  The port carries
    that one padded value, starting from 0 as the reference re-pads every
    segment's carry with zeros.
    """
    x, y0 = x.contiguous(), y0.contiguous()
    al = alpha_row(alpha, y0.shape[1], x.device)
    inv = float(1.0 / (2.0 * sigma * sigma))
    y = y.contiguous()
    pad = torch.zeros_like(y) if x.shape[0] == 1 else None
    r = ref_padded_columns(1)
    for _ in range(int(n_iters)):
        y_next = folded_step(x, x, y, y0, al, inv)
        if pad is not None:  # N = 1: add the padded rows' share of the mean
            y_next, pad = y_next + al * pad * ((r - 1) / r), al * y
        y = y_next
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
