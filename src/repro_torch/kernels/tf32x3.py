"""The 3xTF32 operand split shared by K1-K4 (no counterpart in ``repro``).

K4 (``pairwise/csrc/pairwise.cu``) and K1-K3 (``fused_lp/csrc/folded_lp.cu``)
compute the cross term ``x.y^T`` of their squared distances on Hopper's
tensor cores as three TF32 products, ``hi.hi + hi.lo + lo.hi``, which keeps
float32 accuracy (``csrc/tf32x3.cuh`` says why).  Their entry points first run
the split pass of that header over each float32 operand (rows, d): ``hi =
tf32(x)`` and ``lo = tf32(x - hi)``, each (rows, d_pad) with the pad columns
zero, and ``|x|^2`` (rows,); K1-K3's kl and itakura_saito tiles split
``log x`` or ``1/x`` for their column operand and write each operand's bias
in place of ``|x|^2`` (the header's ``SplitOp``).  The wrappers allocate that scratch with
:func:`split_scratch`.  Each entry point reports through an ``int*`` the
number of TF32 products a k step of the kernel it launched takes, and the
wrapper counts the launch under that route with :func:`count_route`.

:func:`tf32_split_plain` is the split's plain-torch twin, for the CPU tests:
TF32 rounding is round-to-nearest, ties away from zero, at bit 13 of the
float32 significand (``cvt.rna.tf32.f32``), written as integer arithmetic on
the bits.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["CHUNK", "count_route", "padded_width", "split_scratch",
           "tf32_round", "tf32_split_plain"]

CHUNK = 32   # floats of d in one ring stage; d_pad is a multiple of it


def padded_width(d: int) -> int:
    """``d`` rounded up to a multiple of :data:`CHUNK` (one chunk for d = 0)."""
    return -(-max(int(d), 1) // CHUNK) * CHUNK


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Float32 ``x`` rounded to TF32 (nearest, ties away), low 13 bits zero."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split_plain(x: torch.Tensor, d_pad: int | None = None):
    """``x`` (rows, d) -> ``hi``, ``lo`` (rows, d_pad) and ``|x|^2`` (rows,).

    ``hi + lo`` equals ``x`` within 2^-22 relative; pad columns are zero.
    """
    x = x.to(torch.float32)
    d = x.shape[1]
    d_pad = padded_width(d) if d_pad is None else int(d_pad)
    xp = torch.nn.functional.pad(x, (0, d_pad - d))
    hi = tf32_round(xp)
    return hi, tf32_round(xp - hi), (x * x).sum(-1)


def split_scratch(x: torch.Tensor, with_lo: bool = True):
    """Empty outputs of the split pass for ``x`` (rows, d) on its device:
    ``(hi, lo, nrm, d_pad)``; ``lo`` is None when ``with_lo`` is False."""
    rows, d = x.shape
    d_pad = padded_width(d)
    hi = torch.empty((rows, d_pad), dtype=torch.float32, device=x.device)
    lo = torch.empty_like(hi) if with_lo else None
    nrm = torch.empty((rows,), dtype=torch.float32, device=x.device)
    return hi, lo, nrm, d_pad


def count_route(fn, products: ctypes.c_int, suffix: str = "") -> None:
    """Count a launch of wrapper ``fn`` in ``fn.launches_by_route`` under the
    route its entry point reported: ``"tf32x<products>"`` and ``suffix``."""
    route = f"tf32x{products.value}{suffix}"
    fn.launches_by_route[route] = fn.launches_by_route.get(route, 0) + 1
