"""``repro_torch/kernels/flash_attention/ops.py`` ↔ ``repro/kernels/flash_attention/ops.py``.

:func:`flash_attention` is the wrapper of K6, two hand-written CUDA kernels
picked by the operands' type:

- bfloat16, the served models' type: ``csrc/flash_attention_sm90.cu``, on
  Hopper's tensor cores (``wgmma``, K/V staged by TMA), route ``"sm90_bf16"``;
- float32: ``csrc/flash_attention_tf32x3.cu``, also on the tensor cores,
  float32-accurate as three TF32 products of split operands (3xTF32, the
  scheme of K1-K4, ``kernels/csrc/tf32x3.cuh``), route ``"sm90_tf32x3"``.
  One launch of its entry point runs a pre-pass that writes the split K and
  the split, transposed V (TF32 ``wgmma`` takes only K-major operands) into
  scratch this wrapper allocates, then the attention kernel.  The entry point
  reports the TF32 products a product takes, and the launch is counted under
  ``"sm90_tf32x<products>"``, so a build with one product shows off the route.

On CUDA tensors it launches one of them, counting the launch in
``flash_attention.launches`` and in ``flash_attention.launches_by_route``, or
raises; it never falls back.  On CPU tensors it runs the plain version
``flash_attention.flash_attention_plain``, which walks the kernels' tiles and
recurrence.

The call is a ``torch.autograd.Function``: its forward is the operator
``repro_torch::flash_attention_fwd`` (:func:`flash_attention_fwd`: the
kernel, or the plain version, run untaped; on ``meta`` tensors a fake that
gives the output's shape; its FLOPs registered as the unmasked pairs'
products), saving q, k and v; its backward is
``flash_attention.flash_attention_backward``, float32 torch ops that
recompute the scores (the reference has no Pallas backward kernel).  Only
the forward counts a launch; a recompute under activation checkpointing
runs, and counts, the forward again.  Both kernels take head widths 64, 128 and 256, those of the
ported dense configurations, with q, k and v of one type.  The reference's
``block_q``/``block_k`` arguments are TPU tile sizes and are not taken: the
kernels' tiles are fixed (``KV_TILE``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels._build import (check_operand, launch, load_library,
                                        on_card)
from repro_torch.kernels.flash_attention.flash_attention import (
    KV_TILE, LOG2E, attention_work, flash_attention_backward,
    flash_attention_plain)

__all__ = ["HEAD_DIMS", "SM90_SOURCE", "TF32X3_SOURCE", "flash_attention",
           "flash_attention_fwd", "sm90_library", "tf32x3_library"]

_CSRC = Path(__file__).resolve().parent / "csrc"
SM90_SOURCE = _CSRC / "flash_attention_sm90.cu"       # bfloat16, "sm90_bf16"
TF32X3_SOURCE = _CSRC / "flash_attention_tf32x3.cu"   # float32, "sm90_tf32x3"
HEAD_DIMS = (64, 128, 256)
_DTYPES = (torch.float32, torch.bfloat16)


def tf32x3_library():
    """Build (at first use) and load the float32 tensor-core kernel; returns
    a ``_build.BuiltLibrary``."""
    built = load_library(TF32X3_SOURCE)
    fn = built.lib.flash_attention_tf32x3
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return built


def sm90_library():
    """Build (at first use) and load the bfloat16 tensor-core kernel."""
    built = load_library(SM90_SOURCE)
    fn = built.lib.flash_attention_sm90
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return built


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it when its storage is not 16-byte aligned (TMA)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=())
def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, window: int) -> torch.Tensor:
    """K6's forward as one operator: the kernel on CUDA tensors, the plain
    version on CPU ones.  A dispatch mode (``FlopCounterMode``,
    ``launch/dryrun.py``'s byte counter) sees this one call and not the
    operations inside it; on ``meta`` tensors only its fake runs."""
    if not on_card("flash_attention", q):
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    return _launch(q, k, v, causal, window)


@flash_attention_fwd.register_fake
def _flash_attention_fwd_fake(q, k, v, causal, window):
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _flash_attention_fwd_flops(q_shape, k_shape, v_shape, causal, window,
                               *args, **kwargs) -> int:
    """The unmasked pairs' two products (:func:`attention_work`)."""
    b, hq, s, d = q_shape
    return int(attention_work(b, hq, k_shape[1], s, d, window, 0,
                              causal)[0])


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return flash_attention_fwd(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        return (*flash_attention_backward(q, k, v, dout, ctx.causal,
                                          ctx.window), None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """``q`` (B, Hq, S, D), ``k``/``v`` (B, Hkv, S, D) -> (B, Hq, S, D).

    Query head ``h`` attends with key/value head ``h // (Hq // Hkv)``;
    ``window`` > 0 keeps keys with ``i - j < window``.  Differentiable in q,
    k and v.
    """
    return _Attention.apply(q, k, v, bool(causal), int(window))


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: int) -> torch.Tensor:
    """One launch of K6's kernel for the operands' type, counted."""
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
    scale_log2 = float(d) ** -0.5 * LOG2E
    if q.dtype == torch.bfloat16:
        q, k, v = _aligned(q), _aligned(k), _aligned(v)
        route = "sm90_bf16"
        launch(sm90_library(), "flash_attention_sm90", q.device, q.data_ptr(),
               k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv, s, d,
               int(bool(causal)), int(window), scale_log2)
    else:
        q = _aligned(q)
        # the pre-pass's output: split K (B, Hkv, S, D), split V^T
        # (B, Hkv, D, S rounded up to the 64-key tile)
        khi, klo = torch.empty_like(k), torch.empty_like(k)
        vthi = torch.empty((b, hkv, d, -(-s // KV_TILE) * KV_TILE),
                           dtype=torch.float32, device=q.device)
        vtlo = torch.empty_like(vthi)
        products = ctypes.c_int(0)
        launch(tf32x3_library(), "flash_attention_tf32x3", q.device,
               q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               khi.data_ptr(), klo.data_ptr(), vthi.data_ptr(),
               vtlo.data_ptr(), b, hq, hkv, s, d, int(bool(causal)),
               int(window), scale_log2, ctypes.addressof(products))
        route = f"sm90_tf32x{products.value}"
    flash_attention.launches += 1
    by_route = flash_attention.launches_by_route
    by_route[route] = by_route.get(route, 0) + 1
    return out


# K6 launches, in all and by route; the CPU path does not count
flash_attention.launches = 0
flash_attention.launches_by_route = {"sm90_bf16": 0, "sm90_tf32x3": 0}
