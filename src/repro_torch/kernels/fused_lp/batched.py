"""``repro_torch/kernels/fused_lp/batched.py`` ↔ ``repro/kernels/fused_lp/batched.py``.

The plain-torch version of the folded fused label-propagation step, the
reference's ``_folded_call`` contract.  For every row ``i`` of ``rows`` and
folded column ``k < K = B*C``:

    logit[i, j] = -max(|x_i|^2 + |x_j|^2 - 2 x_i.x_j, 0) / (2 sigma^2)
                  (NEG_BIG where j == row_base + i or j >= n_valid)
    out[i, k]   = alpha[k] * (softmax_j(logit[i, :]) @ Y)[k]
                  + (1 - alpha[k]) * Y0[i, k]

computed with the online softmax of :func:`stream_tile_update` over column
tiles, so P is never whole.  The reference pads rows and columns to tile
multiples; here ragged tiles are sliced instead, and the output covers
exactly the given rows.  A row whose every column is masked (only N = 1 has
one) divides by the reference's padded column count, as the reference does
(``fused_lp.softmax_average``).  ``ops.folded_step`` runs this on CPU tensors
and the CUDA kernel K1 on card tensors.

:func:`step_batched_perbatch_plain` is the plain version of K3, the
reference's per-batch-recompute ``fused_lp_step_batched_kernel``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_lp.fused_lp import (PLAIN_BLOCK_M,
                                                   PLAIN_BLOCK_N, stream_rows)

__all__ = ["alpha_row", "folded_step_plain", "step_batched_perbatch_plain"]


def alpha_row(alpha, k: int, device) -> torch.Tensor:
    """Broadcast a scalar or per-column alpha to the contiguous (K,) operand."""
    al = torch.as_tensor(alpha, dtype=torch.float32, device=device).reshape(-1)
    return al.expand(k).contiguous()


def folded_step_plain(rows: torch.Tensor, cols: torch.Tensor, y: torch.Tensor,
                      y0: torch.Tensor, alpha: torch.Tensor,
                      inv_two_sigma_sq: float, row_base: int = 0, *,
                      block_m: int = PLAIN_BLOCK_M,
                      block_n: int = PLAIN_BLOCK_N) -> torch.Tensor:
    """One eq.-15 step in the folded layout (plain torch, any device).

    ``rows`` (M, d) are the points whose labels are updated, global ids
    ``row_base .. row_base + M``; ``cols`` (N, d) and ``y`` (N, K) are all
    points and their current labels; ``y0`` (M, K) the seed rows and
    ``alpha`` (K,) the per-column restart weight.  Returns (M, K).
    """
    out = torch.empty((rows.shape[0], y.shape[1]), dtype=y.dtype,
                      device=rows.device)
    for i0, i1, py in stream_rows(rows, cols, y, inv_two_sigma_sq, row_base,
                                  block_m, block_n):
        out[i0:i1] = alpha * py + (1.0 - alpha) * y0[i0:i1]
    return out


def step_batched_perbatch_plain(x: torch.Tensor, y: torch.Tensor,
                                y0: torch.Tensor, alpha: float,
                                inv_two_sigma_sq: float, *,
                                block_m: int = PLAIN_BLOCK_M,
                                block_n: int = PLAIN_BLOCK_N) -> torch.Tensor:
    """The per-batch-recompute eq.-15 step over a (B, N, C) stack (plain torch).

    The plain version of K3 (the reference's ``fused_lp_step_batched_kernel``):
    each batch element streams the distance tiles anew; ``alpha`` is one
    float for the whole stack.
    """
    out = torch.empty(y.shape, dtype=y.dtype, device=x.device)
    for b in range(y.shape[0]):
        for i0, i1, py in stream_rows(x, x, y[b], inv_two_sigma_sq, 0,
                                      block_m, block_n):
            out[b, i0:i1] = alpha * py + (1.0 - alpha) * y0[b, i0:i1]
    return out
