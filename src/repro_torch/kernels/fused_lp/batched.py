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
exactly the given rows.  ``ops.folded_step`` runs this on CPU tensors and
the CUDA kernel on card tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_lp.fused_lp import NEG_BIG, stream_tile_update

__all__ = ["alpha_row", "folded_step_plain"]

# tile sizes of the plain version: large, so that on the card a full-size
# step is a few hundred matrix products rather than a million tiny ones
PLAIN_BLOCK_M = 4096
PLAIN_BLOCK_N = 8192


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
    n_rows, n = rows.shape[0], cols.shape[0]
    k = y.shape[1]
    dev = rows.device
    out = torch.empty((n_rows, k), dtype=torch.float32, device=dev)
    col_ids = torch.arange(n, device=dev)
    for i0 in range(0, n_rows, block_m):
        i1 = min(i0 + block_m, n_rows)
        row_ids = row_base + torch.arange(i0, i1, device=dev)
        m = torch.full((i1 - i0,), NEG_BIG, dtype=torch.float32, device=dev)
        s = torch.zeros((i1 - i0,), dtype=torch.float32, device=dev)
        acc = torch.zeros((i1 - i0, k), dtype=torch.float32, device=dev)
        for j0 in range(0, n, block_n):
            j1 = min(j0 + block_n, n)
            m, s, acc = stream_tile_update(
                rows[i0:i1], cols[j0:j1], y[j0:j1], m, s, acc, row_ids,
                col_ids[j0:j1], inv_two_sigma_sq=inv_two_sigma_sq, n_valid=n)
        py = acc / s.clamp_min(1e-38)[:, None]
        out[i0:i1] = alpha * py + (1.0 - alpha) * y0[i0:i1]
    return out
