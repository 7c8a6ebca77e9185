"""``repro_torch/kernels/fused_lp/ref.py`` ↔ ``repro/kernels/fused_lp/ref.py``.

Dense oracles for the fused label-propagation kernel: the (N, N) transition
matrix of eq. 3 and the iterated eq.-15 walk over it, under any registered
divergence (``divergence=``; ``None`` is the paper's Gaussian kernel).
O(N^2) memory; tests, the chip smoke and the GRF bridge only.
"""
from __future__ import annotations

import torch

from repro_torch.core.divergence import resolve_divergence

__all__ = ["dense_transition_ref", "fused_lp_scan_batched_ref"]


def dense_transition_ref(x: torch.Tensor, sigma,
                         divergence=None) -> torch.Tensor:
    """Row softmax of ``-d(x_i, x_j) / (2 sigma^2)`` with a zero diagonal."""
    x = x.to(torch.float32)
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=x.device)
    logits = -resolve_divergence(divergence).pairwise(x, x) / (
        2.0 * sigma * sigma)
    eye = torch.eye(x.shape[0], dtype=torch.bool, device=x.device)
    return torch.softmax(logits.masked_fill(eye, float("-inf")), dim=-1)


def fused_lp_scan_batched_ref(x: torch.Tensor, y0s: torch.Tensor, sigma,
                              alpha, n_iters: int,
                              divergence=None) -> torch.Tensor:
    """``n_iters`` dense eq.-15 iterations over a (B, N, C) stack.

    ``alpha`` is a scalar or a per-request ``(B,)`` array.
    """
    p = dense_transition_ref(x, sigma, divergence=divergence)
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=x.device)
    if alpha.ndim == 1:
        alpha = alpha[:, None, None]
    y = y0s
    for _ in range(int(n_iters)):
        y = alpha * torch.einsum("ij,bjc->bic", p, y) + (1.0 - alpha) * y0s
    return y
