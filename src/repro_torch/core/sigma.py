"""``repro_torch/core/sigma.py`` ↔ ``repro/core/sigma.py``.

Bandwidth learning for the Gaussian similarity kernel (paper §4.2):

  * ``sigma_init`` — the refined-limit closed form (eq. 14), exact in O(N d)
    via ``sum_ij w_i w_j |x_i - x_j|^2 = 2 W sum_i w_i |x_i|^2 - 2 |sum_i w_i x_i|^2``;
  * ``sigma_star`` — the block closed form (eq. 12) given the current q
    (under a non-default ``divergence`` the numerator sums the block Bregman
    divergences: the same stationarity condition of the generalized bound);
  * ``fit_sigma_q`` — alternates q-optimization and eq. 12 until the relative
    change in sigma falls below ``tol``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.divergence import bind_divergence
from repro_torch.core.qopt import QState, block_sq_dists, optimize_q
from repro_torch.core.tree import PartitionTree

__all__ = ["sigma_init", "sigma_star", "fit_sigma_q"]


def sigma_init(x: torch.Tensor,
               weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eq. (14) via exact O(N d) moments."""
    x = x.to(torch.float32)
    n, d = x.shape
    w = (torch.ones((n,), dtype=x.dtype, device=x.device) if weights is None
         else weights.to(device=x.device, dtype=x.dtype))
    w_tot = w.sum()
    s1 = (x * w[:, None]).sum(0)
    s2 = ((x * x).sum(-1) * w).sum()
    sum_sq = 2.0 * w_tot * s2 - 2.0 * (s1 * s1).sum()
    return torch.sqrt(sum_sq.clamp_min(1e-12) / d) / w_tot.clamp_min(1.0)


def sigma_star(tree: PartitionTree, a: torch.Tensor, b: torch.Tensor,
               active: torch.Tensor, log_q: torch.Tensor,
               divergence=None) -> torch.Tensor:
    """Eq. (12): closed-form optimal bandwidth given fixed q."""
    q = torch.where(active & torch.isfinite(log_q), torch.exp(log_q), 0.0)
    num = (q * block_sq_dists(tree, a, b, divergence=divergence)).sum()
    return torch.sqrt(num.clamp_min(1e-12)
                      / (tree.dim * tree.W[0].clamp_min(1.0)))


def fit_sigma_q(tree: PartitionTree, a: torch.Tensor, b: torch.Tensor,
                active: torch.Tensor, sigma0, max_iters: int = 20,
                tol: float = 1e-3,
                divergence=None) -> Tuple[torch.Tensor, QState, int]:
    """Alternate eq. (7) q-optimization with eq. (12) until convergence."""
    div = bind_divergence(divergence, tree)  # bind stats once, reuse per iter
    sigma = torch.as_tensor(sigma0, dtype=torch.float32, device=tree.device)
    qs = optimize_q(tree, a, b, active, sigma, divergence=div)
    it = 0
    for it in range(1, max_iters + 1):
        new_sigma = sigma_star(tree, a, b, active, qs.log_q, divergence=div)
        rel = abs(float(new_sigma) - float(sigma)) / max(float(sigma), 1e-12)
        sigma = new_sigma
        qs = optimize_q(tree, a, b, active, sigma, divergence=div)
        if rel < tol:
            break
    return sigma, qs, it
