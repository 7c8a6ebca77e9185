"""``repro_torch/kernels/grf/ref.py`` ↔ ``repro/kernels/grf/ref.py``.

Dense oracles for the GRF estimator, O(N^2): ``grf_feature_matvec_ref`` is
the gather-and-mean twin of K5 (``impl="ref"``), and
``dense_power_action_ref``/``dense_lp_ref`` iterate a dense transition matrix
directly, the ground truth the statistical tests bound the walker estimates
against.  Tests and the chip smoke only.  Arrays may be numpy (taken to the
CPU) or tensors (kept on their device).
"""
from __future__ import annotations

import torch

__all__ = ["dense_lp_ref", "dense_power_action_ref", "grf_feature_matvec_ref"]


def _f32(a, device=None) -> torch.Tensor:
    return torch.as_tensor(a, device=device).to(torch.float32)


def grf_feature_matvec_ref(pos, load, y) -> torch.Tensor:
    """``(1/m) * sum_w load[s, w] * y[pos[s, w], :]`` by gather and mean."""
    y = _f32(y)
    pos = torch.as_tensor(pos, device=y.device).long()
    return (y[pos] * _f32(load, y.device)[..., None]).mean(dim=1)


def dense_power_action_ref(p, y, t: int) -> torch.Tensor:
    """``P^t @ Y`` by ``t`` explicit dense products."""
    p = _f32(p)
    out = _f32(y, p.device)
    for _ in range(int(t)):
        out = p @ out
    return out


def dense_lp_ref(p, y0, alpha=0.01, n_iters: int = 500) -> torch.Tensor:
    """Eq.-15 label propagation against a dense transition matrix.

    ``alpha`` is a scalar or per-column ``(C,)``, broadcast against ``y0``.
    """
    p = _f32(p)
    y0 = _f32(y0, p.device)
    alpha = _f32(alpha, p.device)
    y = y0
    for _ in range(int(n_iters)):
        y = alpha * (p @ y) + (1.0 - alpha) * y0
    return y
