"""``repro_torch/kernels/pairwise/ref.py`` ↔ ``repro/kernels/pairwise/ref.py``.

The direct-difference oracle for K4, ``sum_k (x_ik - y_jk)^2`` in float32:
no cancellation, O(M N d) memory.  Tests and the chip smoke only, at small
shapes.
"""
from __future__ import annotations

import torch

__all__ = ["pairwise_sq_dists_ref"]


def pairwise_sq_dists_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    x, y = x.to(torch.float32), y.to(torch.float32)
    d2 = ((x[:, None, :] - y[None, :, :]) ** 2).sum(-1)
    return d2.clamp_min(0.0)
