"""``repro_torch/kernels/pairwise/pairwise.py`` ↔ ``repro/kernels/pairwise/pairwise.py``.

The plain-torch version of K4 (``csrc/pairwise.cu``, the port of the
reference's ``pairwise_sq_dists_kernel``):

    D2[i, j] = max(|x_i|^2 + |y_j|^2 - 2 x_i.y_j, 0)

for ``x`` (M, d) and ``y`` (N, d) in float32 or bfloat16, upcast to float32
before any arithmetic; the output is float32 (M, N).  The cross term is one
float32 matrix product (TF32 stays off, see ``_device.py``).
"""
from __future__ import annotations

import torch

__all__ = ["pairwise_sq_dists_plain"]


def pairwise_sq_dists_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(M, d), (N, d) -> (M, N) squared distances by the norm expansion."""
    x, y = x.to(torch.float32), y.to(torch.float32)
    xx = (x * x).sum(-1)
    yy = (y * y).sum(-1)
    return (xx[:, None] + yy[None, :] - 2.0 * (x @ y.T)).clamp_min(0.0)
