"""``repro_torch/kernels/grf/grf.py`` ↔ ``repro/kernels/grf/grf.py``.

The plain-torch version of K5 (``csrc/grf_feature.cu``, the port of the
reference's ``grf_feature_kernel``), the walker-mean feature product

    out[s, :] = (1/m) * sum_w load[s, w] * y[pos[s, w], :]

It repeats the kernel's summation order: walker ``w`` goes to lane
``w % 32``, each lane sums its walkers in order, and the 32 lane sums meet
in the kernel's xor-shuffle tree.  Every step is elementwise per column, so
column ``c`` comes out with the same bits whatever the number of columns
(the kernel's fold-parity promise, kept on the CPU too).  The kernel fuses
each ``load * y`` product into its sum (FMA), this version rounds both, so
the two agree to float32 rounding, not bit for bit.  A position outside
``[0, N)`` contributes 0 in both, as in the reference's one-hot kernel.
"""
from __future__ import annotations

import torch

__all__ = ["LANES", "grf_feature_plain"]

LANES = 32  # the kernel's warp: walkers are split over 32 lanes


def grf_feature_plain(pos: torch.Tensor, load: torch.Tensor,
                      y: torch.Tensor) -> torch.Tensor:
    """``(S, m)`` positions and loads x ``(N, K)`` values -> ``(S, K)``."""
    s, m = pos.shape
    n, k = y.shape
    pos = pos.long()
    valid = (pos >= 0) & (pos < n)
    pad = -m % LANES
    # padded and out-of-range walkers sit at node 0 with load 0: they add 0
    pos = torch.nn.functional.pad(pos * valid, (0, pad)).view(s, -1, LANES)
    load = torch.nn.functional.pad(load * valid, (0, pad)).view(s, -1, LANES)
    acc = torch.zeros((s, LANES, k), dtype=torch.float32, device=y.device)
    for r in range(pos.shape[1]):
        acc = acc + load[:, r, :, None] * y[pos[:, r]]
    width = LANES
    while width > 1:                       # the xor-shuffle tree, lane 0
        width //= 2
        acc = acc[:, :width] + acc[:, width:2 * width]
    return acc[:, 0] * (1.0 / m)
