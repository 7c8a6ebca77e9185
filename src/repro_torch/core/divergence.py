"""``repro_torch/core/divergence.py`` ↔ ``repro/core/divergence.py``.

Only the paper's squared Euclidean divergence is ported in this slice: the
eq.-9 block divergence from the tree's own ``S1``/``S2`` statistics, the
Gaussian log-partition term and the dense pairwise form.  The reference's
other registered divergences (``kl``, ``itakura_saito``, ``mahalanobis``)
resolve to ``NotImplementedError`` until ROADMAP Queue 1 item 6 ports them.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.tree import PartitionTree

__all__ = ["DIVERGENCES", "Divergence", "SQEUCLIDEAN", "resolve_divergence"]


@dataclasses.dataclass(frozen=True)
class Divergence:
    """The squared Euclidean divergence ``d(a, b) = |a - b|^2``."""

    name: str = "sqeuclidean"

    def block_div(self, tree: PartitionTree, a: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
        """D2_AB = sum_{i in A, j in B} w_i w_j |x_i - x_j|^2 (eq. 9), O(1) per block."""
        wa, wb = tree.W[a], tree.W[b]
        d2 = wa * tree.S2[b] + wb * tree.S2[a] - 2.0 * (tree.S1[a] * tree.S1[b]).sum(-1)
        return d2.clamp_min(0.0)

    def log_partition(self, dim, sigma: torch.Tensor) -> torch.Tensor:
        """Log-normalizer ``d/2 log(2 pi s^2)`` of the Gaussian kernel."""
        return 0.5 * dim * torch.log(2.0 * math.pi * sigma * sigma)

    def pairwise(self, xa: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
        """Dense ``max(|a|^2 + |b|^2 - 2 a.b, 0)``, (m, d), (n, d) -> (m, n)."""
        an = (xa * xa).sum(-1)
        bn = (xb * xb).sum(-1)
        return (an[:, None] + bn[None, :] - 2.0 * (xa @ xb.T)).clamp_min(0.0)


SQEUCLIDEAN = Divergence()
DIVERGENCES = {SQEUCLIDEAN.name: SQEUCLIDEAN}
_NOT_PORTED = ("kl", "itakura_saito", "mahalanobis")


def resolve_divergence(divergence) -> Divergence:
    """``None`` | ``"sqeuclidean"`` | :class:`Divergence` -> the divergence."""
    if divergence is None or isinstance(divergence, Divergence):
        return SQEUCLIDEAN
    if divergence in DIVERGENCES:
        return DIVERGENCES[divergence]
    if isinstance(divergence, str) and divergence.split("[")[0] in _NOT_PORTED:
        raise NotImplementedError(
            f"divergence {divergence!r} is not ported to repro_torch yet "
            f"(ROADMAP Queue 1 item 6); only 'sqeuclidean' is available")
    raise ValueError(f"unknown divergence {divergence!r}; "
                     f"registered: {sorted(DIVERGENCES)}")
