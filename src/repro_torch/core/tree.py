"""``repro_torch/core/tree.py`` ↔ ``repro/core/tree.py``.

Balanced binary partition tree in heap layout: recursive median splits along
the locally dominant direction, node ``k``'s children at ``2k+1``/``2k+2``,
level ``l`` at ids ``[2^l - 1, 2^{l+1} - 1)``, leaves at level ``L``.  Every
node covers a contiguous leaf-slot range, so the statistics, q-optimization
and matvec are dense reshape/segment ops.  Arbitrary N pads to ``2^L`` with
zero-weight ghost leaves, and all node statistics are weighted
(``W = sum w``, ``S1 = sum w x``, ``S2 = sum w |x|^2``).

The split order is a stable argsort of the power-iteration projection, as in
the reference; f32 rounding in the power iteration can still reorder
near-tied points, so a tree built here may differ from the reference's on
such data (``core/convert.py`` carries the reference's tree across instead).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

__all__ = ["PartitionTree", "build_tree", "node_level", "leaf_range",
           "level_slice"]

_GHOST_PROJ = 1e30  # ghosts sort to the right end of every segment


@dataclasses.dataclass(frozen=True)
class PartitionTree:
    """Heap-layout balanced partition tree with weighted subtree statistics."""

    L: int
    n_points: int
    dim: int

    x_leaf: torch.Tensor   # (Np, d)  points permuted into leaf order (ghosts 0)
    w_leaf: torch.Tensor   # (Np,)    weights in leaf order (ghosts 0)
    slot_of: torch.Tensor  # (N,)     int64, original row -> leaf slot
    leaf_of: torch.Tensor  # (Np,)    int64, leaf slot -> original row (ghosts -> N)

    W: torch.Tensor   # (n_nodes,)    weighted counts
    S1: torch.Tensor  # (n_nodes, d)  weighted coordinate sums
    S2: torch.Tensor  # (n_nodes,)    weighted squared-norm sums

    @property
    def n_leaves(self) -> int:
        return 1 << self.L

    @property
    def n_nodes(self) -> int:
        return (1 << (self.L + 1)) - 1

    @property
    def n_internal(self) -> int:
        return (1 << self.L) - 1

    @property
    def total_weight(self) -> torch.Tensor:
        return self.W[0]

    @property
    def device(self) -> torch.device:
        return self.W.device

    def to(self, device) -> "PartitionTree":
        """A copy with every tensor on ``device``."""
        moved = {f.name: getattr(self, f.name).to(device)
                 for f in dataclasses.fields(self)
                 if isinstance(getattr(self, f.name), torch.Tensor)}
        return dataclasses.replace(self, **moved)


def node_level(node_id: np.ndarray) -> np.ndarray:
    """Level of a heap node id (root = 0)."""
    return np.floor(np.log2(np.asarray(node_id) + 1)).astype(np.int64)


def level_slice(level: int) -> slice:
    """Flat id range occupied by ``level``."""
    return slice((1 << level) - 1, (1 << (level + 1)) - 1)


def leaf_range(node_id: int, L: int) -> tuple[int, int]:
    """Contiguous leaf-slot range [lo, hi) covered by ``node_id``."""
    lvl = int(node_level(node_id))
    idx = node_id - ((1 << lvl) - 1)
    span = 1 << (L - lvl)
    return idx * span, (idx + 1) * span


def _principal_projection(xs: torch.Tensor, ws: torch.Tensor,
                          iters: int) -> torch.Tensor:
    """Projection of each point on the dominant covariance direction.

    xs: (segments, s, d), ws: (segments, s).  Power iteration on the weighted
    covariance without forming the (d, d) matrix; deterministic init.
    Returns (segments, s) projections.
    """
    tot = ws.sum(dim=1, keepdim=True).clamp_min(1e-12)
    mean = (xs * ws[..., None]).sum(dim=1, keepdim=True) / tot[..., None]
    a = (xs - mean) * torch.sqrt(ws)[..., None]

    d = xs.shape[-1]
    v = (torch.ones((xs.shape[0], d), dtype=xs.dtype, device=xs.device)
         + 1e-3 * torch.arange(d, dtype=xs.dtype, device=xs.device))
    v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    for _ in range(iters):
        u = torch.einsum("bsd,bd->bs", a, v)
        v = torch.einsum("bsd,bs->bd", a, u)
        n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        v = torch.where(n > 1e-12, v / n.clamp_min(1e-12),
                        v * 0 + 1.0 / math.sqrt(d))
    return torch.einsum("bsd,bd->bs", xs - mean, v)


def _build_impl(xp: torch.Tensor, wp: torch.Tensor, L: int, power_iters: int):
    np_, d = xp.shape
    order = torch.arange(np_, device=xp.device)

    for lvl in range(L):
        seg, s = 1 << lvl, np_ >> lvl
        xs = xp[order].reshape(seg, s, d)
        ws = wp[order].reshape(seg, s)
        proj = _principal_projection(xs, ws, power_iters)
        proj = torch.where(ws > 0, proj, _GHOST_PROJ)  # ghosts go right
        idx = torch.argsort(proj, dim=1, stable=True)
        order = torch.gather(order.reshape(seg, s), 1, idx).reshape(-1)

    x_leaf = xp[order]
    w_leaf = wp[order]

    # bottom-up weighted statistics, level-major then flat-concatenated
    ws_, s1s, s2s = [w_leaf], [x_leaf * w_leaf[:, None]], \
        [(x_leaf * x_leaf).sum(-1) * w_leaf]
    for _ in range(L):
        ws_.append(ws_[-1].reshape(-1, 2).sum(1))
        s1s.append(s1s[-1].reshape(-1, 2, d).sum(1))
        s2s.append(s2s[-1].reshape(-1, 2).sum(1))
    W = torch.cat(ws_[::-1])
    S1 = torch.cat(s1s[::-1])
    S2 = torch.cat(s2s[::-1])
    return order, x_leaf, w_leaf, W, S1, S2


def build_tree(
    x: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    power_iters: int = 8,
    capacity: Optional[int] = None,
) -> PartitionTree:
    """Build the shared partition tree over data points ``x`` (N, d).

    The tree lives on ``x``'s device.  ``capacity`` (>= N) sizes the leaf
    level for at least that many points, leaving ghost leaves as headroom.
    """
    x = x.to(torch.float32)
    n, d = x.shape
    if weights is None:
        weights = torch.ones((n,), dtype=x.dtype, device=x.device)
    weights = weights.to(device=x.device, dtype=x.dtype)

    if capacity is not None and capacity < n:
        raise ValueError(f"capacity={capacity} < n_points={n}")
    L = max(1, math.ceil(math.log2(max(n, capacity or 0, 2))))
    np_ = 1 << L
    xp = torch.nn.functional.pad(x, (0, 0, 0, np_ - n))
    wp = torch.nn.functional.pad(weights, (0, np_ - n))

    order, x_leaf, w_leaf, W, S1, S2 = _build_impl(xp, wp, L, power_iters)

    leaf_of = torch.where(order < n, order, n)
    # ghost leaves all scatter into the sacrificial slot ``n``, which is dropped
    slot_of = torch.full((n + 1,), -1, dtype=torch.int64, device=x.device)
    slot_of = slot_of.scatter(0, leaf_of, torch.arange(np_, device=x.device))[:n]

    return PartitionTree(L=L, n_points=n, dim=d, x_leaf=x_leaf, w_leaf=w_leaf,
                         slot_of=slot_of, leaf_of=leaf_of, W=W, S1=S1, S2=S2)
