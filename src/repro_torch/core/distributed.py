"""``repro_torch/core/distributed.py`` ↔ ``repro/core/distributed.py``.

The VDT matvec (Algorithm 1) as one eq.-15 label-propagation step in leaf
order, the form the sharded serving engine decomposes:

  CollectUp      — per-level reshape sums over the leaf axis
  block combine  — c_block = q * T[b];  segment-sum by a-node
  DistributeDown — prefix accumulation over levels

``lp_step_leaforder`` takes the reference's two performance options:
``sorted_blocks`` (in the reference only a hint to ``segment_sum`` that the
blocks are sorted by their a-node; ``index_add_`` takes no such hint, so it
is accepted and ignored) and ``carrier_dtype`` (the tree sums and the block
contraction in a narrower type, bfloat16 halving their traffic; the step's
result is cast back to the labels' type).  ``vdt_input_specs`` gives the
reference's dry-run stand-ins as ``meta`` tensors.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.matvec import _distribute_down, collect_up

__all__ = ["label_propagate_distributed", "lp_step_leaforder",
           "vdt_input_specs"]


def lp_step_leaforder(y_leaf: torch.Tensor, y0_leaf: torch.Tensor,
                      a: torch.Tensor, b: torch.Tensor, q: torch.Tensor,
                      alpha: float, L: int, sorted_blocks: bool = False,
                      carrier_dtype=None) -> torch.Tensor:
    """One Label-Propagation step ``y <- alpha Q y + (1 - alpha) y0``.

    ``y_leaf``/``y0_leaf`` (Np, C) in leaf order (ghosts 0), ``a``/``b``
    (nb,) block node ids, ``q`` (nb,) block weights (0 where inactive).
    ``sorted_blocks`` is the reference's hint and changes nothing here.
    """
    n_nodes = (1 << (L + 1)) - 1
    dt = carrier_dtype or y_leaf.dtype
    t = collect_up(y_leaf.to(dt), L)                       # (n_nodes, C)
    c_block = q.to(dt)[:, None] * t.index_select(0, b)     # (nb, C) gather
    c_node = torch.zeros((n_nodes, c_block.shape[1]), dtype=dt,
                         device=c_block.device).index_add_(0, a, c_block)
    acc = _distribute_down(c_node, L)
    return alpha * acc.to(y_leaf.dtype) + (1.0 - alpha) * y0_leaf


def label_propagate_distributed(y0_leaf, a, b, q, alpha: float, L: int,
                                n_iters: int) -> torch.Tensor:
    """``n_iters`` steps of :func:`lp_step_leaforder` from ``y0_leaf``."""
    y = y0_leaf
    for _ in range(int(n_iters)):
        y = lp_step_leaforder(y, y0_leaf, a, b, q, alpha, L)
    return y


def vdt_input_specs(n_points: int = 1 << 20, n_classes: int = 16,
                    blocks_per_point: int = 4):
    """Shape-and-type stand-ins (``meta`` tensors) for the paper_vdt cell.

    N = 2^20 leaves, C = 16 label classes, |B| = 4N blocks — the scale of
    the paper's Table 2 'alpha' experiment (0.5M points, 1M-4M params).
    """
    L = int(math.log2(n_points))
    nb = blocks_per_point * n_points

    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    return {
        "y_leaf": spec((n_points, n_classes), torch.float32),
        "y0_leaf": spec((n_points, n_classes), torch.float32),
        "a": spec((nb,), torch.int32),
        "b": spec((nb,), torch.int32),
        "q": spec((nb,), torch.float32),
    }, {"L": L, "tokens_per_step": n_points}
