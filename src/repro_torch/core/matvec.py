"""``repro_torch/core/matvec.py`` ↔ ``repro/core/matvec.py``.

O(|B|) matrix-vector multiplication with the block transition matrix, the
vectorized form of the paper's Algorithm 1:

    (QY)_i = sum_{(A,B) in B(x_i)} q_AB * T_B,   T_B = sum_{j in B} y_j

  CollectUp      -> level-major reshape sums give T for all nodes, O(N C)
  per-block      -> c_block = q_AB * T[b];  segment-sum into c_node, O(|B| C)
  DistributeDown -> top-down prefix accumulation over levels, O(N C)

Leaves read their accumulated path sum.  Every step is linear in the
trailing channel axis, so leading batch dims ride along, and a stacked
``(batch, N, C)`` right-hand side folds into ``(N, batch * C)`` for one
pass (``fold_batch``/``unfold_batch``).

The reference's ``segment_sum`` becomes ``index_add_`` over the slot list on
the CPU, which adds in block order and is bit-stable.  On a CUDA device, with
the fitted tree's CSR of active blocks (``kernels/block_combine``), the
combine is one hand-written kernel that sums each node's blocks in a fixed
order, with no atomics: the same bits from call to call there too.
"""
from __future__ import annotations

import torch

from repro_torch.core.tree import PartitionTree
from repro_torch.kernels.block_combine import BlockCsr, block_combine

__all__ = ["collect_up", "fold_batch", "mpt_matvec", "mpt_matvec_batched",
           "mpt_matvec_leaforder", "prepare_q", "unfold_batch"]


def prepare_q(active: torch.Tensor, log_q: torch.Tensor) -> torch.Tensor:
    """Block weights ``q = exp(log_q)`` with inactive/-inf entries zeroed."""
    return torch.where(active & torch.isfinite(log_q), torch.exp(log_q), 0.0)


def fold_batch(ys: torch.Tensor) -> torch.Tensor:
    """(batch, N, C) -> (N, batch * C); folded column ``b*C + ch`` is batch b."""
    batch, n, c = ys.shape
    return ys.movedim(0, 1).reshape(n, batch * c)


def unfold_batch(y: torch.Tensor, batch: int, c: int) -> torch.Tensor:
    """(N, batch * C) -> (batch, N, C); inverse of ``fold_batch``."""
    return y.reshape(y.shape[0], batch, c).movedim(1, 0)


def collect_up(y_leaf: torch.Tensor, L: int) -> torch.Tensor:
    """Per-node sums T (..., n_nodes, C) from leaf values (..., Np, C)."""
    levels = [y_leaf]
    cur = y_leaf
    for _ in range(L):
        cur = cur.reshape(*cur.shape[:-2], -1, 2, cur.shape[-1]).sum(dim=-2)
        levels.append(cur)
    return torch.cat(levels[::-1], dim=-2)


def _distribute_down(c_node: torch.Tensor, L: int) -> torch.Tensor:
    """Top-down prefix accumulation; returns per-leaf path sums (..., Np, C)."""
    acc = c_node[..., 0:1, :]
    for lvl in range(L):
        lo, hi = (1 << (lvl + 1)) - 1, (1 << (lvl + 2)) - 1
        acc = acc.repeat_interleave(2, dim=-2) + c_node[..., lo:hi, :]
    return acc


def mpt_matvec_leaforder(y_leaf: torch.Tensor, a: torch.Tensor,
                         b: torch.Tensor, q: torch.Tensor, L: int,
                         csr: BlockCsr | None = None) -> torch.Tensor:
    """(QY) in leaf order; any leading batch dims ride along level-major.

    ``y_leaf`` (..., Np, C) holds values in leaf order (ghosts 0); ``a``,
    ``b`` are int64 block node ids and ``q`` the block weights (0 where
    inactive).  ``csr``, the same blocks as a ``block_csr``, routes the
    combine through the block-combine kernel on a CUDA ``y_leaf``; the CPU
    adds over the slot list.
    """
    t = collect_up(y_leaf, L)                        # (..., n_nodes, C)
    if csr is not None and t.is_cuda:
        c_node = block_combine(t, csr)
    else:
        c_block = q[:, None] * t.index_select(-2, b)     # (..., cap, C)
        c_node = torch.zeros_like(t).index_add_(-2, a, c_block)
    return _distribute_down(c_node, L)


def mpt_matvec(tree: PartitionTree, a: torch.Tensor, b: torch.Tensor,
               active: torch.Tensor, log_q: torch.Tensor,
               y: torch.Tensor, csr: BlockCsr | None = None) -> torch.Tensor:
    """(QY) in original row order for (N,), (N, C) or (batch, N, C) ``y``;
    ``csr`` as in :func:`mpt_matvec_leaforder`."""
    if y.ndim == 3:
        batch, _, c = y.shape
        out = mpt_matvec(tree, a, b, active, log_q, fold_batch(y), csr)
        return unfold_batch(out, batch, c)
    squeeze = y.ndim == 1
    if squeeze:
        y = y[:, None]
    q = prepare_q(active, log_q)
    y_leaf = torch.zeros((tree.n_leaves, y.shape[1]), dtype=y.dtype,
                         device=y.device)
    y_leaf[tree.slot_of] = y
    out = mpt_matvec_leaforder(y_leaf, a, b, q, tree.L, csr)[tree.slot_of]
    return out[:, 0] if squeeze else out


def mpt_matvec_batched(tree: PartitionTree, a: torch.Tensor, b: torch.Tensor,
                       active: torch.Tensor, log_q: torch.Tensor,
                       ys: torch.Tensor,
                       csr: BlockCsr | None = None) -> torch.Tensor:
    """Explicit batched multi-RHS (Q @ Y_b for every b) in one pass."""
    if ys.ndim != 3:
        raise ValueError(
            f"mpt_matvec_batched wants (batch, N, C), got {tuple(ys.shape)}")
    return mpt_matvec(tree, a, b, active, log_q, ys, csr)
