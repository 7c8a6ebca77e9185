"""The plain-torch version of the block combine (``csrc/block_combine.cu``;
no counterpart in ``repro``).

    c_node[n, :] = sum over the blocks k of row n of q[k] * t[b[k], :]

It is the walk's combine as torch ops, ``index_select``, the product by
``q``, then ``index_add_`` into zeros, run over the CSR's blocks.  On the
CPU ``index_add_`` adds in block order, so this equals the same combine over
all the partition's slots bit for bit: the slots it leaves out add exactly
0, and a row keeps slot order.  The kernel fuses each product into its sum
(FMA) and splits a row over lane groups and chunks, so the two agree to
float32 rounding, not bit for bit.
"""
from __future__ import annotations

import torch

__all__ = ["block_combine_plain"]


def block_combine_plain(t: torch.Tensor, row_ptr: torch.Tensor,
                        b: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``c_node`` (..., n_nodes, C) from node sums ``t`` (..., n_nodes, C)."""
    n_nodes = row_ptr.shape[0] - 1
    rows = torch.repeat_interleave(
        torch.arange(n_nodes, device=t.device), row_ptr.diff().long())
    c_block = q.to(t.dtype)[:, None] * t.index_select(-2, b.long())
    return torch.zeros_like(t).index_add_(-2, rows, c_block)
