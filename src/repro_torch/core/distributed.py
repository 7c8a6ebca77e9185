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

Row-sharded (the reference's production layout, which GSPMD partitions):
given DTensors whose rows (leaves and blocks alike) are split over *every*
dimension of their ``DeviceMesh``, data-major (``P(("data", "model"))``,
on a 2-D mesh ``(Shard(0), Shard(0))``; :func:`shard_rows` lays a tensor
out so), the step runs as one SPMD program of D = 2^s ranks, rank r owning
the whole subtree under node ``2^s - 1 + r``:

  1. all-gather the leaf rows, in the carrier type (N C elements a rank;
     chosen over gathering each rank's subtree sums, about twice that);
  2. CollectUp over the whole tree on every rank, the gather ``T[b]`` of
     the rank's own blocks, and their segment-sum into a whole
     ``(n_nodes, C)`` partial (``local_map``);
  3. the partials' levels s … L reduce-scattered to each subtree's owner,
     their 2^s - 1 top rows all-reduced: the "cross-shard leaf reductions
     as reduce-scatters" of the reference's module docstring;
  4. DistributeDown of the replicated top levels to the rank's subtree
     root, then down its own subtree (``local_map``).

The carriers, and so every collective, are in ``carrier_dtype``.  The
result has ``y_leaf``'s placements.  A DTensor layout this form does not
take (a placement other than ``Shard(0)``, a rank count that is not a
power of two, rows that do not split into whole subtrees, block lists that
do not divide) raises ``ValueError``: nothing is gathered to one rank
instead.  Plain tensors take the one-device path.
"""
from __future__ import annotations

import math

import torch

from repro_torch._device import is_dtensor
from repro_torch.core.matvec import _distribute_down, collect_up

__all__ = ["label_propagate_distributed", "lp_step_leaforder", "shard_rows",
           "vdt_input_specs"]


def lp_step_leaforder(y_leaf: torch.Tensor, y0_leaf: torch.Tensor,
                      a: torch.Tensor, b: torch.Tensor, q: torch.Tensor,
                      alpha: float, L: int, sorted_blocks: bool = False,
                      carrier_dtype=None) -> torch.Tensor:
    """One Label-Propagation step ``y <- alpha Q y + (1 - alpha) y0``.

    ``y_leaf``/``y0_leaf`` (Np, C) in leaf order (ghosts 0), ``a``/``b``
    (nb,) block node ids, ``q`` (nb,) block weights (0 where inactive):
    plain tensors, or DTensors split by rows over their whole mesh (the
    module docstring's SPMD program).  ``sorted_blocks`` is the
    reference's hint and changes nothing here.
    """
    dt = carrier_dtype or y_leaf.dtype
    inputs = (y_leaf, y0_leaf, a, b, q)
    if any(is_dtensor(x) for x in inputs):
        return _step_sharded(*inputs, alpha, L, dt)
    n_nodes = (1 << (L + 1)) - 1
    t = collect_up(y_leaf.to(dt), L)                       # (n_nodes, C)
    c_block = q.to(dt)[:, None] * t.index_select(0, b)     # (nb, C) gather
    c_node = torch.zeros((n_nodes, c_block.shape[1]), dtype=dt,
                         device=c_block.device).index_add_(0, a, c_block)
    acc = _distribute_down(c_node, L)
    return alpha * acc.to(y_leaf.dtype) + (1.0 - alpha) * y0_leaf


def _row_ranks(inputs: tuple, L: int) -> int:
    """The rank count D = 2^s of the inputs' common mesh, after checking
    that each is a DTensor split by rows over every mesh dimension, the
    leaves into whole subtrees and the blocks evenly."""
    from torch.distributed.tensor import Shard

    names = ("y_leaf", "y0_leaf", "a", "b", "q")
    mesh = inputs[0].device_mesh if is_dtensor(inputs[0]) else None
    for name, x in zip(names, inputs):
        if not is_dtensor(x) or x.device_mesh != mesh:
            raise ValueError(
                f"the sharded LP step takes DTensors on one mesh only: "
                f"{name} is {'on another mesh' if is_dtensor(x) else 'plain'}")
        if any(p != Shard(0) for p in x.placements):
            raise ValueError(
                f"{name} is laid out {tuple(x.placements)}: the sharded LP "
                "step takes rows split over every mesh dimension, "
                f"{(Shard(0),) * mesh.ndim}")
    d = mesh.size()
    if d & (d - 1):
        raise ValueError(f"the sharded LP step needs a power-of-two rank "
                         f"count, the mesh has {d}")
    n_leaves, c = inputs[0].shape
    if n_leaves != 1 << L or n_leaves % d or inputs[1].shape != (n_leaves, c):
        raise ValueError(
            f"{n_leaves} leaf rows (y0_leaf {tuple(inputs[1].shape)}) do not "
            f"split into whole subtrees of a depth-{L} tree over {d} ranks")
    nb = inputs[2].shape[0]
    if any(x.shape != (nb,) for x in inputs[3:]) or nb % d:
        raise ValueError(f"block lists of {[tuple(x.shape) for x in inputs[2:]]}"
                         f" do not split evenly over {d} ranks")
    return d


def _step_sharded(y_leaf, y0_leaf, a, b, q, alpha: float, L: int, dt):
    """The module docstring's four stages on row-sharded DTensors."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    d = _row_ranks((y_leaf, y0_leaf, a, b, q), L)
    s = d.bit_length() - 1
    mesh = y_leaf.device_mesh
    # one placement a mesh dimension, as lists: local_map reads a tuple as
    # one entry an output
    rows = [Shard(0)] * mesh.ndim
    whole = [Replicate()] * mesh.ndim
    partial = [Partial()] * mesh.ndim
    n_nodes, top = (1 << (L + 1)) - 1, (1 << s) - 1

    def contract(y_all, a, b, q):
        t = collect_up(y_all, L)
        c_block = q.to(dt)[:, None] * t.index_select(0, b)
        c_node = torch.zeros((n_nodes, t.shape[1]), dtype=dt,
                             device=t.device).index_add_(0, a, c_block)
        # levels s .. L regrouped by owner: (D, 2^(L - s + 1) - 1, C), rank
        # r's subtree in level-major order in row r
        low = torch.cat([c_node[(1 << lv) - 1:(2 << lv) - 1].reshape(
            d, 1 << (lv - s), -1) for lv in range(s, L + 1)], dim=1)
        return c_node[:top], low

    c_top, c_low = local_map(
        contract, out_placements=(partial, partial),
        in_placements=(whole, rows, rows, rows), device_mesh=mesh)(
        y_leaf.to(dt).redistribute(mesh, whole), a, b, q)
    c_low = c_low.redistribute(mesh, rows)
    c_top = c_top.redistribute(mesh, whole) if top else c_top

    def down(c_top, c_low, y0):
        own = c_low[0]
        if top:
            # the path sum above this rank's subtree root: its parent's
            coord = mesh.get_coordinate()
            r = sum(i * math.prod(mesh.shape[k + 1:])
                    for k, i in enumerate(coord))
            parent = _distribute_down(c_top, s - 1)[r >> 1]
            own = torch.cat([own[:1] + parent, own[1:]])
        acc = _distribute_down(own, L - s)
        return alpha * acc.to(y0.dtype) + (1.0 - alpha) * y0

    return local_map(down, out_placements=rows,
                     in_placements=(whole if top else partial, rows, rows),
                     device_mesh=mesh)(c_top, c_low, y0_leaf)


def label_propagate_distributed(y0_leaf, a, b, q, alpha: float, L: int,
                                n_iters: int) -> torch.Tensor:
    """``n_iters`` steps of :func:`lp_step_leaforder` from ``y0_leaf``
    (plain tensors, or row-sharded DTensors: then every step is the SPMD
    program and the result is laid out as ``y0_leaf``)."""
    y = y0_leaf
    for _ in range(int(n_iters)):
        y = lp_step_leaforder(y, y0_leaf, a, b, q, alpha, L)
    return y


def shard_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` as a DTensor on ``mesh``, its rows split over every mesh
    dimension, data-major (the reference's ``P(("data", "model"))``): each
    rank keeps its own rows of the full tensor it passes, no collective."""
    from torch.distributed.tensor import distribute_tensor, Shard

    return distribute_tensor(x, mesh, (Shard(0),) * mesh.ndim,
                             src_data_rank=None)


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
