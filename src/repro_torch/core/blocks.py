"""``repro_torch/core/blocks.py`` ↔ ``repro/core/blocks.py``.

Host numpy, copied from the reference; the only changes are reading tree
tensors back to the host (``_host``) and :func:`device_blocks`, which hands
the partition to the device.

Block partitions of the transition matrix over the shared partition tree.

A *block* ``(A, B)`` ties together all matrix entries ``P[i, j]`` with data
point ``x_i`` in subtree ``A`` and kernel ``m_j`` in subtree ``B`` (paper
§3.1).  A valid partition covers every off-diagonal entry exactly once; the
coarsest valid partition consists of both orderings of every sibling pair —
``|B_c| = 2(Np - 1)`` blocks (paper §4.4).

Bookkeeping (append/deactivate during refinement) is host-side numpy with
preallocated capacity; all numeric work (q-optimization, gains, matvec) runs
on padded device arrays masked by ``active``, so each capacity compiles once.
"""
from __future__ import annotations

import dataclasses

import numpy as np

import torch

from repro_torch.core.tree import PartitionTree, leaf_range, node_level

__all__ = ["BlockPartition", "coarsest_partition", "complete_forest",
           "densify_q", "device_blocks", "mirror_invariant_ok", "levels_of",
           "refresh_active", "validate_partition"]


def _host(t) -> np.ndarray:
    """A tree tensor (on any device) as a host numpy array."""
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@dataclasses.dataclass
class BlockPartition:
    """Flat block arrays with capacity ``cap`` and ``n`` live entries."""

    a: np.ndarray        # (cap,) int32 data-subtree node id
    b: np.ndarray        # (cap,) int32 kernel-subtree node id
    mirror: np.ndarray   # (cap,) int32 index of the (b, a) block
    active: np.ndarray   # (cap,) bool
    n: int               # high-water mark (slots [0, n) ever used)
    cap: int
    # which slots were split into their horizontal children: with it,
    # activity is a pure function of the tree's weights (a slot covers real
    # mass iff it is an unrefined forest leaf with both sides non-ghost)
    refined: np.ndarray = None

    def __post_init__(self):
        if self.refined is None:
            self.refined = np.zeros(self.cap, bool)

    @property
    def n_active(self) -> int:
        return int(self.active[: self.n].sum())

    def grow_to(self, new_cap: int) -> "BlockPartition":
        if new_cap <= self.cap:
            return self
        pad = new_cap - self.cap
        return BlockPartition(
            a=np.concatenate([self.a, np.zeros(pad, np.int32)]),
            b=np.concatenate([self.b, np.zeros(pad, np.int32)]),
            mirror=np.concatenate([self.mirror, np.full(pad, -1, np.int32)]),
            active=np.concatenate([self.active, np.zeros(pad, bool)]),
            n=self.n,
            cap=new_cap,
            refined=np.concatenate([self.refined, np.zeros(pad, bool)]),
        )

    def append_pairs(self, a_new: np.ndarray, b_new: np.ndarray,
                     mirror_new: np.ndarray,
                     active_new: np.ndarray | None = None) -> np.ndarray:
        """Append blocks; returns their indices.  Grows capacity if needed.

        ``active_new`` marks which appended blocks carry real mass right
        now (default: all).
        """
        k = len(a_new)
        if self.n + k > self.cap:
            grown = self.grow_to(max(self.cap * 2, self.n + k))
            self.__dict__.update(grown.__dict__)
        idx = np.arange(self.n, self.n + k)
        self.a[idx] = a_new
        self.b[idx] = b_new
        self.mirror[idx] = mirror_new
        self.active[idx] = True if active_new is None else active_new
        self.refined[idx] = False
        self.n += k
        return idx


def coarsest_partition(tree: PartitionTree, cap: int | None = None) -> BlockPartition:
    """Both orderings of every sibling pair: ``|B_c| = 2(Np - 1)`` blocks.

    Blocks whose data or kernel side is all-ghost (W == 0) are created
    inactive — they carry no probability mass and never refine.
    """
    n_int = tree.n_internal
    n0 = 2 * n_int
    cap = int(cap if cap is not None else max(2 * n0, 64))
    bp = BlockPartition(
        a=np.zeros(cap, np.int32),
        b=np.zeros(cap, np.int32),
        mirror=np.full(cap, -1, np.int32),
        active=np.zeros(cap, bool),
        n=n0,
        cap=cap,
    )
    k = np.arange(n_int, dtype=np.int32)
    bp.a[0:n0:2] = 2 * k + 1
    bp.b[0:n0:2] = 2 * k + 2
    bp.a[1:n0:2] = 2 * k + 2
    bp.b[1:n0:2] = 2 * k + 1
    bp.mirror[0:n0:2] = 2 * k + 1
    bp.mirror[1:n0:2] = 2 * k
    w = _host(tree.W)
    bp.active[:n0] = (w[bp.a[:n0]] > 0) & (w[bp.b[:n0]] > 0)
    return bp


def complete_forest(bp: BlockPartition) -> BlockPartition:
    """Copy ``bp`` with every refined slot's missing children restored.

    ``refine_topk`` drops a refined block's child when its kernel side is
    all-ghost: the child covers no real pair at fit time.  Streaming
    mutations can later put mass INTO such a subtree, so before any
    weight-driven coverage math (:func:`refresh_active`) the streaming layer
    appends the missing children here, inactive, with no mirror.  Always
    returns a fresh copy-on-write partition; on an already-complete forest
    the copy has nothing appended.
    """
    n = bp.n
    have = set(zip(bp.a[:n].tolist(), bp.b[:n].tolist()))
    miss_a, miss_b = [], []
    for i in np.flatnonzero(bp.refined[:n]):
        ai, bi = int(bp.a[i]), int(bp.b[i])
        for bc in (2 * bi + 1, 2 * bi + 2):
            if (ai, bc) not in have:
                miss_a.append(ai)
                miss_b.append(bc)
    out = BlockPartition(
        a=bp.a.copy(), b=bp.b.copy(), mirror=bp.mirror.copy(),
        active=bp.active.copy(), n=bp.n, cap=bp.cap,
        refined=bp.refined.copy())
    if miss_a:
        out.append_pairs(
            np.asarray(miss_a, np.int32), np.asarray(miss_b, np.int32),
            np.full(len(miss_a), -1, np.int32),
            active_new=np.zeros(len(miss_a), bool))
    return out


def refresh_active(bp: BlockPartition, W) -> np.ndarray:
    """Recompute ``active`` from per-node weights ``W`` (streaming updates).

    Requires a *complete* refinement forest (:func:`complete_forest`): the
    unrefined slots then tile every off-diagonal leaf pair exactly once, so
    ``active = ~refined & (W[a] > 0) & (W[b] > 0)`` is the unique correct
    coverage for any weight vector.  Returns the new (cap,) active array
    without mutating ``bp``.
    """
    W = _host(W)
    n = bp.n
    active = np.zeros(bp.cap, bool)
    active[:n] = (~bp.refined[:n]) & (W[bp.a[:n]] > 0) & (W[bp.b[:n]] > 0)
    return active


def validate_partition(bp: BlockPartition, tree: PartitionTree) -> bool:
    """Partition validity (paper §3.1), checked on real leaves:

    - every off-diagonal pair of *real* leaves is covered by exactly one
      active block (ghost leaves carry zero weight — their coverage is
      irrelevant since their mass is provably zero), and
    - no diagonal entry is ever covered (blocks have ``A ∩ B = ∅``).
    """
    real = _host(tree.w_leaf) > 0
    cover = np.zeros((tree.n_leaves, tree.n_leaves), dtype=np.int32)
    for i in range(bp.n):
        if not bp.active[i]:
            continue
        alo, ahi = leaf_range(int(bp.a[i]), tree.L)
        blo, bhi = leaf_range(int(bp.b[i]), tree.L)
        cover[alo:ahi, blo:bhi] += 1
    if np.any(np.diagonal(cover) != 0):
        return False
    rr = np.ix_(real, real)
    want = 1 - np.eye(int(real.sum()), dtype=np.int32)
    return bool(np.all(cover[rr] == want))


def densify_q(bp: BlockPartition, tree: PartitionTree, q: np.ndarray) -> np.ndarray:
    """Expand block parameters into the dense (N, N) matrix Q (tests only)."""
    n = tree.n_points
    slot = _host(tree.slot_of)
    dense = np.zeros((tree.n_leaves, tree.n_leaves), dtype=np.float64)
    for i in range(bp.n):
        if not bp.active[i]:
            continue
        alo, ahi = leaf_range(int(bp.a[i]), tree.L)
        blo, bhi = leaf_range(int(bp.b[i]), tree.L)
        dense[alo:ahi, blo:bhi] = q[i]
    out = np.zeros((n, n), dtype=np.float64)
    out[:, :] = dense[np.ix_(slot, slot)]
    np.fill_diagonal(out, 0.0)
    return out


def mirror_invariant_ok(bp: BlockPartition) -> bool:
    """Mirror indices must be mutual and swap (a, b)."""
    for i in range(bp.n):
        if not bp.active[i]:
            continue
        m = int(bp.mirror[i])
        if m < 0:
            continue
        if not bp.active[m]:
            return False
        if bp.mirror[m] != i or bp.a[m] != bp.b[i] or bp.b[m] != bp.a[i]:
            return False
    return True


def levels_of(bp: BlockPartition) -> np.ndarray:
    """Per-block (a-level, b-level) for diagnostics."""
    return np.stack([node_level(bp.a[: bp.n]), node_level(bp.b[: bp.n])], axis=1)


def device_blocks(bp: BlockPartition, device) -> tuple:
    """``(a, b, active)`` on ``device``: int64 node ids and the bool mask."""
    return (torch.as_tensor(bp.a, dtype=torch.int64, device=device),
            torch.as_tensor(bp.b, dtype=torch.int64, device=device),
            torch.as_tensor(bp.active, device=device))
