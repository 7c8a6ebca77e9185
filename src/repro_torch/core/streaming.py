"""``repro_torch/core/streaming.py`` ↔ ``repro/core/streaming.py``.

Online insert/delete on a fitted tree — the streaming VDT layer.

A point contributes only to the stats of its root-to-leaf ancestor path,
L + 1 = O(log N) nodes, so inserting or deleting k points is an O(k d log N)
bottom-up patch of ``W``/``S1``/``S2`` (and ``Sphi``/``Sg``/``Sgx`` for
non-default divergences), not a rebuild.  The q re-optimization after a
patch recomputes the divergences of the *touched* blocks only (a side's
stats changed, or the block's activation flipped) from host-side caches,
then recovers the global optimum through the d-free tail of the optimizer
(:func:`repro_torch.core.qopt.optimize_q_from_g`, on the model's device).
The result is the constrained optimum a full ``optimize_q`` returns, which
:func:`recompute` (the differential oracle) checks.

Copy-on-write epochs: mutations never modify the model they are called on.
Each returns a **new** :class:`~repro_torch.core.vdt.VariationalDualTree`
whose tensors are fresh host->device copies of the float64 host mirrors, so
a serving engine keeps dispatching queued work against the old epoch while
new submissions see the new one (``serving/_engine.py::publish``).  The
mirrors ride on the newest epoch only (``vdt._stream``); mutating an older
epoch rebuilds them.

* **Insert** claims zero-weight ghost leaf slots (``fit(capacity=...)``
  reserves headroom; deletes free slots), routing each point down the tree
  toward the nearest child centroid among children with free slots.  New
  points get row ids ``N..N+k-1``.  :class:`CapacityError` when no ghost
  slots remain.
* **Delete** subtracts the points' path contributions, zeroes their leaf
  slots and **compacts row ids** (survivors keep their relative order, as a
  fit on the surviving points would).  Emptied subtrees have their stats
  zeroed exactly, keyed off an integer real-leaf count per node.
* **Coverage repair**: activity is recomputed from the patched weights
  (:func:`repro_torch.core.blocks.refresh_active`).
* **Staleness**: touched blocks are marked stale; ``refine()`` on the new
  model spends its budget on them first.
* ``sigma`` is carried over unchanged.

Each :class:`StreamUpdate` also carries the mutation's host-clock seconds by
stage (``seconds``): the one-time mirror build, the host patch, the
host->device freeze of the new epoch's tensors, and ``optimize_q_from_g``.
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Optional

import numpy as np
import torch

from repro_torch.core import blocks as blocks_mod
from repro_torch.core import divergence as div_mod
from repro_torch.core import qopt as qopt_mod
from repro_torch.core.blocks import _host
from repro_torch.core.tree import PartitionTree
from repro_torch.core.vdt import VariationalDualTree

__all__ = [
    "CapacityError",
    "StreamUpdate",
    "delete_points",
    "insert_points",
    "recompute",
]


class CapacityError(ValueError):
    """An insert asked for more ghost leaf slots than the tree has free.

    Reserve headroom at fit time (``VariationalDualTree.fit(x,
    capacity=...)``) or free slots with :func:`delete_points`; growing the
    leaf level itself requires a refit (the tree's heap layout is static).
    """


@dataclasses.dataclass(frozen=True)
class StreamUpdate:
    """Result of one streaming mutation.

    ``vdt`` is the new epoch (copy-on-write: the input model is untouched).
    ``rows`` are the new row ids of inserted points, or the *old* row ids
    of deleted points.  ``row_map`` (deletes only) maps every old row id to
    its compacted new id, -1 for deleted rows.  ``touched_blocks`` counts
    blocks whose divergence was recomputed; ``stale_blocks`` is the total
    now awaiting refinement priority.  ``seconds``: see the module docstring.
    """

    vdt: VariationalDualTree
    rows: np.ndarray
    row_map: Optional[np.ndarray]
    patched_points: int
    touched_blocks: int
    stale_blocks: int
    seconds: dict = dataclasses.field(default_factory=dict)


# ===================================================== host mirror state
@dataclasses.dataclass
class _StreamState:
    """Mutable float64 host mirrors of one (newest-epoch) fitted model.

    ``cnt`` is the integer number of real leaves per node (exact emptiness,
    and the free-slot count that routes inserts); ``d2`` caches the block
    divergences of partition slots [0, n); ``stale`` marks slots awaiting
    refinement priority.
    """

    x_leaf: np.ndarray        # (Np, d) float64
    w_leaf: np.ndarray        # (Np,)  float64
    leaf_of: np.ndarray       # (Np,)  int64, ghosts -> n_points
    slot_of: np.ndarray       # (N,)   int64
    cnt: np.ndarray           # (n_nodes,) int64 real leaves per subtree
    W: np.ndarray             # (n_nodes,) float64
    S1: np.ndarray            # (n_nodes, d) float64
    S2: np.ndarray            # (n_nodes,) float64
    sphi: Optional[np.ndarray]  # (n_nodes,) float64, None for sqeuclidean
    sg: Optional[np.ndarray]    # (n_nodes, d)
    sgx: Optional[np.ndarray]   # (n_nodes,)
    d2: np.ndarray            # (cap,) float64 cached block divergences
    stale: np.ndarray         # (cap,) bool
    bp_n: int
    cap: int
    owner: "weakref.ref"      # the model these mirrors currently describe


def _node_sums_np(leaf_vals: np.ndarray) -> np.ndarray:
    """numpy twin of ``divergence._node_sums``: bottom-up heap-order sums."""
    vals = [leaf_vals]
    L = int(len(leaf_vals)).bit_length() - 1
    for _ in range(L):
        vals.append(vals[-1].reshape((-1, 2) + vals[-1].shape[1:]).sum(1))
    return np.concatenate(vals[::-1])


def _path_nodes(slots: np.ndarray, L: int) -> np.ndarray:
    """(k, L+1) heap ids of each leaf slot's root-to-leaf ancestor path."""
    slots = np.asarray(slots, np.int64)
    lv = np.arange(L + 1)
    return ((1 << lv)[None, :] - 1) + (slots[:, None] >> (L - lv)[None, :])


def _leaf_div_terms(div: div_mod.Divergence, x: np.ndarray, w: np.ndarray,
                    device):
    """Per-point (w*phi, w*grad, w*<grad, x>) terms, float64 host arrays.

    As ``divergence._compute_stats``: zero-weight points take the pad value
    before phi/grad, which run on a float32 tensor on ``device``.
    """
    x = np.asarray(x, np.float64)
    w = np.asarray(w, np.float64)
    xs = np.where((w > 0)[:, None], x, div.pad_value)
    xs32 = torch.as_tensor(xs.astype(np.float32), device=device)
    phi = _host(div.phi(xs32)).astype(np.float64)
    g = _host(div.grad_phi(xs32)).astype(np.float64)
    gx = (g * xs).sum(-1)
    return phi * w, g * w[:, None], gx * w


def _block_div_np(state: _StreamState, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Block divergences from the host mirrors (eq. 9 / its Bregman form)."""
    W, S1, S2 = state.W, state.S1, state.S2
    wa, wb = W[a], W[b]
    if state.sphi is None:  # sqeuclidean
        d = wa * S2[b] + wb * S2[a] - 2.0 * (S1[a] * S1[b]).sum(-1)
    else:
        d = (wb * state.sphi[a] - wa * state.sphi[b]
             - (S1[a] * state.sg[b]).sum(-1) + wa * state.sgx[b])
    return np.maximum(d, 0.0)


def _build_state(vdt: VariationalDualTree) -> _StreamState:
    """O(N d) one-time mirror build; amortized across later O(k d log N) ops."""
    tree = vdt.tree
    x_leaf = _host(tree.x_leaf).astype(np.float64)
    w_leaf = _host(tree.w_leaf).astype(np.float64)
    div = vdt.bound_divergence
    if div.name == "sqeuclidean":
        sphi = sg = sgx = None
    else:
        p, g, gx = _leaf_div_terms(div.div, x_leaf, w_leaf, vdt.device)
        sphi, sg, sgx = _node_sums_np(p), _node_sums_np(g), _node_sums_np(gx)
    bp = vdt.bp
    state = _StreamState(
        x_leaf=x_leaf,
        w_leaf=w_leaf,
        leaf_of=_host(tree.leaf_of).astype(np.int64),
        slot_of=_host(tree.slot_of).astype(np.int64),
        cnt=_node_sums_np((w_leaf > 0).astype(np.int64)),
        W=_node_sums_np(w_leaf),
        S1=_node_sums_np(x_leaf * w_leaf[:, None]),
        S2=_node_sums_np((x_leaf * x_leaf).sum(-1) * w_leaf),
        sphi=sphi,
        sg=sg,
        sgx=sgx,
        d2=np.zeros(bp.cap, np.float64),
        stale=np.zeros(bp.cap, bool),
        bp_n=bp.n,
        cap=bp.cap,
        owner=weakref.ref(vdt),
    )
    nb = bp.n
    state.d2[:nb] = _block_div_np(state, bp.a[:nb], bp.b[:nb])
    return state


def _ensure_state(vdt: VariationalDualTree, seconds: dict) -> _StreamState:
    state = vdt._stream
    t0 = time.perf_counter()
    if not (state is not None and state.owner() is vdt
            and state.bp_n == vdt.bp.n and state.cap == vdt.bp.cap):
        # first mutation on this model (or a branch off / post-refine
        # epoch): rebuild the mirrors from its immutable tensors
        state = _build_state(vdt)
    seconds["mirrors"] = time.perf_counter() - t0
    return state


# ========================================================= insert routing
def _route_insert(state: _StreamState, x_new: np.ndarray, L: int) -> np.ndarray:
    """Pick a free ghost leaf slot for each new point.

    Greedy descent: at each level go to the child with free leaf capacity
    whose centroid (S1/W) is nearest the point — empty subtrees sort last,
    ties prefer more free slots then the lower node id, so routing is
    deterministic.  O(d log Np) per point.
    """
    cnt, W, S1 = state.cnt, state.W, state.S1
    extra = {}  # node -> slots claimed by earlier points of this batch
    slots = np.empty(len(x_new), np.int64)
    for j, x in enumerate(np.asarray(x_new, np.float64)):
        node = 0
        for lvl in range(L):
            span = 1 << (L - lvl - 1)
            best = None
            for c in (2 * node + 1, 2 * node + 2):
                free = span - int(cnt[c]) - extra.get(c, 0)
                if free <= 0:
                    continue
                if W[c] > 0:
                    mu = S1[c] / W[c]
                    dist = float(((x - mu) ** 2).sum())
                else:
                    dist = np.inf
                key = (dist, -free, c)
                if best is None or key < best:
                    best = key
            node = best[2]
            extra[node] = extra.get(node, 0) + 1
        slots[j] = node - ((1 << L) - 1)
    return slots


# ============================================================== mutations
def insert_points(vdt: VariationalDualTree, x_new, weights=None) -> StreamUpdate:
    """Insert k points into a fitted model; returns the new epoch.

    O(k d log N) stat patching + O(touched d) divergence refresh + one
    d-free global q re-optimization — no refit.  New points take row ids
    ``N..N+k-1``.  Raises :class:`CapacityError` when fewer than k ghost
    leaf slots remain, and ``ValueError`` for shape/domain/weight problems.
    """
    t_start = time.perf_counter()
    tree = vdt.tree
    x_new = np.asarray(_host(x_new), np.float32)
    if x_new.ndim == 1:
        x_new = x_new[None, :]
    if x_new.ndim != 2 or x_new.shape[1] != tree.dim:
        raise ValueError(
            f"insert_points wants (k, {tree.dim}) points, got {x_new.shape}")
    k = x_new.shape[0]
    if k == 0:
        raise ValueError("insert_points: empty point set")
    bound = vdt.bound_divergence
    bound.div.validate_domain(x_new)
    if weights is None:
        w_new = np.ones(k, np.float64)
    else:
        w_new = np.asarray(_host(weights), np.float64).reshape(-1)
        if w_new.shape != (k,) or np.any(w_new <= 0) or not np.all(np.isfinite(w_new)):
            raise ValueError(
                f"weights must be {k} strictly positive finite values")

    seconds: dict = {}
    state = _ensure_state(vdt, seconds)
    L, Np, n = tree.L, tree.n_leaves, tree.n_points
    free_total = Np - int(state.cnt[0])
    if k > free_total:
        raise CapacityError(
            f"insert of {k} points exceeds the tree's {free_total} free leaf "
            f"slots; refit with capacity >= {n + k} "
            f"(VariationalDualTree.fit(x, capacity=...)) or delete points "
            f"first")

    slots = _route_insert(state, x_new, L)
    rows = n + np.arange(k, dtype=np.int64)

    x64 = np.asarray(x_new, np.float64)
    state.x_leaf[slots] = x64
    state.w_leaf[slots] = w_new
    state.leaf_of[slots] = rows
    state.slot_of = np.concatenate([state.slot_of, slots])

    # bottom-up path patch: each point touches exactly its L+1 ancestors
    flat = _path_nodes(slots, L).ravel()
    rep = L + 1
    np.add.at(state.W, flat, np.repeat(w_new, rep))
    np.add.at(state.S1, flat, np.repeat(x64 * w_new[:, None], rep, axis=0))
    np.add.at(state.S2, flat, np.repeat((x64 * x64).sum(-1) * w_new, rep))
    np.add.at(state.cnt, flat, 1)
    if state.sphi is not None:
        p, g, gx = _leaf_div_terms(bound.div, x64, w_new, vdt.device)
        np.add.at(state.sphi, flat, np.repeat(p, rep))
        np.add.at(state.sg, flat, np.repeat(g, rep, axis=0))
        np.add.at(state.sgx, flat, np.repeat(gx, rep))

    dirty_nodes = np.zeros(tree.n_nodes, bool)
    dirty_nodes[flat] = True
    return _commit(vdt, state, dirty_nodes, rows=rows, row_map=None,
                   new_n=n + k, patched=k, seconds=seconds, t_start=t_start)


def delete_points(vdt: VariationalDualTree, rows) -> StreamUpdate:
    """Delete points by row id; returns the new epoch.

    Same O(k d log N) patch structure as :func:`insert_points`, run in
    reverse; freed leaf slots become insertion headroom.  Row ids are
    **compacted**: surviving rows keep their relative order (``row_map`` on
    the returned update maps old ids to new).  Deleting every point is an
    error — a model must keep at least one point.
    """
    t_start = time.perf_counter()
    tree = vdt.tree
    rows = np.unique(np.asarray(_host(rows), np.int64).reshape(-1))
    n = tree.n_points
    if rows.size == 0:
        raise ValueError("delete_points: empty row set")
    if rows[0] < 0 or rows[-1] >= n:
        raise ValueError(
            f"row ids must lie in [0, {n}), got range "
            f"[{rows[0]}, {rows[-1]}]")
    if rows.size >= n:
        raise ValueError(
            "cannot delete every point: the model must keep at least one")

    seconds: dict = {}
    state = _ensure_state(vdt, seconds)
    L = tree.L
    slots = state.slot_of[rows]
    x_del = state.x_leaf[slots].copy()
    w_del = state.w_leaf[slots].copy()

    flat = _path_nodes(slots, L).ravel()
    rep = L + 1
    np.add.at(state.W, flat, np.repeat(-w_del, rep))
    np.add.at(state.S1, flat, np.repeat(-x_del * w_del[:, None], rep, axis=0))
    np.add.at(state.S2, flat, np.repeat(-(x_del * x_del).sum(-1) * w_del, rep))
    np.add.at(state.cnt, flat, -1)
    if state.sphi is not None:
        p, g, gx = _leaf_div_terms(vdt.bound_divergence.div, x_del, w_del,
                                   vdt.device)
        np.add.at(state.sphi, flat, np.repeat(-p, rep))
        np.add.at(state.sg, flat, np.repeat(-g, rep, axis=0))
        np.add.at(state.sgx, flat, np.repeat(-gx, rep))

    # freed slots are ghosts again (insertion headroom)
    state.x_leaf[slots] = 0.0
    state.w_leaf[slots] = 0.0

    # exact-zero emptied subtrees: integer emptiness, no float residue
    touched = np.unique(flat)
    emptied = touched[state.cnt[touched] == 0]
    state.W[emptied] = 0.0
    state.S1[emptied] = 0.0
    state.S2[emptied] = 0.0
    if state.sphi is not None:
        state.sphi[emptied] = 0.0
        state.sg[emptied] = 0.0
        state.sgx[emptied] = 0.0

    # compact row ids: survivors keep their relative order, so the row
    # ordering matches a from-scratch fit on the surviving point set
    keep = np.ones(n, bool)
    keep[rows] = False
    new_n = n - rows.size
    old_to_new = np.full(n + 1, new_n, np.int64)  # deleted + ghosts -> new_n
    old_to_new[np.flatnonzero(keep)] = np.arange(new_n)
    state.leaf_of = old_to_new[np.minimum(state.leaf_of, n)]
    state.slot_of = state.slot_of[keep]
    row_map = old_to_new[:n].copy()
    row_map[rows] = -1

    dirty_nodes = np.zeros(tree.n_nodes, bool)
    dirty_nodes[flat] = True
    return _commit(vdt, state, dirty_nodes, rows=rows, row_map=row_map,
                   new_n=new_n, patched=int(rows.size), seconds=seconds,
                   t_start=t_start)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _on(device, a: np.ndarray, dtype: np.dtype) -> torch.Tensor:
    """A host mirror as a tensor of ``dtype`` on ``device`` (a fresh copy)."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)


def _commit(vdt: VariationalDualTree, state: _StreamState,
            dirty_nodes: np.ndarray, *, rows, row_map, new_n: int,
            patched: int, seconds: dict, t_start: float) -> StreamUpdate:
    """Freeze the patched mirrors into a new copy-on-write epoch."""
    dev = vdt.device
    t0 = time.perf_counter()
    old_tree = vdt.tree
    tree = PartitionTree(
        L=old_tree.L,
        n_points=new_n,
        dim=old_tree.dim,
        x_leaf=_on(dev, state.x_leaf, np.float32),
        w_leaf=_on(dev, state.w_leaf, np.float32),
        slot_of=_on(dev, state.slot_of, np.int64),
        leaf_of=_on(dev, state.leaf_of, np.int64),
        W=_on(dev, state.W, np.float32),
        S1=_on(dev, state.S1, np.float32),
        S2=_on(dev, state.S2, np.float32),
    )
    old_bound = vdt.bound_divergence
    if state.sphi is None:
        bound = div_mod.bind_divergence(old_bound.div, tree)
    else:
        stats = div_mod.DivStats(
            sphi=_on(dev, state.sphi, np.float32),
            sg=_on(dev, state.sg, np.float32),
            sgx=_on(dev, state.sgx, np.float32),
        )
        bound = div_mod.BoundDivergence(
            div=old_bound.div, stats=stats, _tree_ref=weakref.ref(tree))
        div_mod.adopt_bound(tree, bound)
    _sync(dev)
    seconds["freeze"] = time.perf_counter() - t0

    # copy-on-write partition: restore the refinement children the fit
    # dropped as all-ghost (first mutation only; later epochs are already
    # complete), then refresh coverage from the patched weights
    old_bp = vdt.bp
    bp = blocks_mod.complete_forest(old_bp)
    active = blocks_mod.refresh_active(bp, state.W)
    bp.active = active
    if bp.cap > state.d2.size:
        pad = bp.cap - state.d2.size
        state.d2 = np.concatenate([state.d2, np.zeros(pad)])
        state.stale = np.concatenate([state.stale, np.zeros(pad, bool)])

    # touched blocks: a side's stats were patched, or activation flipped
    # (slots appended by forest completion had no prior activity)
    nb = bp.n
    old_active = np.zeros(nb, bool)
    old_active[: old_bp.n] = old_bp.active[: old_bp.n]
    dirty_blk = ((dirty_nodes[bp.a[:nb]] | dirty_nodes[bp.b[:nb]]
                  | (active[:nb] != old_active))
                 & active[:nb])
    idx = np.flatnonzero(dirty_blk)
    if idx.size:
        state.d2[idx] = _block_div_np(state, bp.a[idx], bp.b[idx])

    # d-free log_g over the whole partition from the cached divergences
    wa, wb = state.W[bp.a[:nb]], state.W[bp.b[:nb]]
    ok = active[:nb] & (wa > 0) & (wb > 0)
    sig = float(vdt.sigma)
    denom = np.where(ok, 2.0 * sig * sig * wa * wb, 1.0)
    log_g = np.full(bp.cap, -np.inf, np.float32)
    log_g[:nb] = np.where(ok, -state.d2[:nb] / denom, -np.inf).astype(np.float32)
    t1 = time.perf_counter()
    a_d, b_d, active_d = blocks_mod.device_blocks(bp, dev)
    qs = qopt_mod.optimize_q_from_g(
        tree, a_d, b_d, active_d, vdt.sigma, _on(dev, log_g, np.float32),
        divergence=bound)
    bound_value = float(qs.bound)
    seconds["qopt"] = time.perf_counter() - t1

    # staleness: touched blocks get refinement priority on the new model
    state.stale[idx] = True
    state.stale[:nb] &= active[:nb]
    stale_blocks = int(state.stale[:nb].sum())
    state.bp_n, state.cap = bp.n, bp.cap

    new_stats = dataclasses.replace(
        vdt.stats, n_blocks=bp.n_active, bound=bound_value)
    new_vdt = VariationalDualTree(
        tree=tree, bp=bp, qstate=qs, sigma=vdt.sigma, stats=new_stats,
        divergence=bound)
    state.owner = weakref.ref(new_vdt)
    new_vdt._stream = state
    seconds["patch"] = (time.perf_counter() - t_start - seconds["mirrors"]
                        - seconds["freeze"] - seconds["qopt"])
    return StreamUpdate(vdt=new_vdt, rows=np.asarray(rows), row_map=row_map,
                        patched_points=patched, touched_blocks=int(idx.size),
                        stale_blocks=stale_blocks, seconds=seconds)


# ============================================================== reference
def recompute(vdt: VariationalDualTree) -> VariationalDualTree:
    """Reference refit of the SAME structure: the differential oracle.

    Rebuilds every subtree statistic from the model's leaf tensors (on its
    device), rebinds the divergence stats from scratch, refreshes block
    activity, and runs the full (non-incremental) q optimization at the
    model's sigma over the same tree and block partition.  An incrementally
    mutated model must agree with ``recompute(model)`` to tight tolerance.
    """
    old = vdt.tree
    w = old.w_leaf
    W = div_mod._node_sums(w, old.L)
    S1 = div_mod._node_sums(old.x_leaf * w[:, None], old.L)
    S2 = div_mod._node_sums((old.x_leaf * old.x_leaf).sum(-1) * w, old.L)
    tree = dataclasses.replace(old, W=W, S1=S1, S2=S2)
    bound = div_mod.bind_divergence(vdt.bound_divergence.div, tree)
    old_bp = vdt.bp
    active = blocks_mod.refresh_active(old_bp, W)
    bp = blocks_mod.BlockPartition(
        a=old_bp.a.copy(), b=old_bp.b.copy(), mirror=old_bp.mirror.copy(),
        active=active, n=old_bp.n, cap=old_bp.cap,
        refined=old_bp.refined.copy())
    qs = qopt_mod.optimize_q(tree, *blocks_mod.device_blocks(bp, vdt.device),
                             vdt.sigma, divergence=bound)
    stats = dataclasses.replace(
        vdt.stats, n_blocks=bp.n_active, bound=float(qs.bound))
    return VariationalDualTree(tree=tree, bp=bp, qstate=qs, sigma=vdt.sigma,
                               stats=stats, divergence=bound)
