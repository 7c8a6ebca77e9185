"""``repro_torch/serving/_sharded.py`` ↔ ``repro/serving/_sharded.py``.

Sharded serving engine: the same scheduler, the eq.-15 walk decomposed over
row stripes.

:class:`ShardedPropagateEngine` subclasses
:class:`~repro_torch.serving.PropagateEngine` and overrides exactly the two
device-math hooks (``_scan`` / ``_scan_resume``), so the entire scheduler —
queue disciplines, width/batch bucketing, segmented EDF preemption, epoch
pinning, refcounted retirement, metrics — is inherited verbatim and every
dispatch runs one body per shard of a 1-D mesh instead.

The mesh (``distributed/sharding.py::leaf_mesh`` / ``leaf_sharding``)
----------------------------------------------------------------------
As in the reference, one process drives every shard (the reference runs one
``shard_map`` program over a ``jax.sharding.Mesh``).  A shard's body runs on
its own device; an all-gather concatenates the shards' tensors on each
shard's device.  Leaf-order arrays — the scattered label stack
``(n_leaves, K)`` and the ghost-leaf mask — are row stripes, one per shard;
the block lists ``a``/``b``, the q weights and the per-column alpha row are
replicated, one copy per device.  A device may hold several shards: then the
decomposition runs for real, bit for bit, but it is not a speed-up.

Sharding is invisible in the output
-----------------------------------
* **VDT backend** — a power-of-two shard count D = 2^k makes every shard own
  one aligned depth-(L-k) subtree of the perfect partition tree.  CollectUp
  runs locally per subtree (the identical pairwise sums), ONE all-gather
  shares the per-shard partial trees, and the top k levels are summed from
  the gathered subtree roots — again the identical pairwise adds.  The
  per-block contraction ``c = q * T[b]`` + segment-sum (``index_add_``) is
  computed replicated, and DistributeDown walks the replicated top-k prefix
  then slices into the shard's own subtree.  Every float add happens in the
  same order as the single-device walk, so on the CPU the result is the
  single engine's bit for bit; on the card ``index_add_`` reduces with
  atomics here, while the single engine sums each node's blocks in a fixed
  order (``kernels/block_combine``), so there the two agree within
  tolerance.
* **Exact backend** — rows of the streamed transition matrix are
  independent, so each shard runs K1 (``kernels/fused_lp/ops.py::
  folded_step``) over its own row stripe against the full column set (one
  all-gather of the folded carry per iteration).  The stripes follow the
  reference: the rows padded to its 256-row tile, ``R = ref_padded_columns
  (N)``, cut into D stripes of ``R / D``, each clipped at N (a stripe past
  N is empty and launches nothing).  The stripe's global row offset rides
  into the kernel as ``row_base``, so the self-transition diagonal masks the
  same entries as in the whole-matrix launch, and K1 is passed the whole
  matrix's column count, which fixes each row's online-softmax order.  K1
  computes each row on its own (the split pass's hi/lo and bias per row, no
  atomics), so a stripe's rows equal the whole launch's bit for bit.  The
  plain-torch version that CPU tensors run does not: its matrix products'
  bits depend on the row tile's shape, so on the CPU each stripe is padded
  to the whole matrix's row tiles (``fused_lp.PLAIN_BLOCK_M``) with the
  tile's other rows, whose outputs are dropped — the reference's local
  padding to its row tile.  A stripe launch splits the whole column set
  again (``ops._split_pair`` shares a split only when the rows are the
  columns): D split passes per iteration where the single engine runs one.

The resume form is the same walk entered from a carry, so segmented EDF
preemption keeps the carry guarantee (pause/resume is bit-identical to never
pausing) across the mesh.  A one-point model's exact walk also carries the
reference's padded rows (``ops.fused_lp_scan_folded_resume``): it has one
row and nothing to stripe, so it runs the single engine's scan.  The grf
walker backend is not served: its kernel graph is dense and does not shard
along leaves.
"""
from __future__ import annotations

import torch

from repro_torch.core.matvec import (_distribute_down, collect_up,
                                     fold_batch, unfold_batch)
from repro_torch.distributed.sharding import leaf_mesh, leaf_sharding
from repro_torch.kernels.fused_lp import folded_step
from repro_torch.kernels.fused_lp.batched import alpha_row
from repro_torch.kernels.fused_lp.fused_lp import (PLAIN_BLOCK_M,
                                                   ref_padded_columns)
from repro_torch.kernels.fused_lp.ops import _points
from repro_torch.serving._engine import PropagateEngine

__all__ = ["ShardedPropagateEngine"]

# the reference's row tile: stripes are cut from the rows padded to it, so
# at most this many shards each get a row
_BLOCK = 256


def _sharded_matvec(y_sh: torch.Tensor, t_all: list, a, b, q, *, L: int,
                    K: int, d: int) -> torch.Tensor:
    """Shard ``d``'s stripe of (QY): the top levels from the gathered local
    trees, replicated block contraction, subtree DistributeDown.

    ``t_all`` holds every shard's local tree (``collect_up`` of its stripe
    to depth ``L - K``), all-gathered to this shard's device; ``K =
    log2(D)``.  Levels ``0..K`` are computed replicated, the rest are the
    shards' own.
    """
    if K == 0:
        t_full = t_all[0]
    else:
        t_stack = torch.stack(t_all)                # (D, 2 * Nl - 1, C)
        # subtree roots are the full tree's level-K nodes; summing them up
        # reproduces levels 0..K with the same pairwise adds
        parts = [collect_up(t_stack[:, 0, :], K)]   # (2D - 1, C)
        for j in range(1, L - K + 1):
            lo, hi = (1 << j) - 1, (1 << (j + 1)) - 1
            parts.append(t_stack[:, lo:hi, :].reshape(-1, y_sh.shape[1]))
        t_full = torch.cat(parts, dim=0)            # (n_nodes, C) level-major
    c_block = q[:, None] * t_full.index_select(0, b)
    c_node = torch.zeros_like(t_full).index_add_(0, a, c_block)
    # DistributeDown: replicated down to level K, then into our subtree
    acc = _distribute_down(c_node[:(2 << K) - 1], K)[d:d + 1]
    for lvl in range(K, L):
        lo, hi = (1 << (lvl + 1)) - 1, (1 << (lvl + 2)) - 1
        width = 1 << (lvl + 1 - K)
        mine = c_node[lo:hi, :][d * width:(d + 1) * width]
        acc = acc.repeat_interleave(2, dim=0) + mine
    return acc


def _stripe_step(rows, cols, y, y0, al, inv: float, row_base: int, tile):
    """One eq.-15 step of the stripe ``rows`` (global ids ``row_base ..``).

    ``rows`` is ``cols[row_base:row_base + M]``.  Card tensors launch K1 on
    the stripe.  CPU tensors run the plain version on the whole matrix's
    row tiles that overlap the stripe, taken from ``cols``; only the
    stripe's rows are kept.
    """
    if rows.device.type == "cuda":
        return folded_step(rows, cols, y, y0, al, inv, row_base=row_base,
                           tile=tile)
    n = cols.shape[0]
    r1 = row_base + rows.shape[0]
    out = []
    t0 = (row_base // PLAIN_BLOCK_M) * PLAIN_BLOCK_M
    while t0 < r1:
        t1 = min(t0 + PLAIN_BLOCK_M, n)
        a, b = max(t0, row_base), min(t1, r1)
        y0_tile = y0.new_zeros((t1 - t0, y0.shape[1]))
        y0_tile[a - t0:b - t0] = y0[a - row_base:b - row_base]
        step = folded_step(cols[t0:t1], cols, y, y0_tile, al, inv,
                           row_base=t0, tile=tile)
        out.append(step[a - t0:b - t0])
        t0 = t1
    return torch.cat(out, dim=0)


class ShardedPropagateEngine(PropagateEngine):
    """:class:`~repro_torch.serving.PropagateEngine` over a mesh of shards.

    Same constructor surface as the single-device engine plus ``devices``
    (default: every visible CUDA device; a power-of-two count, at most 256,
    repeats allowed).  The grf walker backend is not served, so
    ``capabilities()`` reports ``{"publish", "sharded"}`` (plus
    ``"preempt"`` under the EDF/segmented configuration) and grf submits are
    rejected at the call site.
    """

    def __init__(self, vdt, *, devices=None, **kwargs):
        if kwargs.get("backend") == "grf":
            raise ValueError(
                "ShardedPropagateEngine does not serve backend='grf' "
                "(the walker estimator's kernel graph does not shard "
                "along leaves); use PropagateEngine")
        self._mesh = leaf_mesh(devices)
        self._layout = leaf_sharding(self._mesh)
        self.n_devices = self._mesh.size
        if self.n_devices > _BLOCK:
            raise ValueError(
                f"ShardedPropagateEngine supports at most {_BLOCK} shards "
                f"(row-striping granularity of the exact backend), got "
                f"{self.n_devices}")
        self._K = self.n_devices.bit_length() - 1
        # per-epoch shard buffers keyed id(vdt) — the epoch record pins the
        # tree, and _retire_locked() drops our entry with it
        self._buf_cache: dict[int, dict] = {}
        self._check_model(vdt)
        super().__init__(vdt, **kwargs)

    # ----------------------------------------------------- introspection
    def capabilities(self) -> frozenset[str]:
        """Publish/preempt as configured, ``"sharded"``, never ``"grf"``."""
        return (super().capabilities() - {"grf"}) | {"sharded"}

    # --------------------------------------------------------- lifecycle
    def _check_model(self, vdt) -> None:
        n_leaves = int(vdt.tree.n_leaves)
        if self.n_devices > n_leaves:
            raise ValueError(
                f"cannot shard a {n_leaves}-leaf tree over "
                f"{self.n_devices} shards: each shard must own at least "
                f"one leaf")

    def publish(self, model, *, patched_points: int = 0,
                stale_blocks: int = 0) -> int:
        """Epoch swap with the inherited atomicity contract; the new tree
        must still divide over the mesh."""
        self._check_model(model)
        return super().publish(model, patched_points=patched_points,
                               stale_blocks=stale_blocks)

    def _retire_locked(self) -> None:
        super()._retire_locked()
        live = {id(ep.vdt) for ep in self._epochs.values()}
        live.add(id(self.vdt))
        # a copy of the keys: the scheduler thread may be adding an entry
        for key in list(self._buf_cache):
            if key not in live:
                self._buf_cache.pop(key, None)

    # --------------------------------------------------- per-epoch buffers
    def _replicate(self, t: torch.Tensor) -> dict:
        """One copy of ``t`` per device of the mesh."""
        return {dev: t.to(dev) for dev in self._mesh.distinct_devices}

    def _buffers(self, vdt) -> dict:
        buf = self._buf_cache.get(id(vdt))
        if buf is None:
            a, b, _, q, mask = vdt._dispatch_buffers()
            tree = vdt.tree
            buf = {"L": int(tree.L), "n_leaves": int(tree.n_leaves),
                   "slot_of": tree.slot_of, "a": self._replicate(a),
                   "b": self._replicate(b), "q": self._replicate(q),
                   "mask": self._layout.scatter(mask)}
            self._buf_cache[id(vdt)] = buf
        return buf

    def _exact_buffers(self, vdt) -> dict:
        buf = self._buffers(vdt)
        if "cols" not in buf:
            # the single engine's path passes the same divergence
            # (``VariationalDualTree.label_propagate_resume``)
            x, tile = _points(vdt.x_rows, vdt.bound_divergence.div)
            n = int(x.shape[0])
            # the stripes of the rows padded to the reference's row tile,
            # clipped at n: the reference's row layout
            stripes = [(min(lo, n), min(hi, n)) for lo, hi in
                       self._layout.stripes(ref_padded_columns(n))]
            cols = self._replicate(x)
            buf.update(
                cols=cols, n=n, tile=tile, stripes=stripes,
                rows=[cols[dev][lo:hi] for (lo, hi), dev in
                      zip(stripes, self._mesh.devices)],
                inv=float(1.0 / (2.0 * float(vdt.sigma) * float(vdt.sigma))))
        return buf

    # ------------------------------------------------------ sharded walks
    def _vdt_walk(self, buf: dict, ys: list, y0s: list, alpha: dict,
                  n_iters: int) -> list:
        """``n_iters`` VDT steps of every shard's leaf stripe."""
        L, K, devs = buf["L"], self._K, self._mesh.devices
        for _ in range(int(n_iters)):
            t_loc = [collect_up(y, L - K) for y in ys]       # local trees
            gathered = {dev: [t.to(dev) for t in t_loc]      # one all-gather
                        for dev in self._mesh.distinct_devices}
            ys = [buf["mask"][d] * (alpha[dev] * _sharded_matvec(
                      ys[d], gathered[dev], buf["a"][dev], buf["b"][dev],
                      buf["q"][dev], L=L, K=K, d=d))
                  + (1.0 - alpha[dev]) * y0s[d]
                  for d, dev in enumerate(devs)]
        return ys

    def _exact_walk(self, buf: dict, ys: list, y0s: list, alpha: dict,
                    n_iters: int) -> list:
        """``n_iters`` exact steps: every shard runs K1 on its row stripe
        against the gathered carry."""
        for _ in range(int(n_iters)):
            full = {dev: self._layout.gather(ys, dev)          # all-gather
                    for dev in self._mesh.distinct_devices}
            ys = [y if lo == hi else _stripe_step(
                      rows, buf["cols"][dev], full[dev], y0, alpha[dev],
                      buf["inv"], lo, buf["tile"])
                  for y, y0, rows, (lo, hi), dev in zip(
                      ys, y0s, buf["rows"], buf["stripes"],
                      self._mesh.devices)]
        return ys

    # ------------------------------------------------- device-math hooks
    @staticmethod
    def _fold(stack, alphas):
        y = stack.to(torch.float32)
        bb, _, cb = y.shape
        alpha = torch.as_tensor(alphas, dtype=torch.float32).reshape(-1)
        return fold_batch(y), alpha.repeat_interleave(cb), bb, cb

    def _walk(self, vdt, carry, y0, alpha, n_iters: int, backend: str):
        """The sharded walk from the folded carry ``(N, K)``; returns it."""
        if backend == "vdt":
            buf = self._buffers(vdt)
            slot_of, n_leaves = buf["slot_of"], buf["n_leaves"]

            def to_leaves(y):
                y_leaf = y.new_zeros((n_leaves, y.shape[1]))
                y_leaf[slot_of] = y
                return self._layout.scatter(y_leaf)

            al = self._replicate(alpha.to(vdt.device))
            out = self._vdt_walk(buf, to_leaves(carry), to_leaves(y0), al,
                                 n_iters)
            return self._layout.gather(out, vdt.device)[slot_of]
        buf = self._exact_buffers(vdt)
        al = self._replicate(alpha_row(alpha, carry.shape[1], vdt.device))
        ys, y0s = ([y[lo:hi].contiguous().to(dev) for (lo, hi), dev in
                    zip(buf["stripes"], self._mesh.devices)]
                   for y in (carry, y0))
        out = self._exact_walk(buf, ys, y0s, al, n_iters)
        return self._layout.gather(out, vdt.device)

    def _scan(self, vdt, stack, alphas, n_iters: int, backend: str, *,
              n_walkers=None):
        return self._scan_resume(vdt, stack, stack, alphas, n_iters, backend)

    def _scan_resume(self, vdt, carry, y0, alphas, n_iters, backend: str):
        if backend == "grf":
            raise ValueError(
                "ShardedPropagateEngine does not serve backend='grf'")
        if backend == "exact" and int(vdt.tree.n_points) == 1:
            # one row, nothing to stripe: the single engine's scan carries
            # the reference's padded rows
            return super()._scan_resume(vdt, carry, y0, alphas, n_iters,
                                        backend)
        yc, alpha, bb, cb = self._fold(carry, alphas)
        ys, _, _, _ = self._fold(y0, alphas)
        out = self._walk(vdt, yc, ys, alpha, n_iters, backend)
        return unfold_batch(out, bb, cb)
