"""``repro_torch/core/vdt.py`` ↔ ``repro/core/vdt.py``.

Public API: the Variational Dual-Tree transition-matrix approximation.

    vdt = VariationalDualTree.fit(x, max_blocks=4 * n)      # on the card
    y_hat = vdt.matvec(y)                   # O(|B|) Q @ y
    y_lp  = vdt.label_propagate(y0)         # label propagation (eq. 15)
    y_ex  = vdt.label_propagate(y0, backend="exact")   # the exact eq.-3 walk
    y_mc  = vdt.label_propagate(y0, backend="grf")     # random-walk estimate

Pipeline (paper §3-§4): build the shared partition tree -> coarsest block
partition (|B| = 2(Np-1)) -> alternate q-optimization (eq. 7) with bandwidth
learning (eq. 12) -> greedy symmetric refinement to the block budget
(eq. 19) -> O(|B|) inference (Algorithm 1).  ``fit`` runs on ``cuda`` unless
``device="cpu"`` is passed; every later call runs on the model's device.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import blocks as blocks_mod
from repro_torch.core import matvec as matvec_mod
from repro_torch.core import qopt as qopt_mod
from repro_torch.core import refine as refine_mod
from repro_torch.core import sigma as sigma_mod
from repro_torch.core.divergence import resolve_divergence
from repro_torch.core.label_prop import (lp_scan_fused_resume,
                                         lp_scan_leaforder_resume)
from repro_torch.core.tree import PartitionTree, build_tree

__all__ = ["VariationalDualTree", "VdtStats"]


@dataclasses.dataclass
class VdtStats:
    build_tree_s: float = 0.0
    init_qopt_s: float = 0.0
    refine_s: float = 0.0
    sigma_iters: int = 0
    n_blocks: int = 0
    bound: float = 0.0
    sigma: float = 0.0
    divergence: str = "sqeuclidean"


def _sync(device: torch.device) -> None:
    """Wait for the device, so that host clocks time finished work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class VariationalDualTree:
    tree: PartitionTree
    bp: blocks_mod.BlockPartition
    qstate: qopt_mod.QState
    sigma: torch.Tensor
    stats: VdtStats
    # (a, b, active, q, leaf_mask) on the device, built lazily and reused
    # across calls; q never changes between refinements
    _serve_cache: Optional[tuple] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    # points in original row order (the exact backend reads them)
    _x_rows_cache: Optional[torch.Tensor] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    # the dense eq.-3 graph the grf backend walks, built at first use
    _grf_cache: Optional[object] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    # ------------------------------------------------------------------ fit
    @classmethod
    def fit(cls, x, weights=None, max_blocks: Optional[int] = None,
            sigma: Optional[float] = None, learn_sigma: bool = True,
            refine_batch: int = 64, sigma_iters: int = 10,
            power_iters: int = 8, divergence="sqeuclidean",
            capacity: Optional[int] = None,
            device=None) -> "VariationalDualTree":
        """Build tree + coarsest partition, fit sigma/q, refine to budget.

        ``device`` defaults to ``cuda`` and raises without a card; pass
        ``device="cpu"`` to fit on the CPU.  Only the ``sqeuclidean``
        divergence is ported (``None`` means it too).
        """
        div = resolve_divergence(divergence)
        dev = resolve_device(device)
        stats = VdtStats(divergence=div.name)
        x = torch.as_tensor(x).to(device=dev, dtype=torch.float32)
        if weights is not None:
            weights = torch.as_tensor(weights).to(device=dev,
                                                  dtype=torch.float32)

        t0 = time.perf_counter()
        tree = build_tree(x, weights, power_iters=power_iters,
                          capacity=capacity)
        _sync(dev)
        stats.build_tree_s = time.perf_counter() - t0

        cap = max_blocks if max_blocks else 2 * tree.n_internal
        bp = blocks_mod.coarsest_partition(tree, cap=int(2.5 * cap))

        t0 = time.perf_counter()
        sig = (torch.as_tensor(sigma, dtype=torch.float32, device=dev)
               if sigma is not None else sigma_mod.sigma_init(x, weights))
        blocks = blocks_mod.device_blocks(bp, dev)
        if learn_sigma and sigma is None:
            sig, qs, its = sigma_mod.fit_sigma_q(tree, *blocks, sig,
                                                 max_iters=sigma_iters)
            stats.sigma_iters = its
        else:
            qs = qopt_mod.optimize_q(tree, *blocks, sig)
        _sync(dev)
        stats.init_qopt_s = time.perf_counter() - t0

        if max_blocks and max_blocks > bp.n_active:
            t0 = time.perf_counter()
            qs, sig = refine_mod.refine_to_budget(
                bp, tree, sig, max_blocks, batch=refine_batch,
                refit_sigma=learn_sigma)
            _sync(dev)
            stats.refine_s = time.perf_counter() - t0

        stats.n_blocks = bp.n_active
        stats.bound = float(qs.bound)
        stats.sigma = float(sig)
        return cls(tree=tree, bp=bp, qstate=qs, sigma=sig, stats=stats)

    # ------------------------------------------------------------- inference
    @property
    def device(self) -> torch.device:
        return self.tree.device

    def to(self, device) -> "VariationalDualTree":
        """A copy of the fitted model with its tensors on ``device``."""
        dev = resolve_device(device)
        return VariationalDualTree(
            tree=self.tree.to(dev), bp=copy.deepcopy(self.bp),
            qstate=qopt_mod.QState(*(t.to(dev) for t in self.qstate)),
            sigma=self.sigma.to(dev), stats=copy.copy(self.stats))

    def _dispatch_buffers(self) -> tuple:
        """(a, b, active, q, leaf_mask) on the device, cached across calls.

        ``leaf_mask`` (Np, 1) is 1.0 exactly at leaf slots holding a real
        row; ``q`` is ``exp(log_q)`` from :func:`~matvec.prepare_q`.
        Invalidated by :meth:`refine`.
        """
        if self._serve_cache is None:
            a, b, active = blocks_mod.device_blocks(self.bp, self.device)
            q = matvec_mod.prepare_q(active, self.qstate.log_q)
            mask = torch.zeros((self.tree.n_leaves, 1), dtype=torch.float32,
                               device=self.device)
            mask[self.tree.slot_of, 0] = 1.0
            self._serve_cache = (a, b, active, q, mask)
        return self._serve_cache

    @property
    def x_rows(self) -> torch.Tensor:
        """The fitted points in original row order, (N, d), cached."""
        if self._x_rows_cache is None:
            self._x_rows_cache = self.tree.x_leaf[self.tree.slot_of].contiguous()
        return self._x_rows_cache

    def _as_labels(self, y) -> torch.Tensor:
        return torch.as_tensor(y, device=self.device).to(torch.float32)

    def matvec(self, y) -> torch.Tensor:
        """Q @ y in O(|B| + N) (Algorithm 1); y is (N,), (N, C) or (batch, N, C)."""
        a, b, active, _, _ = self._dispatch_buffers()
        return matvec_mod.mpt_matvec(self.tree, a, b, active,
                                     self.qstate.log_q, self._as_labels(y))

    def matvec_batched(self, ys) -> torch.Tensor:
        """Explicit batched multi-RHS: (batch, N, C) -> (batch, N, C)."""
        a, b, active, _, _ = self._dispatch_buffers()
        return matvec_mod.mpt_matvec_batched(self.tree, a, b, active,
                                             self.qstate.log_q,
                                             self._as_labels(ys))

    def _fold_request_alpha(self, alpha, batch: int, c: int) -> torch.Tensor:
        alpha = torch.as_tensor(alpha, dtype=torch.float32, device=self.device)
        if alpha.ndim == 1:
            if alpha.shape[0] != batch:
                raise ValueError(f"per-request alpha wants shape ({batch},), "
                                 f"got {tuple(alpha.shape)}")
            # folded column b*C + ch belongs to request b (see fold_batch)
            alpha = alpha.repeat_interleave(c)
        return alpha

    def _to_leaves(self, y: torch.Tensor) -> torch.Tensor:
        y_leaf = torch.zeros((self.tree.n_leaves, y.shape[1]), dtype=y.dtype,
                             device=self.device)
        y_leaf[self.tree.slot_of] = y
        return y_leaf

    @staticmethod
    def _check_backend(backend: str, batched, y0: torch.Tensor) -> None:
        if backend not in ("vdt", "exact", "grf"):
            raise ValueError(
                f"backend must be 'vdt', 'exact' or 'grf', got {backend!r}")
        if batched and y0.ndim != 3:
            raise ValueError("batched label_propagate wants (batch, N, C), "
                             f"got {tuple(y0.shape)}")

    def grf_graph(self):
        """The CSR transition graph the GRF backend walks, cached.

        Bridged from the fitted points through the dense eq.-3 matrix
        (``core.grf.CSRGraph.from_points``, O(N^2): validation sizes), on the
        model's device, so GRF estimates are unbiased for exactly the matrix
        the ``"exact"`` backend walks.
        """
        from repro_torch.core import grf as grf_mod

        if self._grf_cache is None:
            self._grf_cache = grf_mod.CSRGraph.from_points(
                self.x_rows, float(self.sigma), divergence=self.stats.divergence,
                device=self.device)
        return self._grf_cache

    def label_propagate(self, y0, alpha=0.01, n_iters: int = 500,
                        batched: Optional[bool] = None,
                        backend: str = "vdt",
                        n_walkers: Optional[int] = None,
                        seed: int = 0) -> torch.Tensor:
        """Label propagation (eq. 15) from seed labels ``y0``.

        ``y0`` is (N,), (N, C) or a stacked (batch, N, C); ``alpha`` a
        scalar, per-column ``(C,)`` (2-D ``y0``) or per-request ``(batch,)``
        (3-D ``y0``).  ``backend="vdt"`` walks the fitted O(|B|)
        approximation Q in leaf order; ``backend="exact"`` walks the exact
        eq.-3 matrix P through the fused K1 kernel, never materializing P;
        ``backend="grf"`` estimates the exact walk without bias from
        ``n_walkers`` random walks per point over :meth:`grf_graph`
        (default ``core.grf.DEFAULT_N_WALKERS``; relative error
        ~ ``1/sqrt(n_walkers)``), one K5 launch per iteration, deterministic
        per ``seed`` on a given device.  ``n_walkers`` and ``seed`` are read
        by ``grf`` only.
        """
        if backend == "grf":
            from repro_torch.core import grf as grf_mod

            y0 = self._as_labels(y0)
            self._check_backend(backend, batched, y0)
            return grf_mod.grf_label_propagate(
                self.grf_graph(), y0, alpha=alpha, n_iters=int(n_iters),
                n_walkers=int(n_walkers or grf_mod.DEFAULT_N_WALKERS),
                seed=int(seed))
        return self.label_propagate_resume(y0, y0, alpha, n_iters, batched,
                                           backend)

    def label_propagate_resume(self, y, y0, alpha=0.01, n_iters: int = 500,
                               batched: Optional[bool] = None,
                               backend: str = "vdt") -> torch.Tensor:
        """Continue an eq.-15 walk for ``n_iters`` more steps from carry ``y``.

        ``y`` is the output of an earlier propagation from the same seed
        ``y0`` and has its shape; the continued walk equals the monolithic
        one bit for bit on a given device.  Arguments as
        :meth:`label_propagate`.
        """
        y0, y = self._as_labels(y0), self._as_labels(y)
        if y.shape != y0.shape:
            raise ValueError(f"carry shape {tuple(y.shape)} must match seed "
                             f"shape {tuple(y0.shape)}")
        if backend == "grf":
            # the estimate is a weighted sum over walk prefixes, not a
            # fixed-point iteration: a carry is not its whole state
            raise ValueError(
                "backend='grf' does not support segmented resume; "
                "grf scans dispatch monolithically")
        self._check_backend(backend, batched, y0)
        if backend == "exact":
            return lp_scan_fused_resume(self.x_rows, y, y0, float(self.sigma),
                                        alpha, int(n_iters))
        if y0.ndim == 3:
            batch, _, c = y0.shape
            out = self.label_propagate_resume(
                matvec_mod.fold_batch(y), matvec_mod.fold_batch(y0),
                alpha=self._fold_request_alpha(alpha, batch, c),
                n_iters=n_iters)
            return matvec_mod.unfold_batch(out, batch, c)

        squeeze = y0.ndim == 1
        if squeeze:
            y, y0 = y[:, None], y0[:, None]
        a, b, _, q, mask = self._dispatch_buffers()
        alpha = torch.as_tensor(alpha, dtype=y0.dtype, device=self.device)
        # ghost slots are zero in the seed and, by the re-masking invariant,
        # in any carry, so scattering the carry reproduces the walk's state
        out_leaf = lp_scan_leaforder_resume(
            self._to_leaves(y), self._to_leaves(y0), mask, a, b, q, alpha,
            self.tree.L, int(n_iters))
        out = out_leaf[self.tree.slot_of]
        return out[:, 0] if squeeze else out

    # ------------------------------------------------------------ streaming
    def insert_points(self, x_new, weights=None):
        raise NotImplementedError(
            "streaming insert is not ported to repro_torch yet "
            "(ROADMAP Queue 1 item 8)")

    def delete_points(self, rows):
        raise NotImplementedError(
            "streaming delete is not ported to repro_torch yet "
            "(ROADMAP Queue 1 item 8)")

    # ------------------------------------------------------------ utilities
    def refine(self, max_blocks: int, batch: int = 64) -> None:
        """Refine further to ``max_blocks`` active blocks, in place."""
        self.qstate, self.sigma = refine_mod.refine_to_budget(
            self.bp, self.tree, self.sigma, max_blocks, batch=batch)
        self._serve_cache = None  # a/b/q/active all changed
        self.stats.n_blocks = self.bp.n_active
        self.stats.bound = float(self.qstate.bound)

    def _check_finite_q(self) -> None:
        """Refuse a model whose variational state is not finite."""
        bound = float(self.qstate.bound)
        if not np.isfinite(bound):
            raise ValueError(f"non-finite variational state (bound={bound})")

    def dense_q(self) -> np.ndarray:
        """Dense (N, N) Q — small-N tests only."""
        self._check_finite_q()
        log_q = self.qstate.log_q
        q = torch.where(torch.isfinite(log_q), torch.exp(log_q), 0.0)
        return blocks_mod.densify_q(self.bp, self.tree, q.cpu().numpy())

    def lower_bound(self, log_q=None) -> torch.Tensor:
        """l(D) for ``log_q`` (default: the fitted q)."""
        self._check_finite_q()
        a, b, active, _, _ = self._dispatch_buffers()
        lq = (self.qstate.log_q if log_q is None
              else torch.as_tensor(log_q, device=self.device))
        return qopt_mod.lower_bound(self.tree, a, b, active, lq, self.sigma)

    @property
    def n_blocks(self) -> int:
        return self.bp.n_active

    @property
    def bound(self) -> float:
        return float(self.qstate.bound)
