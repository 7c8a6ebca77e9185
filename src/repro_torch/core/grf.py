"""``repro_torch/core/grf.py`` ↔ ``repro/core/grf.py``.

GRF backend: an unbiased Monte-Carlo estimate of the transition matrix's
action by terminating random walks (graph random features).  Every node
launches ``n_walkers`` walks over a sparse CSR neighbor table, and the
load-weighted walker mean

    est[i, :] = (1/m) * sum_w load_t[i, w] * Y[pos_t[i, w], :]

is an unbiased estimate of ``(P^t @ Y)[i, :]`` (see
``kernels/grf/walkers.py``).  A step costs O(N m), whatever the edge count;
the relative error of an m-walker mean scales as ``1/sqrt(m)``, so
``m ~ 1/rtol^2`` walkers buy a target tolerance (:func:`walkers_for_rtol`).

Label propagation composes from walk prefixes.  Unrolling eq. 15,

    Y_T = sum_{t<T} (1-a) a^t P^t Y_0  +  a^T P^T Y_0,

so one walk set of horizon T estimates every term: the step-t walker
population estimates ``P^t Y_0``, weighted by ``(1-a) a^t`` (``a^T`` for the
last term).  :func:`grf_label_propagate` streams this in a Python loop over
steps: advance the walkers, reduce them with the feature product (K5,
``kernels/grf/csrc/grf_feature.cu``, one launch per step on the card), add
the coefficient-weighted result; O(N m) memory, no walk history.
Per-column coefficients make heterogeneous alphas exact in one call.

Graphs come natively sparse through :meth:`CSRGraph.from_csr` (the workload
this backend exists for, e.g. the §5 kNN graph of ``core/baselines.py``), or
bridged from the point cloud through :meth:`CSRGraph.from_points`, which
materializes the dense eq.-3 matrix once (O(N^2): validation sizes, and what
makes GRF testable against the exact backend).

Walks draw their uniforms from ``draw(t)`` (default: a ``torch.Generator``
on the graph's device, seeded with ``seed``; see ``kernels/grf/walkers.py``).
The CPU and CUDA generators give different walks for one seed, and neither
reproduces the reference's threefry streams; the drivers pass ``draw``
through so that a test can replay the reference's uniforms.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import matvec as matvec_mod
from repro_torch.kernels.grf.ops import grf_feature_matvec
from repro_torch.kernels.grf.walkers import (Draw, default_draw, start_state,
                                             walk_step)
from repro_torch.kernels.grf.walkers import sample_walks as _sample_walks

__all__ = ["CSRGraph", "DEFAULT_N_WALKERS", "MAX_RTOL_WALKERS",
           "grf_label_propagate", "grf_transition_action", "sample_walks",
           "walkers_for_rtol"]

# default walker budget: relative error ~ 1/sqrt(64) = 12.5% per step estimate
DEFAULT_N_WALKERS = 64

# cap on rtol-derived budgets: 1/rtol^2 explodes as rtol -> 0, and a request
# wanting that much accuracy should use "exact"/"vdt" instead
MAX_RTOL_WALKERS = 4096

# divergences whose kernel rows need the dual tree's subtree statistics at
# every visited node, which a walker does not carry
_POSITIVE_DOMAIN = ("kl", "itakura_saito")


def walkers_for_rtol(rtol: float) -> int:
    """Walker budget for a target relative tolerance: ``ceil(1 / rtol^2)``.

    The m-walker mean's relative standard error is ``O(1)/sqrt(m)``, so
    ``m = 1/rtol^2`` puts one standard error at ``rtol``.  Clamped to
    ``[1, MAX_RTOL_WALKERS]``.
    """
    rtol = float(rtol)
    if not (rtol > 0.0):
        raise ValueError(f"rtol must be > 0, got {rtol}")
    return max(1, min(MAX_RTOL_WALKERS, math.ceil(1.0 / (rtol * rtol))))


def _check_divergence(divergence) -> None:
    from repro_torch.core.divergence import resolve_divergence

    div = resolve_divergence(divergence)  # unported ones raise here first
    if div.name in _POSITIVE_DOMAIN:
        raise ValueError(
            f"backend='grf' does not support divergence {div.name!r}: "
            f"positive-domain Bregman kernels (kl, itakura_saito) need the "
            f"dual-tree subtree-stats factorization at every visited node, "
            f"which a random walker does not carry; use backend='vdt' or "
            f"'exact'")


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """A row-stochastic sparse transition matrix in padded device layout.

    ``nbr[i, k]``/``prob[i, k]`` are node i's k-th neighbor and its transition
    probability for ``k < deg[i]``; padding slots hold neighbor 0 with
    probability 0.  Rows are normalized to sum to 1 at construction.  The
    tensors live on one device, chosen at construction (``None`` is
    ``cuda``).
    """

    nbr: torch.Tensor    # (N, max_deg) int32 padded neighbor table
    prob: torch.Tensor   # (N, max_deg) float32 transition probs, padding 0
    deg: torch.Tensor    # (N,) int32 true neighbor counts
    n: int
    nnz: int

    @property
    def device(self) -> torch.device:
        return self.nbr.device

    @property
    def max_deg(self) -> int:
        return int(self.nbr.shape[1])

    @property
    def density(self) -> float:
        """Edge fraction ``nnz / N^2``, the ``route_backend`` signal."""
        return self.nnz / float(self.n * self.n)

    @classmethod
    def from_csr(cls, indptr, indices, weights=None,
                 device=None) -> "CSRGraph":
        """Build from CSR neighbor lists; weights default to uniform.

        Validates on the host what a random walk needs: monotone ``indptr``,
        in-range ``indices``, at least one outgoing edge per row, and
        non-negative finite ``weights`` with positive row sums.
        """
        dev = resolve_device(device)
        indptr = _host(indptr, np.int64)
        indices = _host(indices, np.int64)
        if indptr.ndim != 1 or indptr.size < 2:
            raise ValueError(f"indptr must be (N+1,), got {indptr.shape}")
        n = indptr.size - 1
        deg = np.diff(indptr)
        if indptr[0] != 0 or indptr[-1] != indices.size or (deg < 0).any():
            raise ValueError("indptr must be monotone from 0 to len(indices)")
        if (deg < 1).any():
            rows = np.nonzero(deg < 1)[0][:5].tolist()
            raise ValueError(
                f"every node needs >= 1 outgoing edge for a random walk; "
                f"rows {rows} have none")
        if indices.size and (indices.min() < 0 or indices.max() >= n):
            raise ValueError(f"indices must lie in [0, {n}), got range "
                             f"[{indices.min()}, {indices.max()}]")
        if weights is None:
            weights = np.ones(indices.size, np.float64)
        else:
            weights = _host(weights, np.float64)
            if weights.shape != indices.shape:
                raise ValueError(
                    f"weights shape {weights.shape} != indices "
                    f"shape {indices.shape}")
            if not np.isfinite(weights).all() or (weights < 0).any():
                raise ValueError("weights must be finite and >= 0")
        max_deg = int(deg.max())
        mask = np.arange(max_deg)[None, :] < deg[:, None]   # (N, max_deg)
        nbr = np.zeros((n, max_deg), np.int32)
        nbr[mask] = indices                      # CSR order is row-major
        w = np.zeros((n, max_deg), np.float64)
        w[mask] = weights
        row_sum = w.sum(axis=1)
        if (row_sum <= 0).any():
            rows = np.nonzero(row_sum <= 0)[0][:5].tolist()
            raise ValueError(
                f"rows {rows} have zero total weight — no transition "
                f"distribution to walk")
        prob = (w / row_sum[:, None]).astype(np.float32)
        return cls(nbr=torch.as_tensor(nbr, device=dev),
                   prob=torch.as_tensor(prob, device=dev),
                   deg=torch.as_tensor(deg.astype(np.int32), device=dev),
                   n=n, nnz=int(deg.sum()))

    @classmethod
    def from_dense(cls, p, atol: float = 0.0, device=None) -> "CSRGraph":
        """Sparsify a dense transition matrix (entries ``> atol`` kept)."""
        p = _host(p, np.float64)
        if p.ndim != 2 or p.shape[0] != p.shape[1]:
            raise ValueError(f"p must be square (N, N), got {p.shape}")
        keep = p > atol
        rows, cols = np.nonzero(keep)
        indptr = np.zeros(p.shape[0] + 1, np.int64)
        np.cumsum(np.bincount(rows, minlength=p.shape[0]), out=indptr[1:])
        return cls.from_csr(indptr, cols, p[rows, cols], device=device)

    @classmethod
    def from_points(cls, x, sigma, divergence=None,
                    device=None) -> "CSRGraph":
        """The dense eq.-3 kernel graph of a point cloud.

        Materializes the row-softmax transition matrix once on ``device``
        (O(N^2): validation and analysis sizes), so GRF estimates converge to
        exactly the matrix the ``"exact"`` backend walks.
        """
        from repro_torch.kernels.fused_lp.ref import dense_transition_ref

        _check_divergence(divergence)
        dev = resolve_device(device)
        x = torch.as_tensor(x).to(device=dev, dtype=torch.float32)
        p = dense_transition_ref(x, float(sigma))
        return cls.from_dense(p, device=dev)

    def dense_p(self) -> np.ndarray:
        """Scatter back to the dense ``(N, N)`` matrix, the test oracle."""
        deg = self.deg.cpu().numpy()
        mask = np.arange(self.max_deg)[None, :] < deg[:, None]
        p = np.zeros((self.n, self.n), np.float32)
        rows = np.broadcast_to(np.arange(self.n)[:, None], mask.shape)[mask]
        np.add.at(p, (rows, self.nbr.cpu().numpy()[mask]),
                  self.prob.cpu().numpy()[mask])
        return p


def _host(a, dtype) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


def sample_walks(graph: CSRGraph, *, n_steps: int, n_walkers: int,
                 seed: int = 0, p_halt: float = 0.0,
                 draw: Optional[Draw] = None):
    """Walk histories for ``graph``: ``(pos, load)``, ``(N, m, T+1)`` each."""
    return _sample_walks(graph.nbr, graph.prob, graph.deg,
                         n_steps=int(n_steps), n_walkers=int(n_walkers),
                         seed=int(seed), p_halt=float(p_halt), draw=draw)


def grf_transition_action(graph: CSRGraph, y, *, t: int,
                          n_walkers: int = DEFAULT_N_WALKERS, seed: int = 0,
                          p_halt: float = 0.0, return_samples: bool = False,
                          impl: Optional[str] = None,
                          draw: Optional[Draw] = None):
    """Unbiased MC estimate of ``P^t @ Y`` without materializing P.

    ``y`` is ``(N,)`` or ``(N, C)``; the estimate matches its shape.  With
    ``return_samples=True`` also returns the per-walker contributions
    ``(N, m, C)``, whose walker-axis mean is the estimate.  ``impl`` selects
    the feature reduction (``None``: K5 on the card, its plain version on the
    CPU; ``"ref"``: the gather-and-mean oracle).
    """
    y = torch.as_tensor(y, device=graph.device).to(torch.float32)
    squeeze = y.ndim == 1
    y2 = (y[:, None] if squeeze else y).contiguous()
    pos, load = sample_walks(graph, n_steps=int(t), n_walkers=n_walkers,
                             seed=seed, p_halt=p_halt, draw=draw)
    pos_t = pos[:, :, int(t)].contiguous()
    load_t = load[:, :, int(t)].contiguous()
    est = grf_feature_matvec(pos_t, load_t, y2, impl=impl)
    est = est[:, 0] if squeeze else est
    if return_samples:
        samples = y2[pos_t] * load_t[..., None]
        return est, (samples[:, :, 0] if squeeze else samples)
    return est


def grf_label_propagate(graph: CSRGraph, y0, alpha=0.01, n_iters: int = 500,
                        *, n_walkers: int = DEFAULT_N_WALKERS, seed: int = 0,
                        p_halt: float = 0.0, impl: Optional[str] = None,
                        draw: Optional[Draw] = None) -> torch.Tensor:
    """Eq.-15 label propagation estimated from one streamed walk set.

    ``y0`` is ``(N,)``, ``(N, C)`` or ``(batch, N, C)``; ``alpha`` a scalar,
    per-column ``(C,)`` (2-D) or per-request ``(batch,)`` (3-D).  A batch
    folds into the column axis and shares one walk set (walks do not depend
    on labels), so ``out[b]`` equals request b's solo call bit for bit.
    Deterministic per ``(seed, shapes)`` on a given device.
    """
    y0 = torch.as_tensor(y0, device=graph.device)
    if not y0.is_floating_point():
        y0 = y0.to(torch.float32)
    if int(n_iters) < 0:
        raise ValueError(f"n_iters must be >= 0, got {n_iters}")
    if y0.ndim == 3:
        batch, _, c = y0.shape
        alpha = torch.as_tensor(alpha, dtype=torch.float32)
        if alpha.ndim == 1:
            if alpha.shape[0] != batch:
                raise ValueError(
                    f"per-request alpha wants shape ({batch},), "
                    f"got {tuple(alpha.shape)}")
            # folded column b*C + ch belongs to request b (see fold_batch)
            alpha = alpha.repeat_interleave(c)
        out = grf_label_propagate(
            graph, matvec_mod.fold_batch(y0), alpha=alpha, n_iters=n_iters,
            n_walkers=n_walkers, seed=seed, p_halt=p_halt, impl=impl,
            draw=draw)
        return matvec_mod.unfold_batch(out, batch, c)
    squeeze = y0.ndim == 1
    if squeeze:
        y0 = y0[:, None]
    alpha = torch.as_tensor(alpha, dtype=torch.float32)
    if alpha.ndim == 1 and alpha.shape[0] != y0.shape[1]:
        raise ValueError(
            f"per-column alpha wants shape ({y0.shape[1]},), "
            f"got {tuple(alpha.shape)}")
    alpha_cols = alpha.reshape(-1).expand(y0.shape[1]).tolist()
    out = _lp_streamed(graph, y0.to(torch.float32).contiguous(), alpha_cols,
                       int(n_iters), int(n_walkers), float(p_halt), impl,
                       draw if draw is not None else
                       default_draw(seed, graph.n * int(n_walkers),
                                    graph.device))
    return out[:, 0] if squeeze else out


def _series_coefficients(alpha_cols: list, t_steps: int,
                         device) -> torch.Tensor:
    """(T+1, K) eq.-15 unroll weights: ``(1-a) a^t`` for t < T, ``a^T`` at T.

    Computed per distinct alpha in float64 on the host, so equal alphas get
    equal bits in every column, whatever the column count.
    """
    table = {}
    for a in set(alpha_cols):
        table[a] = [(1.0 - a) * a ** t for t in range(t_steps)] + [a ** t_steps]
    coeff = np.array([table[a] for a in alpha_cols], np.float64).T
    return torch.as_tensor(coeff.astype(np.float32), device=device)


def _lp_streamed(graph: CSRGraph, y0: torch.Tensor, alpha_cols: list,
                 t_steps: int, n_walkers: int, p_halt: float, impl,
                 draw: Draw) -> torch.Tensor:
    """Advance the walkers and add the series-weighted features, step by step.

    State is O(N m + N K): the walkers and the running estimate.  Step t's
    uniforms are ``draw(t)``, t = 1..T, the same numbering as
    ``sample_walks``, so the two consume the same walks.
    """
    n = y0.shape[0]
    coeff = _series_coefficients(alpha_cols, t_steps, y0.device)
    acc = coeff[0][None, :] * y0  # t = 0 features are exactly y0 (load 1)
    if t_steps == 0:
        return acc
    pos, load, alive = start_state(n, n_walkers, y0.device)
    for t in range(1, t_steps + 1):
        pos, load, alive = walk_step(graph.nbr, graph.prob, graph.deg, pos,
                                     load, alive, draw(t), p_halt)
        feat = grf_feature_matvec(pos.view(n, n_walkers),
                                  load.view(n, n_walkers), y0, impl=impl)
        acc = acc + coeff[t][None, :] * feat
    return acc
