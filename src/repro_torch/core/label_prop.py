"""``repro_torch/core/label_prop.py`` ↔ ``repro/core/label_prop.py``.

Label propagation (Zhou et al., 2003) on a transition-matrix backend:

    Y^{t+1} = alpha * P Y^t + (1 - alpha) * Y^0        (paper eq. 15)

* :func:`label_propagate` — generic, takes any matvec closure;
* :func:`lp_scan_leaforder` — the VDT walk, entirely in leaf order, with a
  scalar or per-column ``alpha``;
* :func:`lp_scan_fused` — the same walk against the EXACT transition matrix
  (eq. 3), one K1 kernel launch per iteration (``kernels/fused_lp``);
* :func:`route_backend` — the ``"auto"`` routing rule between the ``vdt``,
  ``exact`` and ``grf`` backends.

Each scan has a ``*_resume`` twin that enters from a mid-walk carry and a
``*_segmented`` driver that splits ``n_iters`` into checkpointed segments.
Eq. 15 is a pure fixed-point iteration, and the resume runs the very same
per-step code, so a segmented walk equals the monolithic one bit for bit
on a given device.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.matvec import mpt_matvec_leaforder

__all__ = ["AUTO_EXACT_MAX_N", "AUTO_GRF_MAX_DENSITY", "AUTO_GRF_MIN_RTOL",
           "CONCRETE_BACKENDS", "ccr", "label_propagate", "lp_scan_fused", "lp_scan_fused_resume",
           "lp_scan_fused_segmented", "lp_scan_leaforder",
           "lp_scan_leaforder_resume", "lp_scan_leaforder_segmented",
           "one_hot_labels", "route_backend"]

# backend="auto" routes to the exact eq.-3 scan at or below this many points
# (inclusive: n == 1024 is exact, n == 1025 is vdt); callers with another
# exact-kernel budget override it per call (route_backend(auto_exact_max_n=))
AUTO_EXACT_MAX_N = 1024

# backend="auto" considers the GRF walker estimator only when both hold
# (boundaries inclusive): the graph's edge fraction nnz/N^2 is at most
# AUTO_GRF_MAX_DENSITY, and the request's relative tolerance is at least
# AUTO_GRF_MIN_RTOL (an m-walker mean's relative error is ~1/sqrt(m), and
# rtol below 5% would need m > 400).  No stated density or rtol, no grf.
AUTO_GRF_MAX_DENSITY = 0.05
AUTO_GRF_MIN_RTOL = 0.05

# the concrete scans every routing tag resolves to
CONCRETE_BACKENDS = ("vdt", "exact", "grf")


def route_backend(requested, default: str = "vdt", *, n=None,
                  density=None, rtol=None,
                  auto_exact_max_n: int = AUTO_EXACT_MAX_N) -> str:
    """Resolve a backend tag to a concrete scan implementation.

    ``requested`` is ``None`` (use ``default``), a concrete tag (``"vdt"``,
    ``"exact"``, ``"grf"``) or ``"auto"``, which resolves in order:

    1. ``"grf"`` iff ``density <= AUTO_GRF_MAX_DENSITY`` and
       ``rtol >= AUTO_GRF_MIN_RTOL`` (a ``None`` for either disqualifies it);
    2. else ``"exact"`` iff ``n <= auto_exact_max_n``;
    3. else ``"vdt"``.

    Returns a member of :data:`CONCRETE_BACKENDS`; raises ``ValueError`` on
    anything else.
    """
    if requested is None:
        requested = default
    if requested == "auto":
        if (density is not None and rtol is not None
                and float(density) <= AUTO_GRF_MAX_DENSITY
                and float(rtol) >= AUTO_GRF_MIN_RTOL):
            return "grf"
        if n is None:
            raise ValueError("backend='auto' routing needs the problem size n")
        return "exact" if int(n) <= int(auto_exact_max_n) else "vdt"
    if requested not in CONCRETE_BACKENDS:
        raise ValueError(
            f"backend must be one of {CONCRETE_BACKENDS}, 'auto' or None, "
            f"got {requested!r}")
    return requested


def one_hot_labels(labels: np.ndarray, labeled_mask: np.ndarray,
                   n_classes: int, device=None) -> torch.Tensor:
    """Y0: one-hot rows for labeled points, zero rows otherwise."""
    dev = resolve_device(device)
    y0 = torch.nn.functional.one_hot(
        torch.as_tensor(np.asarray(labels), dtype=torch.int64, device=dev),
        n_classes).to(torch.float32)
    mask = torch.as_tensor(np.asarray(labeled_mask), dtype=torch.float32,
                           device=dev)
    return y0 * mask[:, None]


def label_propagate(matvec: Callable[[torch.Tensor], torch.Tensor],
                    y0: torch.Tensor, alpha: float = 0.01,
                    n_iters: int = 500) -> torch.Tensor:
    """Run eq. 15 for ``n_iters`` steps; returns the final label matrix."""
    y = y0
    for _ in range(int(n_iters)):
        y = alpha * matvec(y) + (1.0 - alpha) * y0
    return y


def lp_scan_leaforder_resume(y_leaf: torch.Tensor, y0_leaf: torch.Tensor,
                             leaf_mask: torch.Tensor, a: torch.Tensor,
                             b: torch.Tensor, q: torch.Tensor,
                             alpha: torch.Tensor, L: int,
                             n_iters: int) -> torch.Tensor:
    """``n_iters`` VDT eq.-15 steps in leaf order from the carry ``y_leaf``.

    Ghost leaves receive meaningless DistributeDown path sums, so the matvec
    term is re-masked by ``leaf_mask`` (Np, 1) every iteration; ghost rows
    of the seed are zero, so they stay zero.
    """
    y = y_leaf
    for _ in range(int(n_iters)):
        y = leaf_mask * (alpha * mpt_matvec_leaforder(y, a, b, q, L)) \
            + (1.0 - alpha) * y0_leaf
    return y


def lp_scan_leaforder(y0_leaf: torch.Tensor, leaf_mask: torch.Tensor,
                      a: torch.Tensor, b: torch.Tensor, q: torch.Tensor,
                      alpha: torch.Tensor, L: int,
                      n_iters: int) -> torch.Tensor:
    """Eq. 15 for ``n_iters`` steps entirely in leaf order; returns (Np, K)."""
    return lp_scan_leaforder_resume(y0_leaf, y0_leaf, leaf_mask, a, b, q,
                                    alpha, L, n_iters)


def lp_scan_leaforder_segmented(y0_leaf, leaf_mask, a, b, q, alpha, L: int,
                                n_iters: int,
                                segment_iters: int) -> torch.Tensor:
    """Eq. 15 as ``ceil(n_iters / segment_iters)`` resumed segments."""
    if segment_iters < 1:
        raise ValueError(f"segment_iters must be >= 1, got {segment_iters}")
    y, done = y0_leaf, 0
    while done < n_iters:
        k = min(int(segment_iters), int(n_iters) - done)
        y = lp_scan_leaforder_resume(y, y0_leaf, leaf_mask, a, b, q, alpha,
                                     L, k)
        done += k
    return y


def _check_request_alpha(alpha, batch: int) -> None:
    al = torch.as_tensor(alpha)
    if al.ndim == 1 and al.shape[0] != batch:
        raise ValueError(f"per-request alpha wants shape ({batch},), "
                         f"got {tuple(al.shape)}")


def lp_scan_fused_resume(x: torch.Tensor, y: torch.Tensor, y0: torch.Tensor,
                         sigma: float, alpha=0.01, n_iters: int = 500,
                         divergence=None) -> torch.Tensor:
    """``n_iters`` exact eq.-15 steps from the carry ``y`` (shape of ``y0``).

    ``y0`` is (N,), (N, C) or (batch, N, C); ``alpha`` a scalar, per-column
    ``(C,)`` (2-D ``y0``) or per-request ``(batch,)`` (3-D ``y0``).
    ``divergence`` (a name, ``Divergence`` or ``BoundDivergence``) selects
    the tile of the exact matrix, ``exp(-d(x_i, x_j) / 2 sigma^2)``.
    """
    from repro_torch.core.divergence import resolve_divergence
    from repro_torch.kernels.fused_lp import (fused_lp_scan_batched_resume,
                                              fused_lp_scan_folded_resume)

    y0 = torch.as_tensor(y0, device=x.device).to(torch.float32)
    y = torch.as_tensor(y, device=x.device).to(torch.float32)
    if y.shape != y0.shape:
        raise ValueError(f"carry shape {tuple(y.shape)} must match seed "
                         f"shape {tuple(y0.shape)}")
    sigma = float(sigma)
    divergence = resolve_divergence(divergence)
    if y0.ndim == 3:
        _check_request_alpha(alpha, y0.shape[0])
        return fused_lp_scan_batched_resume(x, y, y0, sigma, alpha,
                                            int(n_iters),
                                            divergence=divergence)
    squeeze = y0.ndim == 1
    if squeeze:
        y, y0 = y[:, None], y0[:, None]
    out = fused_lp_scan_folded_resume(x, y, y0, sigma, alpha, int(n_iters),
                                      divergence=divergence)
    return out[:, 0] if squeeze else out


def lp_scan_fused(x: torch.Tensor, y0: torch.Tensor, sigma: float,
                  alpha=0.01, n_iters: int = 500,
                  divergence=None) -> torch.Tensor:
    """Eq. 15 against the EXACT transition matrix, streamed, never dense.

    Every iteration is one launch of the fused K1 kernel on the card (its
    plain-torch version on the CPU); for a batched ``(batch, N, C)`` stack
    each divergence tile serves all requests at once.
    """
    return lp_scan_fused_resume(x, y0, y0, sigma, alpha, n_iters,
                                divergence=divergence)


def lp_scan_fused_segmented(x: torch.Tensor, y0: torch.Tensor, sigma: float,
                            alpha=0.01, n_iters: int = 500, *,
                            segment_iters: int,
                            divergence=None) -> torch.Tensor:
    """Exact eq.-15 walk as checkpointed ``segment_iters``-sized segments."""
    if segment_iters < 1:
        raise ValueError(f"segment_iters must be >= 1, got {segment_iters}")
    y0 = torch.as_tensor(y0, device=x.device).to(torch.float32)
    y, done = y0, 0
    while done < n_iters:
        k = min(int(segment_iters), int(n_iters) - done)
        y = lp_scan_fused_resume(x, y, y0, sigma, alpha, k,
                                 divergence=divergence)
        done += k
    return y


def ccr(y_final: torch.Tensor, labels: np.ndarray,
        eval_mask: np.ndarray) -> float:
    """Correct classification rate on ``eval_mask`` rows."""
    pred = torch.argmax(y_final, dim=-1).cpu().numpy()
    mask = np.asarray(eval_mask, bool)
    if mask.sum() == 0:
        return float("nan")
    return float((pred[mask] == np.asarray(labels)[mask]).mean())
