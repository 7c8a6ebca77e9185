"""``repro_torch/core/refine.py`` ↔ ``repro/core/refine.py``.

Greedy block refinement (paper §4.4).  Horizontal refinement of block
(A, B) replaces it by {(A, B_l), (A, B_r)}; the closed-form lower bound on
its log-likelihood gain (eq. 19) is

    Delta_h(A, B) = W_A W_B q_AB * log( sum_t W_{B_t} e^{G_{A B_t}}
                                        / (W_B e^{G_AB}) )

Picking (A, B) also refines its mirror (B, A) (symmetric refinement).  All
gains are computed at once on the device and the top-k are applied on the
host with the reference's own ``np.argsort(-g)``, so ties break as there.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.blocks import BlockPartition, _host, device_blocks
from repro_torch.core.divergence import bind_divergence
from repro_torch.core.qopt import QState, block_log_G, optimize_q
from repro_torch.core.tree import PartitionTree

__all__ = ["refinement_gains", "refine_topk", "refine_to_budget"]


def _flush_subnormal(t: torch.Tensor) -> torch.Tensor:
    """Float32 subnormals -> 0, as XLA computes them in the reference.

    Gains of blocks whose q underflows must tie at exactly 0 there and here,
    or ``np.argsort`` breaks the tie differently and refinement diverges.
    """
    return torch.where(t.abs() < torch.finfo(t.dtype).tiny, 0.0, t)


def _gains_impl(log_g, log_gl, log_gr, wb, wbl, wbr, log_q, refinable):
    neg_inf = float("-inf")
    lse = torch.logaddexp(
        torch.where(wbl > 0, torch.log(wbl.clamp_min(1e-12)) + log_gl, neg_inf),
        torch.where(wbr > 0, torch.log(wbr.clamp_min(1e-12)) + log_gr, neg_inf),
    )
    parent = torch.log(wb.clamp_min(1e-12)) + log_g
    gain_log = lse - parent
    q = _flush_subnormal(torch.where(torch.isfinite(log_q), torch.exp(log_q), 0.0))
    return torch.where(refinable & torch.isfinite(gain_log),
                       _flush_subnormal(q * gain_log.clamp_min(0.0)), neg_inf)


def refinement_gains(tree: PartitionTree, a: torch.Tensor, b: torch.Tensor,
                     active: torch.Tensor, log_q: torch.Tensor,
                     sigma: torch.Tensor, divergence=None) -> torch.Tensor:
    """Total gain W_A W_B q_AB log(...) per block (eq. 19); -inf if unrefinable."""
    wa, wb = tree.W[a], tree.W[b]
    b_internal = b < tree.n_internal
    bl = torch.where(b_internal, 2 * b + 1, b)
    br = torch.where(b_internal, 2 * b + 2, b)
    div = bind_divergence(divergence, tree)  # bind stats once for all 3 calls
    log_g = block_log_G(tree, a, b, active, sigma, divergence=div)
    log_gl = block_log_G(tree, a, bl, active, sigma, divergence=div)
    log_gr = block_log_G(tree, a, br, active, sigma, divergence=div)
    refinable = active & b_internal & (wa > 0) & (wb > 0)
    raw = _gains_impl(log_g, log_gl, log_gr, wb, tree.W[bl], tree.W[br],
                      log_q, refinable)
    return torch.where(refinable, _flush_subnormal(wa * wb * raw), float("-inf"))


def refine_topk(bp: BlockPartition, tree: PartitionTree, gains: np.ndarray,
                k: int, stale: np.ndarray | None = None) -> int:
    """Apply symmetric refinement to the top-k blocks by gain (host-side).

    Returns the number of blocks refined.  Each refined block is deactivated
    and replaced by its two horizontal children.  ``stale`` (optional bool
    array over block slots) puts stale blocks with a finite gain first,
    gain-ordered among themselves; refined slots are cleared in place.
    """
    g = np.asarray(gains[: bp.n], dtype=np.float64)
    g[~bp.active[: bp.n]] = -np.inf
    if stale is not None:
        # stale arrays are sized to the partition they were created for;
        # blocks appended by earlier refinement rounds are implicitly fresh
        s = np.zeros(bp.n, bool)
        m = min(len(stale), bp.n)
        s[:m] = np.asarray(stale[:m], bool)
        # primary key: stale first; secondary: gain descending (lexsort
        # reads keys last-to-first)
        order = np.lexsort((-g, ~s))
    else:
        order = np.argsort(-g)
    picked: list[int] = []
    seen: set[int] = set()
    for idx in order[: 4 * k]:
        if len(picked) >= k or not np.isfinite(g[idx]):
            break
        i = int(idx)
        if i in seen:
            continue
        picked.append(i)
        seen.add(i)
        m = int(bp.mirror[i])
        if m >= 0 and bp.active[m] and m not in seen:
            # symmetric refinement: the mirror is refined too and does not
            # count against k (the paper's vertical-refinement stand-in)
            picked.append(m)
            seen.add(m)
    if not picked:
        return 0

    w = _host(tree.W)
    new_a, new_b = [], []
    for i in picked:
        ai, bi = int(bp.a[i]), int(bp.b[i])
        for bc in (2 * bi + 1, 2 * bi + 2):
            # children whose kernel side is all-ghost cover no real pair;
            # skipping them keeps the fitted layout independent of ghost
            # headroom
            if w[ai] > 0 and w[bc] > 0:
                new_a.append(ai)
                new_b.append(bc)
        bp.active[i] = False
        bp.refined[i] = True
        if stale is not None and i < len(stale):
            stale[i] = False

    # refinement children generally have no mirror in B; only coarsest
    # sibling blocks do
    bp.append_pairs(np.asarray(new_a, np.int32), np.asarray(new_b, np.int32),
                    np.full(len(new_a), -1, np.int32))
    return len(picked)


def refine_to_budget(bp: BlockPartition, tree: PartitionTree,
                     sigma: torch.Tensor, max_blocks: int, batch: int = 64,
                     refit_sigma: bool = False, divergence=None,
                     stale: np.ndarray | None = None
                     ) -> Tuple[QState, torch.Tensor]:
    """Refine until ``n_active >= max_blocks``; returns final (QState, sigma).

    Re-optimizes q globally after every batched round of ``batch`` picks.
    ``stale`` (optional bool array over block slots) puts blocks patched by
    streaming mutations first (:func:`refine_topk`); refined slots are
    cleared in place.
    """
    from repro_torch.core.sigma import sigma_star  # avoids an import cycle

    dev = tree.device
    div = bind_divergence(divergence, tree)
    qs = optimize_q(tree, *device_blocks(bp, dev), sigma, divergence=div)
    while bp.n_active < max_blocks:
        k = min(batch, max(1, (max_blocks - bp.n_active) // 2))
        gains = refinement_gains(tree, *device_blocks(bp, dev), qs.log_q, sigma,
                                 divergence=div)
        done = refine_topk(bp, tree, _host(gains), k, stale=stale)
        if done == 0:
            break
        blocks = device_blocks(bp, dev)
        qs = optimize_q(tree, *blocks, sigma, divergence=div)
        if refit_sigma:
            sigma = sigma_star(tree, *blocks, qs.log_q, divergence=div)
            qs = optimize_q(tree, *blocks, sigma, divergence=div)
    return qs, sigma
