"""``repro_torch/core/qopt.py`` ↔ ``repro/core/qopt.py``.

O(|B|) variational optimization of the block-constrained transition matrix
(paper eq. 7 under the row-stochasticity constraints eq. 16), in closed form:

  within-node softmax:  q_AB = v_A * exp(G_AB) / z_A,
                        z_A = sum_{B in A_mkd} W_B exp(G_AB),
                        G_AB = -D2_AB / (2 s^2 W_A W_B)
  bottom-up:            Zt_leaf = z_leaf
                        Wbar_A = (W_l log Zt_l + W_r log Zt_r) / W_A
                        Zt_A   = z_A + exp(Wbar_A)
  top-down:             R_root = 1;  v_A = R_A z_A / Zt_A;  R_child = R_A - v_A
  optimum value:        l(D) = c + W_root * log Zt_root

Every entry point takes ``divergence=`` (``None`` | registry name |
``Divergence`` | ``BoundDivergence``, see ``core/divergence.py``): any
divergence but the default swaps the block distance ``D2_AB`` for the block
Bregman divergence ``D_AB`` and the bound's Gaussian log-partition constant
for the divergence's own.

Everything runs in log space over flat heap arrays.  JAX's ``segment_max``
becomes ``scatter_reduce(amax, include_self=False)`` on a ``-inf`` init and
``segment_sum`` becomes ``index_add_``, so empty segments come out ``-inf``
exactly as in the reference.  On a CUDA device ``index_add_`` reduces with
atomics, whose order may change from run to run: the fit is bit-stable on
the CPU and stable within tolerance on the card.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.divergence import bind_divergence
from repro_torch.core.tree import PartitionTree

__all__ = ["QState", "block_sq_dists", "optimize_q", "optimize_q_from_g",
           "lower_bound", "block_log_G"]

_NEG_INF = float("-inf")


class QState(NamedTuple):
    """Result of one q-optimization."""

    log_q: torch.Tensor    # (cap,)      log q_AB (-inf where inactive)
    log_v: torch.Tensor    # (n_nodes,)  per-node allocated mass (log)
    log_z: torch.Tensor    # (n_nodes,)  per-node mark partition function (log)
    log_zt: torch.Tensor   # (n_nodes,)  per-node subtree partition function (log)
    bound: torch.Tensor    # ()          variational lower bound l(D)


def block_sq_dists(tree: PartitionTree, a: torch.Tensor, b: torch.Tensor,
                   divergence=None) -> torch.Tensor:
    """Block divergence D_AB from subtree statistics, O(1) per block: D2_AB
    of eq. 9 by default, the block Bregman divergence otherwise."""
    return bind_divergence(divergence, tree).block_div(tree, a, b)


def block_log_G(tree: PartitionTree, a: torch.Tensor, b: torch.Tensor,
                active: torch.Tensor, sigma: torch.Tensor,
                divergence=None) -> torch.Tensor:
    """G_AB = -D_AB/(2 s^2 W_A W_B); -inf on inactive/ghost blocks."""
    wa, wb = tree.W[a], tree.W[b]
    ok = active & (wa > 0) & (wb > 0)
    denom = torch.where(ok, 2.0 * sigma * sigma * wa * wb, 1.0)
    g = -block_sq_dists(tree, a, b, divergence=divergence) / denom
    return torch.where(ok, g, _NEG_INF)


def _segment_logsumexp(logits: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Numerically stable segmented logsumexp; -inf for empty segments."""
    m = torch.full((num_segments,), _NEG_INF, dtype=logits.dtype,
                   device=logits.device)
    m = m.scatter_reduce(0, segment_ids, logits, reduce="amax",
                         include_self=False)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    shifted = torch.where(torch.isfinite(logits),
                          torch.exp(logits - m_safe[segment_ids]), 0.0)
    s = torch.zeros_like(m).index_add_(0, segment_ids, shifted)
    return torch.where(s > 0, torch.log(s.clamp_min(1e-38)) + m_safe, _NEG_INF)


def _optimize_impl(W: torch.Tensor, log_z: torch.Tensor,
                   log_part: torch.Tensor, L: int):
    n_nodes = W.shape[0]

    # ---- bottom-up: log Zt and Wbar ---------------------------------------
    log_zt = log_z.clone()
    wbar = torch.full((n_nodes,), _NEG_INF, dtype=log_z.dtype, device=W.device)
    for lvl in range(L - 1, -1, -1):
        lo, hi = (1 << lvl) - 1, (1 << (lvl + 1)) - 1
        clo, chi = hi, (1 << (lvl + 2)) - 1
        zc, wc = log_zt[clo:chi], W[clo:chi]
        zl, zr = zc[0::2], zc[1::2]
        wl, wr = wc[0::2], wc[1::2]
        wn = W[lo:hi]
        # weighted geometric mean in log space; 0-weight children contribute
        # 0, a positive-weight child with no marks anywhere below forces -inf
        num = (torch.where(wl > 0, wl * zl, 0.0)
               + torch.where(wr > 0, wr * zr, 0.0))
        any_neg_inf = (((wl > 0) & ~torch.isfinite(zl))
                       | ((wr > 0) & ~torch.isfinite(zr)))
        wb_lvl = torch.where((wn > 0) & ~any_neg_inf,
                             num / wn.clamp_min(1e-12), _NEG_INF)
        log_zt[lo:hi] = torch.logaddexp(log_z[lo:hi], wb_lvl)
        wbar[lo:hi] = wb_lvl

    # ---- top-down: remaining mass R and per-node mass v -------------------
    log_r = torch.full((n_nodes,), _NEG_INF, dtype=log_z.dtype, device=W.device)
    log_r[0] = 0.0
    for lvl in range(0, L):
        lo, hi = (1 << lvl) - 1, (1 << (lvl + 1)) - 1
        rn, wb_lvl, zt_lvl = log_r[lo:hi], wbar[lo:hi], log_zt[lo:hi]
        # log R_child = log R + Wbar - log Zt   (R_child = R * e^Wbar / Zt)
        rc = torch.where(torch.isfinite(rn) & torch.isfinite(wb_lvl),
                         rn + wb_lvl - zt_lvl, _NEG_INF)
        log_r[hi:hi + 2 * (hi - lo)] = rc.repeat_interleave(2)

    log_v = torch.where(torch.isfinite(log_r) & torch.isfinite(log_z),
                        log_r + log_z - log_zt, _NEG_INF)

    # ---- bound ------------------------------------------------------------
    w_tot = W[0]
    const = -w_tot * (log_part + torch.log((w_tot - 1.0).clamp_min(1.0)))
    bound = const + w_tot * log_zt[0]
    return log_v, log_zt, bound


def optimize_q_from_g(tree: PartitionTree, a: torch.Tensor, b: torch.Tensor,
                      active: torch.Tensor, sigma: torch.Tensor,
                      log_g: torch.Tensor, divergence=None) -> QState:
    """Optimal q given precomputed block log-similarities ``log_g``.

    The d-free tail of :func:`optimize_q`: O(|B| + N) segment and level
    sweeps with no dependence on the data dimension (the streaming layer
    re-optimizes through it).  ``divergence`` is only consulted for the
    bound's log-partition constant.
    """
    div = bind_divergence(divergence, tree)
    wb = tree.W[b]
    contrib = torch.where(active & (wb > 0),
                          torch.log(wb.clamp_min(1e-12)) + log_g, _NEG_INF)
    log_z = _segment_logsumexp(contrib, a, tree.n_nodes)
    dim = torch.tensor(float(tree.dim), dtype=torch.float32, device=tree.device)
    log_part = div.log_partition(dim, sigma)
    log_v, log_zt, bound = _optimize_impl(tree.W, log_z, log_part, tree.L)
    log_q = torch.where(torch.isfinite(log_g) & torch.isfinite(log_v[a]),
                        log_v[a] + log_g - log_z[a], _NEG_INF)
    return QState(log_q=log_q, log_v=log_v, log_z=log_z, log_zt=log_zt,
                  bound=bound)


def optimize_q(tree: PartitionTree, a: torch.Tensor, b: torch.Tensor,
               active: torch.Tensor, sigma: torch.Tensor,
               divergence=None) -> QState:
    """Optimal block parameters q for the given partition and bandwidth."""
    div = bind_divergence(divergence, tree)
    log_g = block_log_G(tree, a, b, active, sigma, divergence=div)
    return optimize_q_from_g(tree, a, b, active, sigma, log_g, divergence=div)


def lower_bound(tree: PartitionTree, a: torch.Tensor, b: torch.Tensor,
                active: torch.Tensor, log_q: torch.Tensor,
                sigma: torch.Tensor, divergence=None) -> torch.Tensor:
    """l(D) (eq. 7) for an arbitrary feasible q.

    A divergence/domain mismatch (KL over a tree fitted on non-positive
    data) raises ``ValueError`` at bind time instead of returning NaN.
    """
    div = bind_divergence(divergence, tree)
    wa, wb = tree.W[a], tree.W[b]
    ok = active & (wa > 0) & (wb > 0) & torch.isfinite(log_q)
    q = torch.where(ok, torch.exp(log_q), 0.0)
    d2 = div.block_div(tree, a, b)
    dist_term = -torch.where(ok, q * d2, 0.0).sum() / (2.0 * sigma * sigma)
    ent_term = -torch.where(ok, wa * wb * q * log_q, 0.0).sum()
    w_tot = tree.W[0]
    const = -w_tot * (div.log_partition(tree.dim, sigma)
                      + torch.log((w_tot - 1.0).clamp_min(1.0)))
    return const + dist_term + ent_term
