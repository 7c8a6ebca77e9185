"""Plain reference of the ``vdt`` backend: the paper's O(|B|) transition
matrix Q (eq. 7's closed-form optimum under eq. 16) and the eq.-15 walk over
it (Algorithm 1), in float64.

What it follows of the program, and why: the fit is a greedy sequence (a
power-iteration tree whose near-tied splits, then hundreds of refinement
rounds that each sort |B| gains on the host) whose choices a second
implementation would make differently, not wrongly.  So the reference takes
the fit's three choices, the leaf order of the points (``leaf_of``), the
active blocks (``a``, ``b``) and the bandwidth ``sigma``, checks each of
them by itself (:func:`checks`: sigma against eq. 12 at the reference's own
q), and works out everything else again from the points: node statistics,
block divergences, q and the walk.

The block divergences are the configuration's (``bregman.py``): under
``sqeuclidean`` the summed squared distances of eq. 9, and under ``kl`` and
``itakura_saito`` the Bregman factorisation of the same sum over node sums
of phi(x), grad phi(x) and <grad phi(x), x>.  q, eq. 12 and the walk take
whichever D the divergence gives.

Layout: a heap over ``2^L`` leaf slots, node k's children at 2k+1 and 2k+2,
level l at ids [2^l - 1, 2^(l+1) - 1), leaves at level L; ``leaf_of[s]`` is
the row in leaf slot s, or N for an empty (ghost) slot.  Block (A, B) holds
Q's entries of rows in subtree A and columns in subtree B.
"""
from __future__ import annotations

import torch

from bench.reference import bregman

CONTROL = "bfloat16"    # the carriers a memory-bound walk would tempt
_BLOCK_CHUNK = 1 << 17
_COLUMN_CHUNK = 256


def _up(leaf_vals: torch.Tensor, L: int) -> torch.Tensor:
    """Per-node sums (root first, heap order) of per-leaf values."""
    levels, cur = [leaf_vals], leaf_vals
    for _ in range(L):
        cur = cur.reshape(-1, 2, *cur.shape[1:]).sum(1)
        levels.append(cur)
    return torch.cat(levels[::-1])


def _down(per_node: torch.Tensor, L: int) -> torch.Tensor:
    """Per-leaf sums of ``per_node`` over each leaf's path from the root."""
    acc = per_node[0:1]
    for lvl in range(1, L + 1):
        acc = acc.repeat_interleave(2, 0) + per_node[(1 << lvl) - 1:
                                                      (1 << (lvl + 1)) - 1]
    return acc


def _slots(leaf_of: torch.Tensor, n: int) -> torch.Tensor:
    """The leaf slot of each of the N rows."""
    real = leaf_of < n
    slot = torch.empty(n, dtype=torch.int64, device=leaf_of.device)
    slot[leaf_of[real]] = torch.nonzero(real).flatten()
    return slot


def checks(x: torch.Tensor, fitted: dict, config: dict) -> dict:
    """The fit's choices, checked by themselves (each exact, limit 0):

    * ``order_defects``: rows missing from the leaf order, or placed twice;
    * ``partition_defects``: real leaves whose row of the coverage matrix
      (how often each pair (i, j) lies in an active block) is not 1 off the
      diagonal and 0 on it, tested on two random integer vectors in int64
      arithmetic (a wrong row passes one test with probability under 2^-20);
    * ``blocks_short``: active blocks short of the configuration's
      ``blocks_per_point`` x N;
    * ``sigma_err``: how far the fit's sigma lies from eq. 12 (:func:`sigma_err`).
    """
    n = x.shape[0]
    leaf_of, a, b, L = fitted["leaf_of"], fitted["a"], fitted["b"], fitted["L"]
    real = leaf_of < n
    ids = leaf_of[real]
    order = int((torch.bincount(ids, minlength=n) != 1).sum()) \
        + int((leaf_of < 0).sum()) + int((leaf_of > n).sum())
    gen = torch.Generator(device=x.device).manual_seed(0x5EED)
    bad = torch.zeros_like(real)
    for _ in range(2):
        r = torch.randint(0, 1 << 20, real.shape, generator=gen,
                          device=x.device) * real
        t = _up(r, L)
        cover = _down(torch.zeros_like(t).index_add_(0, a, t[b]), L)
        bad |= real & (cover != r.sum() - r)
    want = int(config["fit"]["blocks_per_point"]) * n
    return {"order_defects": float(order),
            "partition_defects": float(bad.sum()),
            "blocks_short": float(max(0, want - int(fitted["n_active"]))),
            "sigma_err": sigma_err(x, fitted, config)}


def block_q(x: torch.Tensor, fitted: dict, config: dict) -> torch.Tensor:
    """q_AB of every followed block at the fit's sigma (:func:`block_terms`)."""
    return block_terms(x, fitted, config, float(fitted["sigma"]))[0]


def sigma_star(q: torch.Tensor, dab: torch.Tensor, n: int, d: int,
               dtype: torch.dtype = torch.float64) -> float:
    """Eq. 12, the bandwidth that maximises the bound at fixed q:
    sigma*^2 = sum_AB q_AB D_AB / (d N), computed in ``dtype``."""
    num = (q.to(dtype) * dab.to(dtype)).sum()
    return float(torch.sqrt(num / (d * n)).to(torch.float64))


def sigma_err(x: torch.Tensor, fitted: dict, config: dict,
              sigma: float | None = None,
              dtype: torch.dtype = torch.float64) -> float:
    """|s - sigma*(q(s))| / s for the bandwidth s (the fit's by default):
    q worked out at s in float64, eq. 12 in ``dtype``.  The fit ends on eq.
    12 (each refinement round refits sigma), so a sound fit reads near 0."""
    s = float(fitted["sigma"]) if sigma is None else float(sigma)
    q, dab = block_terms(x, fitted, config, s)
    return abs(s - sigma_star(q, dab, x.shape[0], x.shape[1], dtype)) / s


def control_sigma_err(x: torch.Tensor, fitted: dict, config: dict) -> float:
    """``sigma_err`` of the control put in the program's place: the fit's
    last refit (eq. 12 at q of the fit's sigma) computed in bfloat16."""
    q, dab = block_terms(x, fitted, config, float(fitted["sigma"]))
    return sigma_err(x, fitted, config,
                     sigma_star(q, dab, x.shape[0], x.shape[1],
                                torch.bfloat16))


def block_div(x: torch.Tensor, fitted: dict, config: dict) -> torch.Tensor:
    """D_AB = sum over i in A (rows), j in B (columns) of d(x_i, x_j) for
    every followed block, in float64, under the configuration's divergence.

    ``sqeuclidean`` is eq. 9 from the node sums W, S1 = sum x and S2 =
    sum |x|^2: D_AB = W_B S2_A + W_A S2_B - 2 <S1_A, S1_B>.  A Bregman
    divergence sums d(x_i, x_j) = phi(x_i) - phi(x_j) - <grad phi(x_j), x_i>
    + <grad phi(x_j), x_j> the same way, from the node sums Sphi, Sg and Sgx
    of phi(x), grad phi(x) and <grad phi(x), x>: D_AB = W_B Sphi_A - W_A
    Sphi_B - <S1_A, Sg_B> + W_A Sgx_B, clamped at 0 as a sum of divergences
    is.  Ghost slots take a real point's terms, weighted 0.
    """
    div = bregman.name(config)
    n = x.shape[0]
    leaf_of, a, b, L = fitted["leaf_of"], fitted["a"], fitted["b"], fitted["L"]
    f64 = torch.float64
    w_leaf = (leaf_of < n).to(f64)
    W = _up(w_leaf, L)
    d = torch.empty(a.shape[0], dtype=f64, device=x.device)
    if div == "sqeuclidean":
        x_leaf = x.to(f64)[leaf_of.clamp_max(n - 1)] * w_leaf[:, None]
        S1 = _up(x_leaf, L)
        S2 = _up((x_leaf * x_leaf).sum(1), L)
        del x_leaf
        for lo in range(0, a.shape[0], _BLOCK_CHUNK):
            aa, bb = a[lo:lo + _BLOCK_CHUNK], b[lo:lo + _BLOCK_CHUNK]
            d[lo:lo + _BLOCK_CHUNK] = (W[bb] * S2[aa] + W[aa] * S2[bb]
                                       - 2.0 * (S1[aa] * S1[bb]).sum(1))
        return d
    x_leaf = x.to(f64)[leaf_of.clamp_max(n - 1)]
    phi, g, gx = bregman.point_terms(div, x_leaf)
    S1 = _up(x_leaf * w_leaf[:, None], L)
    del x_leaf
    Sg = _up(g * w_leaf[:, None], L)
    del g
    Sphi, Sgx = _up(phi * w_leaf, L), _up(gx * w_leaf, L)
    for lo in range(0, a.shape[0], _BLOCK_CHUNK):
        aa, bb = a[lo:lo + _BLOCK_CHUNK], b[lo:lo + _BLOCK_CHUNK]
        d[lo:lo + _BLOCK_CHUNK] = (W[bb] * Sphi[aa] - W[aa] * Sphi[bb]
                                   - (S1[aa] * Sg[bb]).sum(1)
                                   + W[aa] * Sgx[bb])
    return d.clamp_min_(0.0)


def block_terms(x: torch.Tensor, fitted: dict, config: dict, sigma: float):
    """``(q, D)`` of every followed block, in float64, from the points: q_AB
    at the bandwidth ``sigma`` and the summed divergences D_AB
    (:func:`block_div`).

    z_A = sum_B W_B e^{G_AB} with G_AB = -D_AB / (2 s^2 W_A W_B); bottom up
    Zt_A = z_A + exp((W_l log Zt_l + W_r log Zt_r) / W_A); top down the mass
    R (R_root = 1, R_child = R_A exp(Wbar_A) / Zt_A) and v_A = R_A z_A /
    Zt_A; then q_AB = v_A e^{G_AB} / z_A.
    """
    n = x.shape[0]
    leaf_of, a, b, L = fitted["leaf_of"], fitted["a"], fitted["b"], fitted["L"]
    f64 = torch.float64
    W = _up((leaf_of < n).to(f64), L)
    dab = block_div(x, fitted, config)
    g = -dab / (2.0 * sigma * sigma * W[a] * W[b])
    n_nodes = W.shape[0]
    neg_inf = float("-inf")
    v = torch.log(W[b]) + g
    m = torch.full((n_nodes,), neg_inf, dtype=f64, device=x.device) \
        .scatter_reduce(0, a, v, reduce="amax", include_self=False)
    m0 = torch.where(torch.isfinite(m), m, 0.0)
    s = torch.zeros(n_nodes, dtype=f64, device=x.device) \
        .index_add_(0, a, torch.exp(v - m0[a]))
    log_z = torch.where(s > 0, torch.log(s) + m0, neg_inf)

    log_zt = log_z.clone()
    wbar = torch.full((n_nodes,), neg_inf, dtype=f64, device=x.device)
    for lvl in range(L - 1, -1, -1):
        lo, hi = (1 << lvl) - 1, (1 << (lvl + 1)) - 1
        kids = slice(hi, (1 << (lvl + 2)) - 1)
        zl, zr = log_zt[kids][0::2], log_zt[kids][1::2]
        wl, wr = W[kids][0::2], W[kids][1::2]
        starved = ((wl > 0) & ~torch.isfinite(zl)) | \
            ((wr > 0) & ~torch.isfinite(zr))
        num = torch.where(wl > 0, wl * zl, 0.0) + torch.where(wr > 0, wr * zr,
                                                              0.0)
        wn = W[lo:hi]
        wbar[lo:hi] = torch.where((wn > 0) & ~starved, num / wn, neg_inf)
        log_zt[lo:hi] = torch.logaddexp(log_z[lo:hi], wbar[lo:hi])

    log_r = torch.full((n_nodes,), neg_inf, dtype=f64, device=x.device)
    log_r[0] = 0.0
    for lvl in range(L):
        lo, hi = (1 << lvl) - 1, (1 << (lvl + 1)) - 1
        ok = torch.isfinite(log_r[lo:hi]) & torch.isfinite(wbar[lo:hi])
        child = torch.where(ok, log_r[lo:hi] + wbar[lo:hi] - log_zt[lo:hi],
                            neg_inf)
        log_r[hi:hi + 2 * (hi - lo)] = child.repeat_interleave(2)
    ok = torch.isfinite(log_r) & torch.isfinite(log_z)
    log_v = torch.where(ok, log_r + log_z - log_zt, neg_inf)
    log_q = log_v[a] + g - log_z[a]
    return torch.where(torch.isfinite(log_q), torch.exp(log_q), 0.0), dab


def _walk(q, a, b, slot, real, L, y0, alpha, n_iters, dtype):
    np_ = real.shape[0]
    y0_leaf = torch.zeros((np_, y0.shape[1]), dtype=dtype, device=y0.device)
    y0_leaf[slot] = y0.to(dtype)
    mask = real.to(dtype)[:, None]
    alpha = alpha.to(dtype)
    q = q.to(dtype)[:, None]
    y = y0_leaf
    for _ in range(int(n_iters)):
        t = _up(y, L)
        qy = _down(torch.zeros_like(t).index_add_(0, a, q * t[b]), L)
        y = mask * (alpha * qy) + (1.0 - alpha) * y0_leaf
    return y[slot]


def answers(x: torch.Tensor, fitted: dict, config: dict, y0: torch.Tensor,
            alpha: torch.Tensor, n_iters: int,
            precision: str = "float64") -> torch.Tensor:
    """The eq.-15 walk ``Y <- alpha (Q Y) + (1 - alpha) Y0`` from ``y0``
    (N, K) with per-column ``alpha`` (K,), computed in ``precision``
    (``"float64"``, or :data:`CONTROL` with q and the labels carried in it)."""
    dtype = {"float64": torch.float64, "bfloat16": torch.bfloat16}[precision]
    n = x.shape[0]
    q = block_q(x, fitted, config)
    slot = _slots(fitted["leaf_of"], n)
    real = fitted["leaf_of"] < n
    out = torch.empty(y0.shape, dtype=torch.float64, device=x.device)
    for lo in range(0, y0.shape[1], _COLUMN_CHUNK):
        cols = slice(lo, lo + _COLUMN_CHUNK)
        out[:, cols] = _walk(q, fitted["a"], fitted["b"], slot, real,
                             fitted["L"], y0[:, cols], alpha[cols], n_iters,
                             dtype).to(torch.float64)
    return out
