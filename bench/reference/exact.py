"""Plain reference of the ``exact`` backend: the eq.-3 transition matrix
P_ij = softmax_{j != i}(-d(x_i, x_j) / (2 sigma^2)), d the configuration's
divergence (``bregman.py``; |x_i - x_j|^2 under ``sqeuclidean``) of row i
from column j, clamped at 0, and the eq.-15 walk over it, in float64, a
block of rows at a time (P is never held whole).

It follows one choice of the fit, the bandwidth ``sigma``, and checks it
as ``reference/vdt.py`` does, against eq. 12 at the q of the fit's own
blocks (with the leaf order and the blocks that this rests on); the points
are the run's own.  The control computes both products (the divergences'
cross term and ``P @ Y``) as one TF32 tensor-core product would, from
operands rounded to TF32 (10 mantissa bits), in float32: the step below the
float32 that the configuration states.  The cross term's operands are x_i
and x_j under ``sqeuclidean``, x_i and log x_j under ``kl``, x_i and 1 / x_j
under ``itakura_saito``.
"""
from __future__ import annotations

import torch

from bench.reference import bregman
from bench.reference.vdt import checks, control_sigma_err  # noqa: F401

CONTROL = "tf32"
_ROWS = 2048


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """Float32 ``t`` rounded to TF32 (nearest, ties away from zero)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def answers(x: torch.Tensor, fitted: dict, config: dict, y0: torch.Tensor,
            alpha: torch.Tensor, n_iters: int,
            precision: str = "float64") -> torch.Tensor:
    """The eq.-15 walk ``Y <- alpha (P Y) + (1 - alpha) Y0`` from ``y0``
    (N, K) with per-column ``alpha`` (K,), in ``precision`` (``"float64"``
    or ``"tf32"``)."""
    if precision == "float64":
        dtype, rnd = torch.float64, (lambda t: t)
    elif precision == "tf32":
        dtype, rnd = torch.float32, to_tf32
    else:
        raise ValueError(f"unknown precision {precision!r}")
    n = x.shape[0]
    row, col, lhs, rhs, c = bregman.cross_form(bregman.name(config),
                                               x.to(dtype))
    lhs, rhs = rnd(lhs), rnd(rhs)
    inv = 1.0 / (2.0 * float(fitted["sigma"]) ** 2)
    y0 = y0.to(dtype)
    alpha = alpha.to(dtype)
    y = y0
    for _ in range(int(n_iters)):
        nxt = torch.empty_like(y)
        yr = rnd(y)
        for lo in range(0, n, _ROWS):
            hi = min(n, lo + _ROWS)
            dij = (row[lo:hi, None] + col[None, :]
                   - c * (lhs[lo:hi] @ rhs.T)).clamp_min_(0.0)
            logits = dij.mul_(-inv)
            rows = torch.arange(hi - lo, device=x.device)
            logits[rows, lo + rows] = float("-inf")
            p = torch.softmax(logits, dim=1)
            del logits, dij
            nxt[lo:hi] = alpha * (rnd(p) @ yr) + (1.0 - alpha) * y0[lo:hi]
        y = nxt
    return y.to(torch.float64)
