"""The Bregman divergences that the plain references implement, written from
their definitions (Amizadeh, Thiesson, Hauskrecht, "The Bregman Variational
Dual-Tree Framework", arXiv:1309.6812):

    d_phi(a, b) = phi(a) - phi(b) - <grad phi(b), a - b>

* ``sqeuclidean``: phi(x) = |x|^2, so d = |a - b|^2 (the paper's Gaussian kernel);
* ``kl``: phi(x) = sum x log x, so d = sum a log(a / b) - a + b (generalised KL);
* ``itakura_saito``: phi(x) = -sum log x, so d = sum a / b - log(a / b) - 1.

The last two need every coordinate > 0.  A configuration names its divergence
under ``fit.divergence``.  :func:`require` refuses, at set-up, any other name
(``mahalanobis`` among them, whose scale no configuration states) and points
outside phi's domain, so that no run is checked against a divergence other
than its own.
"""
from __future__ import annotations

import torch

POSITIVE = ("kl", "itakura_saito")
NAMES = ("sqeuclidean",) + POSITIVE


def name(config: dict) -> str:
    """The configuration's divergence, if the references implement it."""
    div = config["fit"]["divergence"]
    if div not in NAMES:
        raise ValueError(f"divergence {div!r}: the plain references implement "
                         f"only {', '.join(NAMES)}, so no run under it can be "
                         "checked")
    return div


def require(config: dict, x: torch.Tensor) -> str:
    """:func:`name`, with the points ``x`` checked against phi's domain."""
    div = name(config)
    if div in POSITIVE:
        lo = float(x.min())
        if not lo > 0.0:
            raise ValueError(f"divergence {div!r} needs every coordinate > 0; "
                             f"the configuration's points reach {lo:g}")
    return div


def point_terms(div: str, x: torch.Tensor):
    """Per point: ``(phi(x), grad phi(x), <grad phi(x), x>)``, shapes (N,),
    (N, d) and (N,), in ``x``'s type (``kl`` and ``itakura_saito`` only)."""
    if div == "kl":
        lx = torch.log(x)
        g = lx + 1.0
        return (x * lx).sum(1), g, (g * x).sum(1)
    if div == "itakura_saito":
        g = -1.0 / x
        return -torch.log(x).sum(1), g, (g * x).sum(1)
    raise ValueError(f"no Bregman node terms for divergence {div!r}")


def cross_form(div: str, x: torch.Tensor):
    """``(row, col, rows, cols, c)`` with d(x_i, x_j) = row_i + col_j -
    c <rows_i, cols_j>, each in ``x``'s type: the pairwise divergence as one
    matrix product (``rows`` and ``cols`` its operands) and two biases."""
    if div == "sqeuclidean":
        sq = (x * x).sum(1)
        return sq, sq, x, x, 2.0
    if div == "kl":
        lx = torch.log(x)
        s = x.sum(1)
        return (x * lx).sum(1) - s, s, x, lx, 1.0
    if div == "itakura_saito":
        ls = torch.log(x).sum(1)
        return -ls - float(x.shape[1]), ls, x, 1.0 / x, -1.0
    raise ValueError(f"no pairwise form for divergence {div!r}")
