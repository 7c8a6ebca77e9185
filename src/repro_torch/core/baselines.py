"""``repro_torch/core/baselines.py`` ↔ ``repro/core/baselines.py``.

Baselines from the paper's §5.1: the exact model and the kNN graph.

* ``exact``: the dense row-softmax transition matrix (eq. 3, zero diagonal),
  and a blocked streaming matvec that never materializes P (the fused CUDA
  kernels of ``kernels/fused_lp`` are the fast form of the same product).
* ``knn``: each point keeps its k nearest neighbours, with eq.-3 weights
  restricted to those k: blocked brute-force distances on the device, then
  ``torch.topk``, in place of a kd- or anchor-tree search.

Distances are torch ops (a float32 matrix product, TF32 off), as the
reference computes them outside any Pallas kernel.  Everything runs on the
device of ``x``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["KnnGraph", "build_knn_graph", "exact_matvec",
           "exact_transition_matrix", "knn_matvec", "streaming_exact_matvec"]


def _sigma(sigma, device) -> torch.Tensor:
    return torch.as_tensor(sigma, dtype=torch.float32, device=device)


def _sq_dists(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(n, m) pairwise squared distances by the norm expansion."""
    xn = (x * x).sum(-1)
    yn = (y * y).sum(-1)
    d2 = xn[:, None] + yn[None, :] - 2.0 * (x @ y.T)
    return d2.clamp_min(0.0)


def exact_transition_matrix(x: torch.Tensor, sigma) -> torch.Tensor:
    """Dense P via eq. 3: row softmax of -d^2/(2 sigma^2), zero diagonal."""
    sigma = _sigma(sigma, x.device)
    logits = -_sq_dists(x, x) / (2.0 * sigma * sigma)
    eye = torch.eye(x.shape[0], dtype=torch.bool, device=x.device)
    return torch.softmax(logits.masked_fill(eye, float("-inf")), dim=-1)


def exact_matvec(p: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return p @ y


def streaming_exact_matvec(x: torch.Tensor, y: torch.Tensor, sigma,
                           block: int = 1024) -> torch.Tensor:
    """P @ Y without materializing P: online softmax over column blocks.

    O(N^2 d) operations, O(N * block) memory.
    """
    n = x.shape[0]
    sigma = _sigma(sigma, x.device)
    inv = 1.0 / (2.0 * sigma * sigma)
    xn = (x * x).sum(-1)
    rows = torch.arange(n, device=x.device)
    m = torch.full((n,), float("-inf"), dtype=x.dtype, device=x.device)
    s = torch.zeros((n,), dtype=x.dtype, device=x.device)
    acc = torch.zeros((n, y.shape[1]), dtype=x.dtype, device=x.device)
    for j0 in range(0, n, block):
        xb, yb = x[j0:j0 + block], y[j0:j0 + block]
        d2 = xn[:, None] + (xb * xb).sum(-1)[None, :] - 2.0 * (x @ xb.T)
        logits = -d2.clamp_min(0.0) * inv
        diag = (j0 + torch.arange(xb.shape[0], device=x.device))[None, :] \
            == rows[:, None]
        logits = logits.masked_fill(diag, float("-inf"))
        new_m = torch.maximum(m, logits.amax(dim=1))
        scale = torch.exp(m - new_m)
        p = torch.exp(logits - new_m[:, None])
        s = s * scale + p.sum(dim=1)
        acc = acc * scale[:, None] + p @ yb
        m = new_m
    return acc / s.clamp_min(1e-38)[:, None]


class KnnGraph(NamedTuple):
    indices: torch.Tensor  # (N, k) neighbour ids, int64
    weights: torch.Tensor  # (N, k) row-normalized transition probabilities


def build_knn_graph(x: torch.Tensor, k: int, sigma,
                    block: int = 2048) -> KnnGraph:
    """Blocked brute-force kNN + eq.-3 weights restricted to the k edges.

    Each block of ``block`` rows forms its (block, N) squared distances, sets
    its self-distances to +inf and keeps the k smallest (``torch.topk`` of
    ``-d^2``); the weights are the softmax of ``-d^2/(2 sigma^2)`` over them.
    """
    n = x.shape[0]
    idx = torch.empty((n, int(k)), dtype=torch.int64, device=x.device)
    d2k = torch.empty((n, int(k)), dtype=x.dtype, device=x.device)
    for i0 in range(0, n, block):
        xb = x[i0:i0 + block]
        d2 = _sq_dists(xb, x)                        # (block, n)
        r = torch.arange(xb.shape[0], device=x.device)
        d2[r, i0 + r] = float("inf")
        neg, ids = torch.topk(-d2, int(k), dim=1)
        idx[i0:i0 + block] = ids
        d2k[i0:i0 + block] = -neg
    sigma = _sigma(sigma, x.device)
    w = torch.softmax(-d2k / (2.0 * sigma * sigma), dim=-1)
    return KnnGraph(indices=idx, weights=w)


def knn_matvec(g: KnnGraph, y: torch.Tensor) -> torch.Tensor:
    """O(kN) sparse matvec: (PY)_i = sum_k w_ik y_{idx_ik}."""
    return torch.einsum("nk,nkc->nc", g.weights, y[g.indices])
