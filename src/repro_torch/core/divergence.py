"""``repro_torch/core/divergence.py`` ↔ ``repro/core/divergence.py``.

Pluggable Bregman divergences for the VDT core (Bregman VDT, arXiv:1309.6812).

The paper's variational machinery (eqs. 3/13/15) touches the data only
through pairwise squared Euclidean distances aggregated per block by the
subtree-statistics factorization (eq. 9).  The same block-partition
optimization goes through for any Bregman divergence

    d_phi(a, b) = phi(a) - phi(b) - <grad phi(b), a - b>

because the block-level sum factorizes just like eq. 9:

    D_AB = sum_{i in A, j in B} w_i w_j d_phi(x_i, x_j)
         = W_B * Sphi_A  -  W_A * Sphi_B  -  <S1_A, Sg_B>  +  W_A * Sgx_B

with per-node sums ``Sphi = sum_i w_i phi(x_i)``, ``Sg = sum_i w_i grad
phi(x_i)``, ``Sgx = sum_i w_i <grad phi(x_i), x_i>``.  One O(N d) bottom-up
pass yields O(1)-per-block divergences.

Registered divergences
----------------------
``sqeuclidean``     phi(x) = ||x||^2            (the paper's Gaussian kernel)
``kl``              phi(x) = sum x log x        (generalized KL; x > 0)
``itakura_saito``   phi(x) = -sum log x         (spectral/count data; x > 0)
``mahalanobis``     phi(x) = sum m_k x_k^2      (diagonal metric; see
                                                 :func:`mahalanobis`)

``sqeuclidean`` keeps the tree's own ``S1``/``S2`` (eq. 9 verbatim).  The
functions take and return torch tensors; :meth:`Divergence.tile` computes in
the type of its operands (float32 on every path of the port, float64 for the
card's precision gate).  The exact backend's CUDA kernels (K1-K3) run the
tiles of ``sqeuclidean`` (and of every divergence that is squared Euclidean
after :meth:`Divergence.transform_points`), ``kl`` and ``itakura_saito``;
``kernels/fused_lp/fused_lp.py::tile_config`` says which.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import weakref
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.blocks import _host
from repro_torch.core.tree import PartitionTree

__all__ = [
    "DIVERGENCES",
    "BoundDivergence",
    "DivStats",
    "Divergence",
    "ITAKURA_SAITO",
    "KL",
    "MAHALANOBIS",
    "SQEUCLIDEAN",
    "adopt_bound",
    "bind_divergence",
    "get_divergence",
    "mahalanobis",
    "register_divergence",
    "resolve_divergence",
]


class DivStats(NamedTuple):
    """Per-node Bregman sufficient statistics, heap-indexed like ``tree.W``."""

    sphi: torch.Tensor  # (n_nodes,)    sum_i w_i phi(x_i)
    sg: torch.Tensor    # (n_nodes, d)  sum_i w_i grad phi(x_i)
    sgx: torch.Tensor   # (n_nodes,)    sum_i w_i <grad phi(x_i), x_i>


def _node_sums(leaf_vals: torch.Tensor, L: int) -> torch.Tensor:
    """Bottom-up subtree sums, level-major then flat-concatenated (heap order)."""
    vals = [leaf_vals]
    for _ in range(L):
        vals.append(vals[-1].reshape((-1, 2) + tuple(vals[-1].shape[1:])).sum(1))
    return torch.cat(vals[::-1])


@dataclasses.dataclass(frozen=True, eq=False)
class Divergence:
    """One Bregman divergence: generator, block stats, tile, domain.

    Instances are immutable and hash/compare **by name**: factories embed a
    digest of their parameters in the name, so equal names imply equal
    behavior (the bind memo keys on it).
    """

    name: str
    _phi: Callable[[torch.Tensor], torch.Tensor]
    _grad_phi: Callable[[torch.Tensor], torch.Tensor]
    _pairwise: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    _log_partition: Callable[..., torch.Tensor]
    # value padded rows and ghosts are substituted with so domain functions
    # stay finite (1.0 for positive-domain divergences, 0.0 otherwise)
    pad_value: float = 0.0
    positive_domain: bool = False
    # optional point pre-map under which the divergence IS squared Euclidean
    # (Mahalanobis: x -> x * sqrt(m)); the kernels apply it outside and run
    # the squared-Euclidean tile
    _transform: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    # required trailing data dimension (parameterized metrics whose scale
    # vector must match d); None = any dimension
    required_dim: Optional[int] = None

    def __eq__(self, other) -> bool:
        return isinstance(other, Divergence) and other.name == self.name

    def __hash__(self) -> int:
        return hash((Divergence, self.name))

    # ------------------------------------------------------------ pointwise
    def phi(self, x: torch.Tensor) -> torch.Tensor:
        """Generator phi, (..., d) -> (...)."""
        return self._phi(x)

    def grad_phi(self, x: torch.Tensor) -> torch.Tensor:
        """Gradient of phi, (..., d) -> (..., d)."""
        return self._grad_phi(x)

    def pairwise(self, xa: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
        """Dense divergence matrix d_phi(xa_i, xb_j), (m, d), (n, d) -> (m, n)."""
        return self._pairwise(xa, xb).clamp_min(0.0)

    def tile(self, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
        """The streaming tile form of :meth:`pairwise`, in the operands' type:
        what the fused kernels' plain versions evaluate per tile pair."""
        return self._pairwise(rows, cols).clamp_min(0.0)

    def transform_points(self, x: torch.Tensor) -> torch.Tensor:
        """Point pre-map under which the divergence is squared Euclidean."""
        return x if self._transform is None else self._transform(x)

    @property
    def euclidean_after_transform(self) -> bool:
        """True when the kernels run the inline ``|a-b|^2`` tile on
        :meth:`transform_points`-mapped points instead of :meth:`tile`."""
        return self.name == "sqeuclidean" or self._transform is not None

    # --------------------------------------------------------------- domain
    def validate_domain(self, x) -> None:
        """Raise ``ValueError`` when ``x`` lies outside phi's domain, or its
        trailing dimension is not the one a parameterized metric needs."""
        arr = _host(x)
        if (self.required_dim is not None and arr.ndim
                and arr.shape[-1] != self.required_dim):
            raise ValueError(
                f"divergence {self.name!r} is parameterized for "
                f"{self.required_dim}-dimensional points, got d={arr.shape[-1]}")
        if not self.positive_domain:
            return
        lo = float(np.min(arr)) if arr.size else 1.0
        if not np.isfinite(lo) or lo <= 0.0:
            raise ValueError(
                f"divergence {self.name!r} requires strictly positive inputs; "
                f"got min={lo:g}. Shift/clip the data onto the positive "
                f"orthant or use divergence='sqeuclidean'.")

    def log_partition(self, dim, sigma) -> torch.Tensor:
        """Log-partition term of the similarity kernel ``exp(-D/(2 s^2))``.

        Exact (anisotropic) Gaussian normalizer for ``sqeuclidean`` and
        ``mahalanobis``; KL and Itakura-Saito use the same ``d/2 log(2 pi
        s^2)`` form as a surrogate base measure, so the eq.-12 bandwidth
        update stays the stationary point of the (surrogate) bound.
        """
        return self._log_partition(dim, sigma)

    # ----------------------------------------------------------------- bind
    def bind(self, tree: PartitionTree) -> "BoundDivergence":
        """Precompute the per-node Bregman stats for ``tree``; validates the
        real leaf data against phi's domain first."""
        if self.positive_domain or self.required_dim is not None:
            w = _host(tree.w_leaf)
            self.validate_domain(_host(tree.x_leaf)[w > 0])
        if self.name == "sqeuclidean":
            # block_div reads the given tree's own S1/S2
            return BoundDivergence(div=self, stats=None)
        return BoundDivergence(div=self, stats=_compute_stats(self, tree),
                               _tree_ref=weakref.ref(tree))


def _compute_stats(div: Divergence, tree: PartitionTree) -> DivStats:
    w = tree.w_leaf
    # ghosts sit at the origin, which may be out of domain (KL/IS): substitute
    # the in-domain pad value; the w = 0 factor keeps their contribution zero
    x = torch.where((w > 0)[:, None], tree.x_leaf,
                    torch.as_tensor(div.pad_value, dtype=tree.x_leaf.dtype,
                                    device=tree.x_leaf.device))
    g = div.grad_phi(x)
    return DivStats(
        sphi=_node_sums(div.phi(x) * w, tree.L),
        sg=_node_sums(g * w[:, None], tree.L),
        sgx=_node_sums((g * x).sum(-1) * w, tree.L),
    )


@dataclasses.dataclass(frozen=True)
class BoundDivergence:
    """A divergence bound to one tree: O(1)-per-block divergence evaluation.

    ``stats`` is ``None`` exactly for ``sqeuclidean``, whose block divergence
    reuses the tree's own ``S1``/``S2`` (eq. 9).
    """

    div: Divergence
    stats: Optional[DivStats]
    # the tree the stats were computed from (None for sqeuclidean):
    # block_div refuses any other tree, even one of the same shape
    _tree_ref: Optional[weakref.ref] = None

    @property
    def name(self) -> str:
        return self.div.name

    def block_div(self, tree: PartitionTree, a: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
        """D_AB = sum_{i in A, j in B} w_i w_j d_phi(x_i, x_j), O(1) per block."""
        wa, wb = tree.W[a], tree.W[b]
        if self.stats is None:  # sqeuclidean: the paper's eq. 9, verbatim
            d2 = wa * tree.S2[b] + wb * tree.S2[a] - 2.0 * (
                tree.S1[a] * tree.S1[b]).sum(-1)
            return d2.clamp_min(0.0)
        if self._tree_ref is not None and self._tree_ref() is not tree:
            raise ValueError(
                f"divergence {self.name!r} was bound to a different tree; "
                f"re-bind with bind_divergence({self.name!r}, tree)")
        s = self.stats
        d = (wb * s.sphi[a] - wa * s.sphi[b]
             - (tree.S1[a] * s.sg[b]).sum(-1) + wa * s.sgx[b])
        return d.clamp_min(0.0)

    def log_partition(self, dim, sigma) -> torch.Tensor:
        return self.div.log_partition(dim, sigma)

    def pairwise(self, xa: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
        return self.div.pairwise(xa, xb)


# =========================================================== the registry
_REGISTRY: dict[str, Divergence] = {}


def register_divergence(div: Divergence) -> Divergence:
    """Add ``div`` to the global registry (name must be unused)."""
    if div.name in _REGISTRY:
        raise ValueError(f"divergence {div.name!r} is already registered")
    _REGISTRY[div.name] = div
    return div


def get_divergence(name: str) -> Divergence:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown divergence {name!r}; registered: "
            f"{sorted(_REGISTRY)}") from None


def resolve_divergence(divergence) -> Divergence:
    """Canonicalize ``None`` | name | Divergence | BoundDivergence."""
    if divergence is None:
        return _REGISTRY["sqeuclidean"]
    if isinstance(divergence, BoundDivergence):
        return divergence.div
    if isinstance(divergence, Divergence):
        return divergence
    if isinstance(divergence, str):
        return get_divergence(divergence)
    raise TypeError(
        f"divergence must be None, a name, a Divergence or a BoundDivergence; "
        f"got {type(divergence).__name__}")


# bind memo: (divergence name, id(tree)) -> BoundDivergence.  Trees are
# immutable, so a bound divergence never goes stale; a weakref finalizer
# evicts the entry when the tree is collected (before its id can be reused).
# Public qopt/sigma entry points that take an unbound divergence per call
# thus pay the O(N d) stats pass and the domain scan once per (divergence,
# tree).
_BIND_CACHE: dict[tuple[str, int], BoundDivergence] = {}


def bind_divergence(divergence, tree: PartitionTree) -> BoundDivergence:
    """Resolve and bind in one step; already-bound divergences pass through."""
    if isinstance(divergence, BoundDivergence):
        return divergence
    div = resolve_divergence(divergence)
    key = (div.name, id(tree))
    hit = _BIND_CACHE.get(key)
    if hit is not None:
        return hit
    bound = div.bind(tree)
    _BIND_CACHE[key] = bound
    weakref.finalize(tree, _BIND_CACHE.pop, key, None)
    return bound


def adopt_bound(tree: PartitionTree, bound: BoundDivergence) -> BoundDivergence:
    """Seed the bind memo with an externally built :class:`BoundDivergence`
    (the streaming layer's patched stats); ``bound`` must reference ``tree``."""
    if bound._tree_ref is not None and bound._tree_ref() is not tree:
        raise ValueError("adopt_bound: bound divergence references another tree")
    key = (bound.name, id(tree))
    _BIND_CACHE[key] = bound
    weakref.finalize(tree, _BIND_CACHE.pop, key, None)
    return bound


# ===================================================== concrete divergences
def _gaussian_log_partition(dim, sigma):
    return 0.5 * dim * torch.log(torch.as_tensor(2.0 * math.pi * sigma * sigma))


def _sqe_pairwise(xa, xb):
    an = (xa * xa).sum(-1)
    bn = (xb * xb).sum(-1)
    return an[:, None] + bn[None, :] - 2.0 * (xa @ xb.T)


SQEUCLIDEAN = register_divergence(Divergence(
    name="sqeuclidean",
    _phi=lambda x: (x * x).sum(-1),
    _grad_phi=lambda x: 2.0 * x,
    _pairwise=_sqe_pairwise,
    _log_partition=_gaussian_log_partition,
))


def _kl_pairwise(xa, xb):
    # d(a, b) = sum_k a log(a/b) - a + b   (generalized KL)
    row = (xa * torch.log(xa)).sum(-1) - xa.sum(-1)
    return row[:, None] + xb.sum(-1)[None, :] - xa @ torch.log(xb).T


KL = register_divergence(Divergence(
    name="kl",
    _phi=lambda x: (x * torch.log(x)).sum(-1),
    _grad_phi=lambda x: torch.log(x) + 1.0,
    _pairwise=_kl_pairwise,
    # surrogate Gaussian-form base measure: see Divergence.log_partition
    _log_partition=_gaussian_log_partition,
    pad_value=1.0,
    positive_domain=True,
))


def _is_pairwise(xa, xb):
    # d(a, b) = sum_k a/b - log(a/b) - 1
    d = xa.shape[-1]
    return (xa @ (1.0 / xb).T - torch.log(xa).sum(-1)[:, None]
            + torch.log(xb).sum(-1)[None, :] - float(d))


ITAKURA_SAITO = register_divergence(Divergence(
    name="itakura_saito",
    _phi=lambda x: -torch.log(x).sum(-1),
    _grad_phi=lambda x: -1.0 / x,
    _pairwise=_is_pairwise,
    # surrogate Gaussian-form base measure: see Divergence.log_partition
    _log_partition=_gaussian_log_partition,
    pad_value=1.0,
    positive_domain=True,
))


def mahalanobis(scale) -> Divergence:
    """Diagonal Mahalanobis divergence ``d(a, b) = sum_k m_k (a_k - b_k)^2``.

    ``scale`` is the per-dimension metric ``m`` (strictly positive).  Each
    distinct scale yields its own named ``Divergence`` (the name embeds the
    first 8 hex digits of the sha1 of ``m`` as float64), so two models with
    different metrics never share a name.  ``phi(x) = sum_k m_k x_k^2``; the
    log-partition is ``d/2 log(2 pi s^2) - 1/2 sum log m``.
    """
    m_tuple = tuple(float(s) for s in np.asarray(scale, np.float64).reshape(-1))
    if not m_tuple or min(m_tuple) <= 0.0:
        raise ValueError(
            f"mahalanobis scale must be non-empty and strictly positive, "
            f"got {m_tuple}")
    # only the scalar identity gets the bare registry name: a length-k ones
    # vector pins required_dim=k, and names must imply behavior
    if len(m_tuple) == 1 and m_tuple[0] == 1.0:
        name = "mahalanobis"
    else:
        digest = hashlib.sha1(np.asarray(m_tuple).tobytes()).hexdigest()[:8]
        name = f"mahalanobis[{digest}]"
    log_m = np.log(np.asarray(m_tuple))

    def _m(x: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(m_tuple, dtype=torch.float32, device=x.device)

    def _root(x: torch.Tensor) -> torch.Tensor:
        return x * torch.sqrt(_m(x))

    def log_part(dim, sigma):
        # a length-1 scale broadcasts over all dim coordinates, so its
        # normalizer term counts dim times; a vector counts once per entry
        metric = dim * float(log_m[0]) if len(m_tuple) == 1 else float(log_m.sum())
        return _gaussian_log_partition(dim, sigma) - 0.5 * metric

    return Divergence(
        name=name,
        _phi=lambda x: (_m(x) * x * x).sum(-1),
        _grad_phi=lambda x: 2.0 * _m(x) * x,
        _pairwise=lambda xa, xb: _sqe_pairwise(_root(xa), _root(xb)),
        _log_partition=log_part,
        _transform=_root,
        required_dim=len(m_tuple) if len(m_tuple) > 1 else None,
    )


MAHALANOBIS = register_divergence(mahalanobis(np.ones(1)))

# public view of the registry (read-only by convention)
DIVERGENCES = _REGISTRY
