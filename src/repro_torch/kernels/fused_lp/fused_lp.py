"""``repro_torch/kernels/fused_lp/fused_lp.py`` ↔ ``repro/kernels/fused_lp/fused_lp.py``.

The plain-torch form of the online-softmax tile recurrence that the fused
label-propagation kernels run (the reference's ``stream_tile_update``), and
:func:`matvec_plain`, the plain version of K2 (the reference's
``fused_lp_matvec_kernel``): ``P @ Y`` with no eq.-15 epilogue.  The CUDA
kernels in ``csrc/folded_lp.cu`` run the same recurrence with the same masks;
this form is what the CPU path runs and what the kernels are held against on
the card.  The plain versions compute in the type of the labels ``y``:
float32 on every path of the port, float64 for the float64 reference that
the card's precision gate holds the kernels to.

:func:`tile_config` maps a divergence to its tile, as the reference's
``tile_config`` does: the inline squared-Euclidean tile for ``sqeuclidean``
and for divergences that are squared Euclidean after a point pre-map
(Mahalanobis, whose transform the callers apply outside), else the
divergence's own :meth:`~repro_torch.core.divergence.Divergence.tile`
(``tile_fn`` of the plain versions).  The plain versions slice ragged tiles
instead of padding, so they read no padded point and ``pad_value`` never
enters them.
"""
from __future__ import annotations

import torch

__all__ = ["NEG_BIG", "PLAIN_BLOCK_M", "PLAIN_BLOCK_N", "REF_BLOCK_N",
           "matvec_plain", "softmax_average", "stream_tile_update",
           "tile_config"]

# masked logits; finite (not -inf) so an all-masked tile behaves as in the
# reference: m stays NEG_BIG, and the first real logit scales it away
NEG_BIG = -1e30

# the reference's default column tile.  It pads the columns to a multiple of
# it, and a row whose every column is masked (N = 1) counts each padded column
# at weight exp(NEG_BIG - NEG_BIG) = 1, so its normalizer is round_up(N, 256)
REF_BLOCK_N = 256

# tile sizes of the plain versions: large, so that on the card a full-size
# step is a few hundred matrix products rather than a million tiny ones
PLAIN_BLOCK_M = 4096
PLAIN_BLOCK_N = 8192


def ref_padded_columns(n: int) -> int:
    """The reference's padded column count for ``n`` points."""
    return -(-n // REF_BLOCK_N) * REF_BLOCK_N


def tile_config(divergence):
    """``(tile, pad_value, transform)`` for a divergence spec.

    ``tile=None`` selects the inline squared-Euclidean tile: for
    ``sqeuclidean`` and for divergences that are squared Euclidean after
    ``transform`` (Mahalanobis), which the caller applies to the points
    outside the kernel.  Other divergences (KL, Itakura-Saito, custom ones)
    return themselves as ``tile``: the plain versions evaluate ``tile.tile``,
    the CUDA kernels the hand-written tile of its name.
    """
    from repro_torch.core.divergence import resolve_divergence

    div = resolve_divergence(divergence)
    if div.name == "sqeuclidean":
        return None, 0.0, None  # identity transform: skip the extra op
    if div.euclidean_after_transform:
        return None, div.pad_value, div.transform_points
    return div, div.pad_value, div.transform_points


def stream_tile_update(x: torch.Tensor, xc: torch.Tensor, y_tile: torch.Tensor,
                       m: torch.Tensor, s: torch.Tensor, acc: torch.Tensor,
                       row_ids: torch.Tensor, col_ids: torch.Tensor, *,
                       inv_two_sigma_sq: float, n_valid: int, tile_fn=None):
    """One column-tile step of the online softmax; returns ``(m, s, acc)``.

    ``x`` (bm, d) and ``xc`` (bn, d) are the row and column point tiles,
    ``y_tile`` (bn, K) the column tile of labels, ``(m, s, acc)`` the running
    max (bm,), normalizer (bm,) and accumulator (bm, K).  ``row_ids`` (bm,)
    are global row ids (``row_base`` included) and ``col_ids`` (bn,) global
    column ids: the self-transition ``row == col`` and columns at or past
    ``n_valid`` get ``NEG_BIG``.  ``tile_fn`` (rows, cols) -> (bm, bn)
    replaces the inline squared-Euclidean tile (a divergence's ``tile``).
    """
    if tile_fn is None:
        xx = (x * x).sum(-1)
        cc = (xc * xc).sum(-1)
        d2 = xx[:, None] + cc[None, :] - 2.0 * (x @ xc.T)
    else:
        d2 = tile_fn(x, xc)
    logits = -d2.clamp_min(0.0) * inv_two_sigma_sq
    invalid = (row_ids[:, None] == col_ids[None, :]) | (col_ids[None, :] >= n_valid)
    logits = torch.where(invalid, NEG_BIG, logits)

    m_new = torch.maximum(m, logits.amax(dim=1))
    scale = torch.exp(m - m_new)
    p = torch.exp(logits - m_new[:, None])
    s = s * scale + p.sum(dim=1)
    acc = acc * scale[:, None] + p @ y_tile
    return m_new, s, acc


def softmax_average(m: torch.Tensor, s: torch.Tensor, acc: torch.Tensor,
                    n: int) -> torch.Tensor:
    """``acc / max(s, 1e-38)`` at the end of the column walk over ``n`` columns.

    A row that saw only masked columns (``m`` still ``NEG_BIG``) divides by the
    reference's padded column count instead, as the reference does.
    """
    s = torch.where(m == NEG_BIG, float(ref_padded_columns(n)), s)
    return acc / s.clamp_min(1e-38)[:, None]


def stream_rows(rows: torch.Tensor, cols: torch.Tensor, y: torch.Tensor,
                inv_two_sigma_sq: float, row_base: int, block_m: int,
                block_n: int, tile_fn=None):
    """Yield ``(i0, i1, py)``: ``P @ y`` for row tiles of ``rows``, streamed."""
    n_rows, n = rows.shape[0], cols.shape[0]
    k = y.shape[1]
    dev = rows.device
    col_ids = torch.arange(n, device=dev)
    for i0 in range(0, n_rows, block_m):
        i1 = min(i0 + block_m, n_rows)
        row_ids = row_base + torch.arange(i0, i1, device=dev)
        m = torch.full((i1 - i0,), NEG_BIG, dtype=y.dtype, device=dev)
        s = torch.zeros((i1 - i0,), dtype=y.dtype, device=dev)
        acc = torch.zeros((i1 - i0, k), dtype=y.dtype, device=dev)
        for j0 in range(0, n, block_n):
            j1 = min(j0 + block_n, n)
            m, s, acc = stream_tile_update(
                rows[i0:i1], cols[j0:j1], y[j0:j1], m, s, acc, row_ids,
                col_ids[j0:j1], inv_two_sigma_sq=inv_two_sigma_sq, n_valid=n,
                tile_fn=tile_fn)
        yield i0, i1, softmax_average(m, s, acc, n)


def matvec_plain(x: torch.Tensor, y: torch.Tensor, inv_two_sigma_sq: float, *,
                 tile_fn=None, block_m: int = PLAIN_BLOCK_M,
                 block_n: int = PLAIN_BLOCK_N) -> torch.Tensor:
    """``P @ y`` for points ``x`` (N, d) and labels ``y`` (N, C) (plain torch).

    The plain version of K2: the same online softmax, epilogue ``acc / s``.
    """
    out = torch.empty(y.shape, dtype=y.dtype, device=x.device)
    for i0, i1, py in stream_rows(x, x, y, inv_two_sigma_sq, 0, block_m,
                                  block_n, tile_fn):
        out[i0:i1] = py
    return out
