"""``repro_torch/kernels/fused_lp/fused_lp.py`` ↔ ``repro/kernels/fused_lp/fused_lp.py``.

The plain-torch form of the online-softmax tile recurrence that the fused
label-propagation kernel runs (the reference's ``stream_tile_update``).  The
CUDA kernel in ``csrc/folded_lp.cu`` runs the same recurrence with the same
masks; this form is what the CPU path runs and what the kernel is held
against on the card.
"""
from __future__ import annotations

import torch

__all__ = ["NEG_BIG", "stream_tile_update"]

# masked logits; finite (not -inf) so an all-masked tile behaves as in the
# reference: m stays NEG_BIG, and the first real logit scales it away
NEG_BIG = -1e30


def stream_tile_update(x: torch.Tensor, xc: torch.Tensor, y_tile: torch.Tensor,
                       m: torch.Tensor, s: torch.Tensor, acc: torch.Tensor,
                       row_ids: torch.Tensor, col_ids: torch.Tensor, *,
                       inv_two_sigma_sq: float, n_valid: int):
    """One column-tile step of the online softmax; returns ``(m, s, acc)``.

    ``x`` (bm, d) and ``xc`` (bn, d) are the row and column point tiles,
    ``y_tile`` (bn, K) the column tile of labels, ``(m, s, acc)`` the running
    max (bm,), normalizer (bm,) and accumulator (bm, K).  ``row_ids`` (bm,)
    are global row ids (``row_base`` included) and ``col_ids`` (bn,) global
    column ids: the self-transition ``row == col`` and columns at or past
    ``n_valid`` get ``NEG_BIG``.
    """
    xx = (x * x).sum(-1)
    cc = (xc * xc).sum(-1)
    d2 = xx[:, None] + cc[None, :] - 2.0 * (x @ xc.T)
    logits = -d2.clamp_min(0.0) * inv_two_sigma_sq
    invalid = (row_ids[:, None] == col_ids[None, :]) | (col_ids[None, :] >= n_valid)
    logits = torch.where(invalid, NEG_BIG, logits)

    m_new = torch.maximum(m, logits.amax(dim=1))
    scale = torch.exp(m - m_new)
    p = torch.exp(logits - m_new[:, None])
    s = s * scale + p.sum(dim=1)
    acc = acc * scale[:, None] + p @ y_tile
    return m_new, s, acc
