"""The comparison that decides ``correct``: served answers against the
plain reference."""
from __future__ import annotations

import torch


def answer_err(served: torch.Tensor, ref: torch.Tensor,
               y0: torch.Tensor) -> float:
    """Largest error of one request's answer, over its columns.

    Only the rows a column leaves unlabelled are read: there the answer is
    the walk's own term (alpha (P Y)_i, all sums of positive terms), while a
    labelled row carries (1 - alpha) as well, whose float32 rounding would
    hide an error of the walk.  A column's error is its largest absolute
    error there over its largest reference value there.
    """
    served = served.to(torch.float64)
    if served.shape != ref.shape or not bool(torch.isfinite(served).all()):
        return float("inf")
    free = (y0 == 0).to(torch.float64)
    err = ((served - ref).abs() * free).amax(0)
    scale = (ref.abs() * free).amax(0)
    return float((err / scale).max())
