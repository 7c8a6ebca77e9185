"""``repro_torch/kernels/flash_attention/ref.py`` ↔ ``repro/kernels/flash_attention/ref.py``.

The naive oracle for K6: masked attention with the ``(S, S)`` scores
materialized, in float32, output in ``q.dtype``.  Keys are masked by
``causal`` and ``window`` only; tests and the chip smoke use it at small
shapes.
"""
from __future__ import annotations

import torch

__all__ = ["flash_attention_ref"]


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """``q`` (B, Hq, S, D), ``k``/``v`` (B, Hkv, S, D) -> (B, Hq, S, D)."""
    s, d = q.shape[2], q.shape[3]
    rep = q.shape[1] // k.shape[1]
    kf = k.to(torch.float32).repeat_interleave(rep, dim=1)
    vf = v.to(torch.float32).repeat_interleave(rep, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), kf) \
        * (d ** -0.5)
    qi = torch.arange(s, device=q.device)[:, None]
    kj = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window > 0:
        mask &= (qi - kj) < window
    logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)
