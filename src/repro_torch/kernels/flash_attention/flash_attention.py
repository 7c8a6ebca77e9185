"""``repro_torch/kernels/flash_attention/flash_attention.py`` ↔ ``repro/kernels/flash_attention/flash_attention.py``.

The plain-torch version of K6 (``csrc/flash_attention.cu``, the port of the
reference's ``flash_attention_kernel``): online-softmax attention walked over
key/value tiles of the kernel's width, never materializing more than one
``(S, tile)`` block of scores.

It repeats the kernel's recurrence: ``q`` is upcast and scaled by
``D ** -0.5`` before the product; a masked logit is ``-1e30``; per key tile
``m' = max(m, rowmax)``, ``alpha = exp(m - m')``, ``p = exp(logit - m')``,
``s = s * alpha + sum p``, ``acc = acc * alpha + p @ v``; the output is
``acc / max(s, 1e-38)`` in ``q.dtype``.  Query head ``h`` reads key/value
head ``h // (Hq / Hkv)``.  Keys at or past ``S`` are masked, as in the
reference's ``ref.py`` (the reference kernel instead lets zero-padded keys
into the softmax when ``causal=False`` and ``S`` is not a multiple of its
tile; that quirk is not copied).

Which query rows a tile is applied to may differ from the kernel's (the
kernel skips tiles per query tile, this version per row range): a tile that
is wholly masked for a row is a no-op on that row's state, bit for bit (see
the kernel's note), so the two walks agree up to the order of sums inside a
tile's products.
"""
from __future__ import annotations

import torch

__all__ = ["NEG_BIG", "flash_attention_plain", "kv_tile"]

NEG_BIG = -1e30  # masked logits, as in the reference kernel


def kv_tile(head_dim: int) -> int:
    """The kernel's key/value tile width for ``head_dim``: 64, or 32 at
    ``D = 256`` so that a block's float32 tiles fit in shared memory."""
    return 32 if head_dim >= 256 else 64


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """``q`` (B, Hq, S, D), ``k``/``v`` (B, Hkv, S, D) -> (B, Hq, S, D)."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    bk = kv_tile(d)
    dev = q.device
    qf = (q.to(torch.float32) * (float(d) ** -0.5)).reshape(b, hkv, g, s, d)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    m = torch.full((b, hkv, g, s), NEG_BIG, dtype=torch.float32, device=dev)
    tot = torch.zeros((b, hkv, g, s), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, s, d), dtype=torch.float32, device=dev)
    for k0 in range(0, s, bk):
        k1 = min(k0 + bk, s)
        # rows for which this tile holds at least one unmasked key
        lo = k0 if causal else 0
        hi = min(s, k1 - 1 + window) if window > 0 else s
        if lo >= hi:
            continue
        qi = torch.arange(lo, hi, device=dev)[:, None]
        kj = torch.arange(k0, k1, device=dev)[None, :]
        mask = torch.ones((hi - lo, k1 - k0), dtype=torch.bool, device=dev)
        if causal:
            mask &= kj <= qi
        if window > 0:
            mask &= (qi - kj) < window
        logits = qf[:, :, :, lo:hi] @ kf[:, :, None, k0:k1].transpose(-1, -2)
        logits = torch.where(mask, logits, NEG_BIG)
        m_prev = m[..., lo:hi]
        m_new = torch.maximum(m_prev, logits.amax(dim=-1))
        alpha = torch.exp(m_prev - m_new)
        p = torch.exp(logits - m_new[..., None])
        tot[..., lo:hi] = tot[..., lo:hi] * alpha + p.sum(dim=-1)
        acc[..., lo:hi, :] = acc[..., lo:hi, :] * alpha[..., None] \
            + p @ vf[:, :, None, k0:k1]
        m[..., lo:hi] = m_new
    out = acc / tot.clamp_min(1e-38)[..., None]
    return out.reshape(b, hq, s, d).to(q.dtype)
