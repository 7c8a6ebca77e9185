"""``repro_torch/kernels/flash_attention/flash_attention.py`` ↔ ``repro/kernels/flash_attention/flash_attention.py``.

The plain-torch version of K6: online-softmax attention walked over
key/value tiles of the kernel's width, never materializing more than one
``(S, tile)`` block of scores.  It repeats the recurrence of the kernel that
the operands' type selects (``ops.py``):

- float32 (``csrc/flash_attention.cu``, the port of the reference's
  ``flash_attention_kernel``): ``q`` is upcast and scaled by ``D ** -0.5``
  before the product; a masked logit is ``-1e30``; per key tile
  ``m' = max(m, rowmax)``, ``alpha = exp(m - m')``, ``p = exp(logit - m')``,
  ``s = s * alpha + sum p``, ``acc = acc * alpha + p @ v``.
- bfloat16 (``csrc/flash_attention_sm90.cu``, on the tensor cores): tiles of
  64 keys at every head width; the scale ``D ** -0.5 * log2(e)`` is applied
  to the float32 logits ``q @ k^T``; ``alpha = 2 ** (m - m')``,
  ``p = 2 ** (logit - m')``, ``s = s * alpha + sum p`` over the float32
  ``p``, and ``acc = acc * alpha + bf16(p) @ v``: ``p`` is rounded to
  bfloat16 before its product with ``v``, as the tensor cores take it (the
  reference keeps ``p`` in float32; the reference's bfloat16 tolerance,
  ``5e-2``, covers the difference).  The kernel folds the scale into one
  fused multiply-add inside ``2 ** x`` and masks with ``-inf``; both give
  a masked key ``p = 0`` here, up to the rounding of the scaled logits.

Both: ``m``, ``s`` and ``acc`` are float32; the output is
``acc / max(s, 1e-38)`` in ``q.dtype``.  Query head ``h`` reads key/value
head ``h // (Hq / Hkv)``.  Keys at or past ``S`` are masked, as in the
reference's ``ref.py`` (the reference kernel instead lets zero-padded keys
into the softmax when ``causal=False`` and ``S`` is not a multiple of its
tile; that quirk is not copied).

Which query rows a tile is applied to may differ from the kernels' (they
skip tiles per query tile, this version per row range): a tile that is
wholly masked for a row is a no-op on that row's state (see the kernels'
notes), so the two walks agree up to the order of sums inside a tile's
products.
"""
from __future__ import annotations

import math

import torch

__all__ = ["LOG2E", "NEG_BIG", "flash_attention_plain", "kv_tile"]

NEG_BIG = -1e30  # masked logits, as in the reference kernel
LOG2E = math.log2(math.e)


def kv_tile(head_dim: int, dtype: torch.dtype = torch.float32) -> int:
    """The kernel's key/value tile width for ``head_dim`` and ``dtype``.

    float32: 64, or 32 at ``D = 256`` so that a block's float32 tiles fit in
    shared memory.  bfloat16: 64, one ``wgmma`` N, at every head width.
    """
    if dtype == torch.bfloat16:
        return 64
    return 32 if head_dim >= 256 else 64


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """``q`` (B, Hq, S, D), ``k``/``v`` (B, Hkv, S, D) -> (B, Hq, S, D)."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    tensor_cores = q.dtype == torch.bfloat16
    bk = kv_tile(d, q.dtype)
    dev = q.device
    if tensor_cores:
        scale, exp = float(d) ** -0.5 * LOG2E, torch.exp2
        qf = q.to(torch.float32).reshape(b, hkv, g, s, d)
    else:
        scale, exp = 1.0, torch.exp
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
        if tensor_cores:
            logits = logits * scale
        logits = torch.where(mask, logits, NEG_BIG)
        m_prev = m[..., lo:hi]
        m_new = torch.maximum(m_prev, logits.amax(dim=-1))
        alpha = exp(m_prev - m_new)
        p = exp(logits - m_new[..., None])
        tot[..., lo:hi] = tot[..., lo:hi] * alpha + p.sum(dim=-1)
        if tensor_cores:
            p = p.to(torch.bfloat16).to(torch.float32)
        acc[..., lo:hi, :] = acc[..., lo:hi, :] * alpha[..., None] \
            + p @ vf[:, :, None, k0:k1]
        m[..., lo:hi] = m_new
    out = acc / tot.clamp_min(1e-38)[..., None]
    return out.reshape(b, hq, s, d).to(q.dtype)
