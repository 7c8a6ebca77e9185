"""``repro_torch/kernels/flash_attention/flash_attention.py`` ↔ ``repro/kernels/flash_attention/flash_attention.py``.

The plain-torch version of K6: online-softmax attention walked over
key/value tiles of the kernels' width (``KV_TILE``, 64 keys), never materializing more
than one ``(S, tile)`` block of scores.  It repeats the recurrence of both
kernels (``ops.py``; ``csrc/flash_attention_tf32x3.cu`` for float32 and
``csrc/flash_attention_sm90.cu`` for bfloat16, both on the tensor cores):
the logits ``q @ k^T`` are float32, the scale ``D ** -0.5 * log2(e)`` is
applied to them, a masked logit is ``-1e30``, and per key tile
``m' = max(m, rowmax)``, ``alpha = 2 ** (m - m')``, ``p = 2 ** (logit - m')``,
``s = s * alpha + sum p``, ``acc = acc * alpha + p @ v``.  In bfloat16, ``p``
is rounded to bfloat16 before its product with ``v``, as the tensor cores
take it (the reference keeps ``p`` in float32; its bfloat16 tolerance,
``5e-2``, covers the difference); the sum ``s`` is over the float32 ``p``.
The float32 kernel keeps float32 accuracy with three TF32 products of split
operands, which this version does not model: it computes in float32.  The
kernels fold the scale into one fused multiply-add inside ``2 ** x`` and
mask with ``-inf``; both give a masked key ``p = 0`` here, up to the
rounding of the scaled logits.

``m``, ``s`` and ``acc`` are float32 (float64 for float64 operands, the
precision gate's reference); the output is ``acc / max(s, 1e-38)`` in
``q.dtype``.  Query head ``h`` reads key/value head ``h // (Hq / Hkv)``.
Keys at or past ``S`` are masked, as in the reference's ``ref.py`` (the
reference kernel instead lets zero-padded keys into the softmax when
``causal=False`` and ``S`` is not a multiple of its tile; that quirk is not
copied).

Which query rows a tile is applied to may differ from the kernels' (they
skip tiles per query tile, this version per row range): a tile that is
wholly masked for a row is a no-op on that row's state (alpha = 1, p = 0),
so the two walks agree up to the order of sums inside a tile's products.
"""
from __future__ import annotations

import math

import torch

__all__ = ["KV_TILE", "LOG2E", "NEG_BIG", "flash_attention_plain"]

NEG_BIG = -1e30  # masked logits, as in the reference kernel
LOG2E = math.log2(math.e)
KV_TILE = 64     # the kernels' key tile, one wgmma N, at every width and type

def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """``q`` (B, Hq, S, D), ``k``/``v`` (B, Hkv, S, D) -> (B, Hq, S, D)."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    bk = KV_TILE
    dev = q.device
    work = torch.float64 if q.dtype == torch.float64 else torch.float32
    scale = float(d) ** -0.5 * LOG2E
    qf = q.to(work).reshape(b, hkv, g, s, d)
    kf, vf = k.to(work), v.to(work)
    m = torch.full((b, hkv, g, s), NEG_BIG, dtype=work, device=dev)
    tot = torch.zeros((b, hkv, g, s), dtype=work, device=dev)
    acc = torch.zeros((b, hkv, g, s, d), dtype=work, device=dev)
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
        logits = (qf[:, :, :, lo:hi]
                  @ kf[:, :, None, k0:k1].transpose(-1, -2)) * scale
        logits = torch.where(mask, logits, NEG_BIG)
        m_prev = m[..., lo:hi]
        m_new = torch.maximum(m_prev, logits.amax(dim=-1))
        alpha = torch.exp2(m_prev - m_new)
        p = torch.exp2(logits - m_new[..., None])
        tot[..., lo:hi] = tot[..., lo:hi] * alpha + p.sum(dim=-1)
        if q.dtype == torch.bfloat16:
            p = p.to(torch.bfloat16).to(work)
        acc[..., lo:hi, :] = acc[..., lo:hi, :] * alpha[..., None] \
            + p @ vf[:, :, None, k0:k1]
        m[..., lo:hi] = m_new
    out = acc / tot.clamp_min(1e-38)[..., None]
    return out.reshape(b, hq, s, d).to(q.dtype)
