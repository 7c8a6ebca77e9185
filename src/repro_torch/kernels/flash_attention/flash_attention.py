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
The walk updates its state in place, so it is not differentiated by
autograd: a gradient goes through ``ops.flash_attention``, whose backward is
:func:`flash_attention_backward`.
"""
from __future__ import annotations

import math

import torch

__all__ = ["BACKWARD_CHUNK", "KV_TILE", "LOG2E", "NEG_BIG", "attention_pairs",
           "attention_work", "flash_attention_backward",
           "flash_attention_plain"]

NEG_BIG = -1e30  # masked logits, as in the reference kernel
LOG2E = math.log2(math.e)
KV_TILE = 64     # the kernels' key tile, one wgmma N, at every width and type
# the backward's float32 score blocks hold at most this many elements each
BACKWARD_CHUNK = 1 << 26


def _mask(s: int, causal: bool, window: int, device) -> torch.Tensor:
    """(S, S) boolean: key j is visible to query i."""
    qi = torch.arange(s, device=device)[:, None]
    kj = torch.arange(s, device=device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=device)
    if causal:
        mask &= kj <= qi
    if window > 0:
        mask &= (qi - kj) < window
    return mask


def attention_pairs(s: int, window: int, causal: bool = True) -> int:
    """(query, key) pairs attention keeps at length ``s``: causal keys
    ``j <= i`` (and ``i - j < window`` when ``window`` > 0); bidirectional
    keys ``j > i - window`` (all when ``window`` is 0)."""
    if causal:
        if not window or window >= s:
            return s * (s + 1) // 2
        return window * (window + 1) // 2 + (s - window) * window
    if not window or window > s:
        return s * s
    return s * s - (s - window) * (s - window + 1) // 2


def attention_work(b: int, hq: int, hkv: int, s: int, d: int, window: int,
                   itemsize: int, causal: bool = True) -> tuple[float, float]:
    """Operations and bytes of attention over the unmasked pairs: two
    products of 2 B Hq D flops per pair; q, k, v read and out written once."""
    flops = 4.0 * b * hq * d * attention_pairs(s, window, causal)
    nbytes = itemsize * (2.0 * b * hq * s * d + 2.0 * b * hkv * s * d)
    return flops, nbytes


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """``q`` (B, Hq, S, D), ``k``/``v`` (B, Hkv, S, D) -> (B, Hq, S, D).

    Raises ``RuntimeError`` when grad mode is on and an input requires a
    gradient: the walk's in-place updates cannot be differentiated.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention_plain updates its state in place and cannot be "
            "differentiated; call ops.flash_attention, whose backward is "
            "flash_attention_backward")
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


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, dout: torch.Tensor,
                             causal: bool = True, window: int = 0):
    """``(dq, dk, dv)`` of attention at ``q``, ``k``, ``v`` for the output's
    cotangent ``dout`` (B, Hq, S, D), each in its input's dtype.

    Not a port of a Pallas kernel: the reference has no Pallas backward (its
    models differentiate a masked einsum with ``jax.value_and_grad``), so
    this is plain torch, as the reference's backward is XLA ops.  It
    recomputes the scores densely in float32 (float64 for float64 inputs)
    under the forward's masks (causal, window; the dense form has no keys at
    or past S), ``p = softmax(q k^T D^-0.5)``, then ``dv = p^T dout``,
    ``ds = p * (dp - rowsum(p * dp))`` with ``dp = dout v^T``,
    ``dq = ds k D^-0.5`` and ``dk = ds^T q D^-0.5``; a GQA group's query
    heads are summed onto their key/value head.  The rowsum is taken over
    ``p * dp``, not ``dout * out``, so the gradient does not carry the
    forward's bfloat16 rounding.  Key/value heads are taken in chunks whose
    score blocks hold at most ``BACKWARD_CHUNK`` elements.
    """
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    work = torch.float64 if q.dtype == torch.float64 else torch.float32
    scale = float(d) ** -0.5
    hidden = ~_mask(s, causal, window, q.device)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    step = max(1, BACKWARD_CHUNK // (b * g * s * s))
    for h0 in range(0, hkv, step):
        h1 = min(h0 + step, hkv)
        qc = q[:, h0 * g:h1 * g].to(work).reshape(b, h1 - h0, g, s, d)
        doc = dout[:, h0 * g:h1 * g].to(work).reshape(b, h1 - h0, g, s, d)
        kc = k[:, h0:h1, None].to(work)
        vc = v[:, h0:h1, None].to(work)
        p = torch.softmax((qc @ kc.transpose(-1, -2)).mul_(scale)
                          .masked_fill_(hidden, float("-inf")), dim=-1)
        dv[:, h0:h1] = (p.transpose(-1, -2) @ doc).sum(2)
        ds = doc @ vc.transpose(-1, -2)
        ds.sub_((p * ds).sum(-1, keepdim=True)).mul_(p)
        del p
        dq[:, h0 * g:h1 * g] = (ds @ kc).mul_(scale).reshape(
            b, (h1 - h0) * g, s, d)
        dk[:, h0:h1] = (ds.transpose(-1, -2) @ qc).sum(2).mul_(scale)
    return dq, dk, dv
