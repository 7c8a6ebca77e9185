"""``repro_torch/models/attention.py`` ↔ ``repro/models/attention.py``.

Grouped-query attention with causal / sliding-window / bidirectional masks,
RoPE, and a KV-cache decode path (full cache or sliding-window ring buffer).

Self-attention (``kv_x is None``) runs its masked softmax through K6,
``kernels.flash_attention.flash_attention``: the heads are moved to
``(B, H, S, D)``, the key/value head of query head ``h`` is ``h // group``
inside the kernel (no repeated K/V), and a window at least as long as the
sequence (``HUGE_WINDOW`` included) is passed as no window.  K6 applies the
masks of the reference's ``_mask`` itself, so that helper has no
counterpart here; K6 is differentiable (its backward recomputes the scores
in float32 torch ops).  Cross-attention (``kv_x``: ``cross_kv`` projects the
source, ``cross_attend`` attends over given K/V, as whisper's decoder does
over its cached encoder K/V) and the one-token decode keep the reference's
einsum form in plain torch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import dense_init, rope

__all__ = ["KVCache", "attn_apply", "attn_decode", "attn_init", "cross_attend",
           "cross_kv", "init_cache", "self_attention"]


@dataclasses.dataclass(frozen=True)
class KVCache:
    k: torch.Tensor     # (B, W, Hkv, D), W = cache window (<= full seq)
    v: torch.Tensor     # (B, W, Hkv, D)
    pos: torch.Tensor   # () int32: absolute position of the next token
    # ring buffer (SWA, O(window) memory) vs linear cache
    ring: bool = False


def attn_init(generator: torch.Generator, cfg, *, device) -> dict:
    d, hd = cfg.d_model, cfg.head_dim_
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    return {
        "w_q": dense_init(generator, d, hq * hd, device=device),
        "w_k": dense_init(generator, d, hkv * hd, device=device),
        "w_v": dense_init(generator, d, hkv * hd, device=device),
        "w_o": dense_init(generator, hq * hd, d, scale=(hq * hd) ** -0.5,
                          device=device),
    }


def _split_heads(x: torch.Tensor, n_heads: int, head_dim: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, head_dim)


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def _kernel_window(window: Optional[int], s: int) -> int:
    """K6's window argument: 0 (none) for a window that masks nothing."""
    if window is None or int(window) >= s:
        return 0
    return int(window)


def self_attention(params: dict, x: torch.Tensor, cfg,
                   positions: torch.Tensor, causal: bool = True,
                   window: Optional[int] = None, use_rope: bool = True):
    """Self-attention through K6; returns ``(out, k, v)`` with ``k`` (after
    RoPE) and ``v`` as ``(B, S, Hkv, D)``, the layout of the KV cache."""
    dt = x.dtype
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    b, s, _ = x.shape
    q = _split_heads(x @ params["w_q"].to(dt), hq, hd)
    k = _split_heads(x @ params["w_k"].to(dt), hkv, hd)
    v = _split_heads(x @ params["w_v"].to(dt), hkv, hd)
    if use_rope:
        q, k = rope(q, k, positions, cfg.rope_theta)
    o = flash_attention(q.transpose(1, 2).contiguous(),
                        k.transpose(1, 2).contiguous(),
                        v.transpose(1, 2).contiguous(), causal=causal,
                        window=_kernel_window(window, s))
    o = o.transpose(1, 2).reshape(b, s, hq * hd)
    return o @ params["w_o"].to(dt), k, v


def cross_kv(params: dict, kv_x: torch.Tensor, cfg):
    """Cross-attention's K and V of the source ``kv_x`` (B, T, D_model), each
    ``(B, T, Hkv, D)``, no RoPE."""
    dt = kv_x.dtype
    hkv, hd = cfg.n_kv_heads, cfg.head_dim_
    return (_split_heads(kv_x @ params["w_k"].to(dt), hkv, hd),
            _split_heads(kv_x @ params["w_v"].to(dt), hkv, hd))


def cross_attend(params: dict, x: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, cfg) -> torch.Tensor:
    """``x`` (B, S, D_model) attending, unmasked, over ``k``/``v`` (B, T,
    Hkv, D) -> (B, S, D_model): the einsum of the reference's cross-attention
    (softmax in float32, probabilities in the compute dtype)."""
    dt = x.dtype
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = _split_heads(x @ params["w_q"].to(dt), hq, hd)
    k, v = _repeat_kv(k, hq // hkv), _repeat_kv(v, hq // hkv)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / (hd ** 0.5)
    p = torch.softmax(logits.to(torch.float32), dim=-1).to(dt)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(
        x.shape[0], x.shape[1], hq * hd)
    return o @ params["w_o"].to(dt)


def attn_apply(params: dict, x: torch.Tensor, cfg, positions: torch.Tensor,
               causal: bool = True, window: Optional[int] = None,
               kv_x: Optional[torch.Tensor] = None,
               use_rope: bool = True) -> torch.Tensor:
    """``x`` (B, S, D_model) -> (B, S, D_model); ``positions`` (B, S)."""
    if kv_x is None:
        return self_attention(params, x, cfg, positions, causal, window,
                              use_rope)[0]
    return cross_attend(params, x, *cross_kv(params, kv_x, cfg), cfg)


def init_cache(cfg, batch: int, max_len: int, dtype, *, device) -> KVCache:
    """Cache window: full seq for global attention, ring of ``sliding_window``
    for pure-SWA archs (mixtral): O(window) memory regardless of context."""
    ring = cfg.sliding_window is not None and cfg.local_global_ratio == 0
    w = min(max_len, cfg.sliding_window) if ring else max_len
    shape = (batch, w, cfg.n_kv_heads, cfg.head_dim_)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.zeros((), dtype=torch.int32, device=device), ring=ring)


def attn_decode(params: dict, x: torch.Tensor, cache: KVCache, cfg,
                window: Optional[int] = None):
    """One decode step against the cache; returns ``(out, new_cache)``.

    ``x`` is (B, 1, D_model).  The new token's K/V go to slot ``pos % W`` of
    a ring, or ``min(pos, W - 1)`` of a linear cache, as in the reference;
    the cache given is not modified.
    """
    dt = x.dtype
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    b = x.shape[0]
    q = _split_heads(x @ params["w_q"].to(dt), hq, hd)
    k_new = _split_heads(x @ params["w_k"].to(dt), hkv, hd)
    v_new = _split_heads(x @ params["w_v"].to(dt), hkv, hd)
    pos = cache.pos
    q, k_new = rope(q, k_new, pos.reshape(1, 1).expand(b, 1), cfg.rope_theta)

    w = cache.k.shape[1]
    slot = pos % w if cache.ring else torch.clamp(pos, max=w - 1)
    slot = slot.reshape(1).to(torch.int64)
    k = cache.k.index_copy(1, slot, k_new)
    v = cache.v.index_copy(1, slot, v_new)

    kk = _repeat_kv(k, hq // hkv)
    vv = _repeat_kv(v, hq // hkv)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, kk) / (hd ** 0.5)

    # valid slots: absolute index <= pos, and within the window
    idx = torch.arange(w, device=x.device)
    if cache.ring:
        base = pos - (pos % w)
        abs_idx = torch.where(idx <= (pos % w), base + idx, base - w + idx)
    else:
        abs_idx = idx
    valid = (abs_idx <= pos) & (abs_idx >= 0)
    if window is not None:
        valid &= (pos - abs_idx) < window
    logits = torch.where(valid, logits, torch.finfo(logits.dtype).min)
    p = torch.softmax(logits.to(torch.float32), dim=-1).to(dt)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vv).reshape(b, 1, hq * hd)
    out = o @ params["w_o"].to(dt)
    return out, KVCache(k=k, v=v, pos=pos + 1, ring=cache.ring)
