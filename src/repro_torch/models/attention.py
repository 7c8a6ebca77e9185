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

Sharded (DTensor operands, ``distributed/sharding.py``): a projection whose
column shards would cut a head is gathered before the heads are split
(``_whole_heads``, and its gradient at the merge); the decode's cache
write has no DTensor rule (``index_copy``), so :func:`_write_slot` runs it
on each rank's shard through ``local_map``, the slot shifted by the
shard's offset along the cache's slots when they are sharded (the
reference's ``"cache_seq"``), so that only the shard that holds the slot
writes; the decode's attention over a head-sharded cache (``"cache"``)
runs on each rank's heads (``_attend_cache``), and so does a sharded
cross-attention over its K/V (whisper's decoder).  A sequence-sharded input
(``seq_shard``) is gathered before the projections (``gather_seq``), and
so is a cross-attention's source; under ``attn_seq_shard``, where
``sharding.attn_stripe_dim`` says so, self-attention runs as K6's query
stripes (``flash_attention_striped``, after RoPE on the whole sequence),
their output gathered before ``w_o``.  Where the ``model`` axis divides the
query heads but not the kv heads (``sharding.attn_heads_dim``), it runs
as K6's query heads (``flash_attention_query_heads``, the reference's
layout): the kv heads whole on every rank (gathered where a column shard
cuts one, as before), their gradients a ``Partial`` sum that the
gather's backward reduce-scatters.  Every weight reaches its product
through ``sharding.product_weight``, its FSDP shards gathered once where
a gradient is taken.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch._device import is_dtensor
from repro_torch.distributed.sharding import (attn_heads_dim,
                                              attn_stripe_dim, gather_seq,
                                              product_weight)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ops import (
    flash_attention_query_heads, flash_attention_striped)
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
    if is_dtensor(x):
        x = _whole_heads(x, n_heads)
    return x.reshape(b, s, n_heads, head_dim)


def _whole_heads(x, n_heads: int):
    """A DTensor (B, S, H * D) whose columns are sharded over mesh
    dimensions that do not divide the ``H`` heads (a shard would cut a
    head: smollm-360m's 960 columns over 16 are 60, its heads 64 wide)
    gathered over those dimensions, so that the heads can be split."""
    from torch.distributed.tensor import Replicate, Shard

    mesh, pl = x.device_mesh, tuple(x.placements)
    cols = Shard(x.ndim - 1)
    n = math.prod(mesh.size(i) for i, p in enumerate(pl) if p == cols)
    if n_heads % n == 0:
        return x
    return x.redistribute(mesh, [Replicate() if p == cols else p
                                 for p in pl])


class _WholeHeadsGrad(torch.autograd.Function):
    """The identity, whose gradient (B, S, H * D) gets :func:`_whole_heads`:
    the heads' merge ``(B, S, H, D) -> (B, S, H * D)`` is a view whose
    backward splits the heads again."""

    @staticmethod
    def forward(ctx, x, n_heads):
        ctx.n_heads = n_heads
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _whole_heads(g, ctx.n_heads), None


def _merge_heads(o: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, H, S, D) -> (B, S, H * D)."""
    b, _, s, d = o.shape
    o = o.transpose(1, 2).reshape(b, s, n_heads * d)
    return _WholeHeadsGrad.apply(o, n_heads) if is_dtensor(o) else o


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
    x = gather_seq(x)
    b, s, _ = x.shape
    q = _split_heads(x @ product_weight(params["w_q"], dt), hq, hd)
    k = _split_heads(x @ product_weight(params["w_k"], dt), hkv, hd)
    v = _split_heads(x @ product_weight(params["w_v"], dt), hkv, hd)
    if use_rope:
        q, k = rope(q, k, positions, cfg.rope_theta)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    win = _kernel_window(window, s)
    heads = stripe = None
    if is_dtensor(q):
        heads, stripe = attn_heads_dim(hq, hkv), attn_stripe_dim(hq, hkv)
    if heads is not None:
        o = flash_attention_query_heads(qt, kt, vt, causal, win, heads)
    elif stripe is not None:
        o = flash_attention_striped(qt, kt, vt, causal, win, stripe)
    else:
        o = flash_attention(qt, kt, vt, causal=causal, window=win)
    o = gather_seq(_merge_heads(o, hq))
    return o @ product_weight(params["w_o"], dt), k, v


def cross_kv(params: dict, kv_x: torch.Tensor, cfg):
    """Cross-attention's K and V of the source ``kv_x`` (B, T, D_model), each
    ``(B, T, Hkv, D)``, no RoPE."""
    dt = kv_x.dtype
    hkv, hd = cfg.n_kv_heads, cfg.head_dim_
    kv_x = gather_seq(kv_x)
    return (_split_heads(kv_x @ product_weight(params["w_k"], dt), hkv, hd),
            _split_heads(kv_x @ product_weight(params["w_v"], dt), hkv, hd))


def cross_attend(params: dict, x: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, cfg) -> torch.Tensor:
    """``x`` (B, S, D_model) attending, unmasked, over ``k``/``v`` (B, T,
    Hkv, D) -> (B, S, D_model): the einsum of the reference's cross-attention
    (softmax in float32, probabilities in the compute dtype)."""
    dt = x.dtype
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    x = gather_seq(x)
    q = _split_heads(x @ product_weight(params["w_q"], dt), hq, hd)
    if is_dtensor(k):
        # as the decode's attention over a sharded cache, every slot valid
        o = _attend_cache(q, k, v, torch.ones((), dtype=torch.bool,
                                              device=x.device))
        return o.reshape(x.shape[0], x.shape[1], hq * hd) @ \
            product_weight(params["w_o"], dt)
    k, v = _repeat_kv(k, hq // hkv), _repeat_kv(v, hq // hkv)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / (hd ** 0.5)
    p = torch.softmax(logits.to(torch.float32), dim=-1).to(dt)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(
        x.shape[0], x.shape[1], hq * hd)
    return o @ product_weight(params["w_o"], dt)


def attn_apply(params: dict, x: torch.Tensor, cfg, positions: torch.Tensor,
               causal: bool = True, window: Optional[int] = None,
               kv_x: Optional[torch.Tensor] = None,
               use_rope: bool = True) -> torch.Tensor:
    """``x`` (B, S, D_model) -> (B, S, D_model); ``positions`` (B, S)."""
    if kv_x is None:
        return self_attention(params, x, cfg, positions, causal, window,
                              use_rope)[0]
    return cross_attend(params, x, *cross_kv(params, kv_x, cfg), cfg)


def _slot_offset(cache) -> tuple[int, bool]:
    """This rank's first slot of a DTensor cache (B, W, H, D) and whether
    its slots are sharded at all (``torch.chunk``'s split, as DTensor's)."""
    from torch.distributed.tensor import Shard

    coord = cache.device_mesh.get_coordinate()
    size, offset, sharded = cache.shape[1], 0, False
    for i, p in enumerate(cache.placements):
        if p == Shard(1):
            n = cache.device_mesh.size(i)
            chunk = -(-size // n)
            offset += coord[i] * chunk
            size = max(0, min(chunk, size - coord[i] * chunk))
            sharded = True
    return offset, sharded


def _write_slot(cache: torch.Tensor, slot: torch.Tensor,
                new: torch.Tensor) -> torch.Tensor:
    """``cache`` (B, W, H, D) with ``new`` (B, 1, H, D) at ``slot`` (1,),
    out of place; a DTensor cache shard by shard."""
    if not is_dtensor(cache):
        return cache.index_copy(1, slot, new)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, pl = cache.device_mesh, tuple(cache.placements)
    offset, sharded = _slot_offset(cache)
    new_pl = tuple(Replicate() if p == Shard(1) else p for p in pl)
    new = new.redistribute(mesh, new_pl)

    def write(c, s, n):
        if not sharded:
            return c.index_copy(1, s, n)
        w = c.shape[1]
        if w == 0:
            return c.clone()
        j = s - offset
        inside = ((j >= 0) & (j < w)).reshape(1, 1, 1, 1)
        j = j.clamp(0, w - 1)
        return c.index_copy(1, j, torch.where(inside, n,
                                              c.index_select(1, j)))

    return local_map(write, out_placements=list(pl),
                     in_placements=(list(pl), None, list(new_pl)),
                     device_mesh=mesh)(cache, slot, new)


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


def _attend(q, k, v, valid):
    """One query a row, ``q`` (B, 1, Hq, D), over the cache ``k``/``v``
    (B, W, Hkv, D) at its ``valid`` slots, query head ``h`` on key/value
    head ``h // (Hq / Hkv)``: the reference's einsums, softmax in float32,
    probabilities in the compute dtype."""
    dt = q.dtype
    n_rep = q.shape[2] // k.shape[2]
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / (q.shape[-1] ** 0.5)
    logits = torch.where(valid, logits, torch.finfo(logits.dtype).min)
    p = torch.softmax(logits.to(torch.float32), dim=-1).to(dt)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _attend_cache(q, k, v, valid):
    """:func:`_attend`; a DTensor cache whose heads are sharded (the
    reference's ``"cache"`` spec: the kv heads divide the axis, and so do
    the query heads, each shard's query heads on its own kv heads) runs it
    on each rank's heads (``local_map``), where every row's softmax is
    whole: the einsums would otherwise flatten a batch- and head-sharded
    pair of dimensions, which DTensor does not in every PyTorch version."""
    if not is_dtensor(k):
        return _attend(q, k, v, valid)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, pl = k.device_mesh, list(k.placements)
    if Shard(2) not in pl:
        # slots sharded ("cache_seq") or replicated: q by batch only, so
        # that the einsums flatten (batch, heads) with the batch alone
        # sharded; the softmax's sums go across the slot shards
        q = q.redistribute(mesh, [p if p == Shard(0) else Replicate()
                                  for p in pl])
        return _attend(q, k, v, valid)
    q = q.redistribute(mesh, pl)
    return local_map(_attend, out_placements=pl, in_placements=(
        pl, pl, pl, None), device_mesh=mesh)(q, k, v, valid)


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
    q = _split_heads(x @ product_weight(params["w_q"], dt), hq, hd)
    k_new = _split_heads(x @ product_weight(params["w_k"], dt), hkv, hd)
    v_new = _split_heads(x @ product_weight(params["w_v"], dt), hkv, hd)
    pos = cache.pos
    q, k_new = rope(q, k_new, pos.reshape(1, 1).expand(b, 1), cfg.rope_theta)

    w = cache.k.shape[1]
    slot = pos % w if cache.ring else torch.clamp(pos, max=w - 1)
    slot = slot.reshape(1).to(torch.int64)
    k = _write_slot(cache.k, slot, k_new)
    v = _write_slot(cache.v, slot, v_new)

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
    o = _attend_cache(q, k, v, valid).reshape(b, 1, hq * hd)
    out = o @ product_weight(params["w_o"], dt)
    return out, KVCache(k=k, v=v, pos=pos + 1, ring=cache.ring)
