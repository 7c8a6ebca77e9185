"""``repro_torch/serving/decode.py`` ↔ ``repro/serving/decode.py``.

Serving for the attention families the port runs (dense and MoE):
``prefill`` runs the context through the model and builds the KV cache,
``decode_step`` extends it by one token.  An MoE layer routes the tokens of
each call among themselves: at decode that is the batch's B tokens, so the
expert capacity is ``int(capacity_factor * B * k / E) + 1`` and assignments
past it drop, as in the reference.

Cache layout: ``KVCache`` stacked over layers, ``(L, B, W, Hkv, D)``, with
``pos`` ``(L,)``; ``W`` is the context plus ``DECODE_SLACK`` free slots, or
a sliding-window ring for pure-SWA archs.  ``prefill`` computes each layer's
K/V once and takes them from its self-attention (the reference computes
them a second time, to the same values).  Attention in ``prefill`` goes
through K6; ``decode_step`` runs the reference's one-query attention in plain
torch.  The SSM and hybrid caches (ROADMAP Queue 1 item 12c) and the audio
cache (item 12e) are not ported yet.

Deprecated as a serving entry point, as in the reference: the
label-propagation names it re-exports (``PropagateEngine``,
``PropagateRequest``, ...) live on the blessed :mod:`repro_torch.serving`
surface; importing this module emits a once-per-process
:class:`DeprecationWarning`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch._device import resolve_device
from repro_torch.models.attention import (KVCache, attn_decode, init_cache,
                                          self_attention)
from repro_torch.models.layers import Dtypes, rms_norm
from repro_torch.models.transformer import (ffn_apply, layer_params,
                                            layer_windows, require_ported,
                                            unembedding)
# Label-propagation requests ride the same serving layer: propagate_many
# pads/buckets variable-width label matrices into batched VDT dispatches,
# and PropagateEngine serves a live queue of them with continuous batching.
from repro_torch.serving._batching import PropagateRequest
from repro_torch.serving._deprecation import warn_once
from repro_torch.serving._engine import PropagateEngine
from repro_torch.serving._metrics import MetricsSnapshot
from repro_torch.serving._propagate import propagate_many
from repro_torch.serving._queue import DeadlineExceeded, QueueFull

warn_once(
    "repro_torch.serving.decode",
    "import the serving names (PropagateEngine, PropagateRequest, "
    "propagate_many, ...) from repro_torch.serving")

__all__ = ["DECODE_SLACK", "DecodeState", "decode_step", "init_state",
           "prefill", "DeadlineExceeded", "MetricsSnapshot",
           "PropagateEngine", "PropagateRequest", "QueueFull",
           "propagate_many"]

# non-ring caches reserve this many slots beyond the prefilled context
DECODE_SLACK = 16


def _finalize_kv(ks: torch.Tensor, vs: torch.Tensor, s: int, ring: bool,
                 window: Optional[int]):
    """Lay out prefilled K/V ``(L, B, S, Hkv, D)`` for decoding.

    ring:  keep the last ``window`` tokens, rolled so token t sits at slot
           t % window (what ``attn_decode``'s ring indexing expects).
    else:  pad ``DECODE_SLACK`` empty slots for upcoming tokens.
    """
    if ring:
        w = min(s, window)
        ks, vs = ks[:, :, -w:], vs[:, :, -w:]
        shift = s % w
        if shift:
            ks = torch.roll(ks, shift, dims=2)
            vs = torch.roll(vs, shift, dims=2)
        return ks, vs
    pad = (0, 0, 0, 0, 0, DECODE_SLACK)
    return (torch.nn.functional.pad(ks, pad),
            torch.nn.functional.pad(vs, pad))


@dataclasses.dataclass(frozen=True)
class DecodeState:
    kv: Optional[KVCache] = None   # stacked over layers


def _is_ring(cfg) -> bool:
    return cfg.sliding_window is not None and cfg.local_global_ratio == 0


def init_state(cfg, batch: int, max_len: int, *, device=None) -> DecodeState:
    """An empty cache of ``max_len`` slots per layer."""
    require_ported(cfg)
    dev = resolve_device(device)
    one = init_cache(cfg, batch, max_len, Dtypes.compute(cfg), device=dev)
    n = cfg.n_layers
    return DecodeState(kv=KVCache(
        k=one.k.expand(n, *one.k.shape).clone(),
        v=one.v.expand(n, *one.v.shape).clone(),
        pos=one.pos.expand(n).clone(), ring=one.ring))


def prefill(params: dict, tokens: torch.Tensor, cfg):
    """Run the context ``tokens`` (B, S) through the model, building the cache.

    Returns ``(last-position logits (B, Vp), DecodeState)``.
    """
    require_ported(cfg)
    dt = Dtypes.compute(cfg)
    emb = params["embed"]
    x = emb[torch.as_tensor(tokens, device=emb.device)].to(dt)
    b, s, _ = x.shape
    pos = torch.arange(s, device=x.device)[None, :].expand(b, s)
    ks, vs = [], []
    for i, w in enumerate(layer_windows(cfg)):
        lp = layer_params(params["layers"], i)
        a, k, v = self_attention(lp["attn"],
                                 rms_norm(x, lp["ln1"], cfg.norm_eps), cfg,
                                 pos, window=w)
        x = x + a
        x = x + ffn_apply(lp, rms_norm(x, lp["ln2"], cfg.norm_eps), cfg,
                          dt)[0]
        ks.append(k)
        vs.append(v)

    ring = _is_ring(cfg)
    ks, vs = _finalize_kv(torch.stack(ks), torch.stack(vs), s, ring,
                          cfg.sliding_window)
    state = DecodeState(kv=KVCache(
        k=ks, v=vs, pos=torch.full((cfg.n_layers,), s, dtype=torch.int32,
                                   device=x.device), ring=ring))
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    return x[:, -1] @ unembedding(params, cfg, dt), state


def decode_step(params: dict, token: torch.Tensor, state: DecodeState, cfg):
    """``token`` (B, 1) -> ``(logits (B, Vp), new DecodeState)``."""
    require_ported(cfg)
    dt = Dtypes.compute(cfg)
    emb = params["embed"]
    x = emb[torch.as_tensor(token, device=emb.device)].to(dt)   # (B, 1, D)
    x, new_state = _decode_attn(params, x, state, cfg, dt)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    return x[:, 0] @ unembedding(params, cfg, dt), new_state


def _decode_attn(params: dict, x: torch.Tensor, state: DecodeState, cfg, dt):
    kv = state.kv
    ks, vs, ps = [], [], []
    for i, w in enumerate(layer_windows(cfg)):
        lp = layer_params(params["layers"], i)
        a, cache = attn_decode(
            lp["attn"], rms_norm(x, lp["ln1"], cfg.norm_eps),
            KVCache(k=kv.k[i], v=kv.v[i], pos=kv.pos[i], ring=kv.ring), cfg,
            window=w)
        x = x + a
        x = x + ffn_apply(lp, rms_norm(x, lp["ln2"], cfg.norm_eps), cfg,
                          dt)[0]
        ks.append(cache.k)
        vs.append(cache.v)
        ps.append(cache.pos)
    return x, DecodeState(kv=KVCache(k=torch.stack(ks), v=torch.stack(vs),
                                     pos=torch.stack(ps), ring=kv.ring))
