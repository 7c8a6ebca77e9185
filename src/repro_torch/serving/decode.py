"""``repro_torch/serving/decode.py`` ↔ ``repro/serving/decode.py``.

Serving for every family the port runs (dense, MoE, SSM, hybrid, vlm,
audio):
``prefill`` runs the context through the model and builds the caches,
``decode_step`` extends them by one token.  An MoE layer routes the tokens
of each call among themselves: at decode that is the batch's B tokens, so
the expert capacity is ``int(capacity_factor * B * k / E) + 1`` and
assignments past it drop, as in the reference.

Cache layouts (stacked over layers):
  dense/moe/vlm : ``KVCache`` ``(L, B, W, Hkv, D)``, ``pos`` ``(L,)``; ``W``
                  is the context plus ``DECODE_SLACK`` free slots, or a
                  sliding-window ring for pure-SWA archs.
  ssm           : ``SSMCache`` ``(L, ...)``: O(1) state per layer.
  hybrid        : ``SSMCache`` ``(L, ...)`` and a ``KVCache`` over the shared
                  attention block's applications; a ring if the model has a
                  window.
  audio         : the decoder's self-attention ``KVCache`` ``(L, ...)``
                  (linear, ``DECODE_SLACK`` free slots) and the
                  cross-attention K/V of the encoder's output,
                  ``cross_k``/``cross_v`` ``(L, B, T_enc, Hkv, D)``.

A vlm's ``patches`` (B, P, D) precede the prompt, so its decode starts at
position P + S; an audio model's ``frames`` (B, T_enc, D) go through the
encoder.  ``prefill`` computes each attention's K/V once and takes them from
its self-attention, each cross-attention's from one projection of the
encoder's output, and each SSM layer's conv cache from its own ``in_proj``
product (the reference computes all three a second time, to the same
values).  Self-attention in ``prefill`` (the encoder's too) goes through K6;
``decode_step`` runs the reference's one-query attention, cross-attention
against the cached K/V and the SSM recurrence in plain torch.

Sharded (parameters as DTensors over a ``DeviceMesh``, inputs sharded by
batch, ``distributed/sharding.py``), every family's path constrains the
embeddings and each residual add to ``"btd"`` as the reference's prefill
does (its decode step leaves that to GSPMD; here
``decode_step`` pins the same points), and a KV cache (once laid out for
decoding, and at each decode step's start) by the reference's decode-state
rule (``sharding.decode_state_spec``): the batch over dp when it divides
it; a KV cache (L, B, W, Hkv, D), and whisper's cross-attention K/V (L, B,
T_enc, Hkv, D), its kv heads over tp when they divide it, else its slots
(the reference's ``"cache"`` and ``"cache_seq"``); an SSM state (L, B, H,
P, N) P over tp, a conv cache (L, B, K - 1, C) its channels.  A vlm's
patches are sharded by batch like its tokens.  An audio prefill projects
every layer's cross-attention K/V first and lays them out so, then
attends over them as its decode steps do.  Under ``seq_shard`` (a long
prefill: the residual stream sequence-sharded, ``sharding.gather_seq``
before every block) the caches come out laid out as above, and the last
position's hidden state is gathered first; ``decode_step`` runs under a
context with ``seq_shard`` off, as the reference's dry run gives decode
cells, and raises under one with it on.

A ring keeps ``min(S, window)`` slots, as the reference's does: when the
prompt is shorter than the window, the first decoded token takes slot
``S % S = 0`` and evicts token 0, though the window still covers it.  The
port keeps that behaviour so that it stays held to the reference (ROADMAP
Queue 3).

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

from repro_torch._device import is_dtensor, resolve_device
from repro_torch.distributed.sharding import (current_ctx, gather_seq,
                                              shard_act, shard_state)
from repro_torch.models.attention import (KVCache, attn_decode,
                                          cross_attend, cross_kv, init_cache,
                                          self_attention)
from repro_torch.models.layers import Dtypes, mlp_apply, rms_norm
from repro_torch.models.ssm import (SSMCache, init_ssm_cache, ssm_apply,
                                    ssm_decode)
from repro_torch.models.transformer import (attn_flags, embed_inputs,
                                            ffn_apply, layer_params,
                                            layer_windows, require_ported,
                                            shared_block, shared_window,
                                            unembedding)
from repro_torch.models.whisper import encoder_forward
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
    return _pad_slots(ks), _pad_slots(vs)


def _pad_slots(t: torch.Tensor) -> torch.Tensor:
    """(L, B, S, H, D) with ``DECODE_SLACK`` zero slots after the S; a
    DTensor shard by shard (``local_map``), its slots gathered first if
    they are sharded (DTensor's own pad rule fails to plan a
    redistribution in some PyTorch versions)."""
    pad = (0, 0, 0, 0, 0, DECODE_SLACK)
    if not is_dtensor(t):
        return torch.nn.functional.pad(t, pad)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = t.device_mesh
    pl = [Replicate() if p == Shard(2) else p for p in t.placements]
    t = t.redistribute(mesh, pl)
    return local_map(lambda x: torch.nn.functional.pad(x, pad),
                     out_placements=pl, in_placements=(pl,),
                     device_mesh=mesh)(t)


@dataclasses.dataclass(frozen=True)
class DecodeState:
    kv: Optional[KVCache] = None          # stacked over layers
    ssm: Optional[SSMCache] = None        # stacked over layers
    shared_kv: Optional[KVCache] = None   # hybrid: stacked over attn points
    cross_k: Optional[torch.Tensor] = None  # audio: (L, B, T_enc, Hkv, D)
    cross_v: Optional[torch.Tensor] = None


def _is_ring(cfg) -> bool:
    return cfg.sliding_window is not None and cfg.local_global_ratio == 0


def _tensors(cache) -> dict:
    return {f.name: getattr(cache, f.name) for f in dataclasses.fields(cache)
            if isinstance(getattr(cache, f.name), torch.Tensor)}


def _repeat(cache, n: int):
    """``n`` copies of one cache, stacked on a new axis 0."""
    return dataclasses.replace(cache, **{
        k: t.expand(n, *t.shape).clone() for k, t in _tensors(cache).items()})


def _stack(caches: list):
    return dataclasses.replace(caches[0], **{
        k: torch.stack([getattr(c, k) for c in caches])
        for k in _tensors(caches[0])})


def _laid_out(cache):
    """A stacked cache (``KVCache`` or ``SSMCache``) whose DTensor leaves
    are laid out by the reference's decode-state rule
    (``sharding.shard_state``: the batch over the data axes when it divides
    them; kv heads, else slots, over ``model``; an SSM state's P and a conv
    cache's channels); plain tensors and positions as they are."""
    return dataclasses.replace(cache, **{
        k: shard_state(t) for k, t in _tensors(cache).items() if t.dim() > 1})


def _index(cache, i: int):
    return dataclasses.replace(cache, **{k: t[i] for k, t in
                                         _tensors(cache).items()})


def init_state(cfg, batch: int, max_len: int, *, device=None) -> DecodeState:
    """An empty cache of ``max_len`` slots per attention layer (for a
    hybrid, per shared attention point), an empty SSM state per SSM
    layer, and for an audio model empty cross-attention K/V."""
    require_ported(cfg)
    dev = resolve_device(device)
    dt = Dtypes.compute(cfg)
    if cfg.family == "audio":
        shape = (cfg.n_layers, batch, cfg.encoder_frames, cfg.n_kv_heads,
                 cfg.head_dim_)
        return DecodeState(
            kv=_repeat(init_cache(cfg, batch, max_len, dt, device=dev),
                       cfg.n_layers),
            cross_k=torch.zeros(shape, dtype=dt, device=dev),
            cross_v=torch.zeros(shape, dtype=dt, device=dev))
    if cfg.family in ("ssm", "hybrid"):
        ssm = _repeat(init_ssm_cache(cfg, batch, dt, device=dev),
                      cfg.n_layers)
        if cfg.family == "ssm":
            return DecodeState(ssm=ssm)
        return DecodeState(ssm=ssm, shared_kv=_repeat(
            init_cache(cfg, batch, max_len, dt, device=dev),
            sum(attn_flags(cfg))))
    return DecodeState(kv=_repeat(
        init_cache(cfg, batch, max_len, dt, device=dev), cfg.n_layers))


def prefill(params: dict, tokens: torch.Tensor, cfg, patches=None,
            frames=None):
    """Run the context ``tokens`` (B, S) through the model, building the
    caches; a vlm's ``patches`` (B, P, D) precede the tokens; an audio
    model's ``frames`` (B, T_enc, D) are its encoder's input.

    Returns ``(last-position logits (B, Vp), DecodeState)``.
    """
    require_ported(cfg)
    dt = Dtypes.compute(cfg)
    if cfg.family == "audio":
        return _prefill_audio(params, tokens, frames, cfg, dt)
    x = embed_inputs(params, tokens, cfg, patches)
    b, s, _ = x.shape
    pos = torch.arange(s, device=x.device)[None, :].expand(b, s)
    if cfg.family in ("ssm", "hybrid"):
        return _prefill_ssm(params, x, pos, cfg, dt)
    ks, vs = [], []
    for i, w in enumerate(layer_windows(cfg)):
        lp = layer_params(params["layers"], i)
        a, k, v = self_attention(lp["attn"],
                                 rms_norm(x, lp["ln1"], cfg.norm_eps), cfg,
                                 pos, window=w)
        x = x + shard_act(a, "btd")
        x = x + shard_act(ffn_apply(lp, rms_norm(x, lp["ln2"], cfg.norm_eps),
                                    cfg, dt)[0], "btd")
        ks.append(k)
        vs.append(v)

    ring = _is_ring(cfg)
    ks, vs = _finalize_kv(torch.stack(ks), torch.stack(vs), s, ring,
                          cfg.sliding_window)
    state = DecodeState(kv=_laid_out(KVCache(
        k=ks, v=vs, pos=torch.full((cfg.n_layers,), s, dtype=torch.int32,
                                   device=x.device), ring=ring)))
    return _logits(params, x, cfg, dt), state


def _logits(params: dict, x: torch.Tensor, cfg, dt) -> torch.Tensor:
    """The last position's logits (B, Vp)."""
    x = rms_norm(gather_seq(x)[:, -1], params["final_ln"], cfg.norm_eps)
    return x @ unembedding(params, cfg, dt)


def _prefill_ssm(params: dict, x: torch.Tensor, pos: torch.Tensor, cfg, dt):
    caches, ks, vs = [], [], []
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        out, cache = ssm_apply(lp["ssm"], rms_norm(x, lp["ln"], cfg.norm_eps),
                               cfg, dt, return_state=True)
        x = x + shard_act(out, "btd")
        caches.append(cache)
        if cfg.family == "hybrid" and cfg.layer_is_attn(i):
            x, k, v = shared_block(params["shared_attn"], x, cfg, pos)
            ks.append(k)
            vs.append(v)
    state = DecodeState(ssm=_laid_out(_stack(caches)))
    if ks:
        s, n_attn = x.shape[1], len(ks)
        ring = cfg.sliding_window is not None
        ks, vs = _finalize_kv(torch.stack(ks), torch.stack(vs), s, ring,
                              cfg.sliding_window)
        state = dataclasses.replace(state, shared_kv=_laid_out(KVCache(
            k=ks, v=vs, pos=torch.full((n_attn,), s, dtype=torch.int32,
                                       device=x.device), ring=ring)))
    return _logits(params, x, cfg, dt), state


def _prefill_audio(params: dict, tokens, frames, cfg, dt):
    enc = gather_seq(encoder_forward(params, frames, cfg))
    x = embed_inputs(params, tokens, cfg)
    b, s, _ = x.shape
    pos = torch.arange(s, device=x.device)[None, :].expand(b, s)
    # every layer's cross-attention K/V, laid out as the decode cache
    cross = [cross_kv(layer_params(params["layers"], i)["xattn"], enc, cfg)
             for i in range(cfg.n_layers)]
    cross_k = shard_state(torch.stack([k for k, _ in cross]))
    cross_v = shard_state(torch.stack([v for _, v in cross]))
    del cross
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        a, k, v = self_attention(lp["attn"],
                                 rms_norm(x, lp["ln1"], cfg.norm_eps), cfg,
                                 pos)
        x = x + shard_act(a, "btd")
        x = x + shard_act(cross_attend(
            lp["xattn"], rms_norm(x, lp["ln_x"], cfg.norm_eps), cross_k[i],
            cross_v[i], cfg), "btd")
        x = x + shard_act(mlp_apply(lp["mlp"],
                                    rms_norm(x, lp["ln2"], cfg.norm_eps),
                                    dt), "btd")
        ks.append(k)
        vs.append(v)
    ks, vs = _finalize_kv(torch.stack(ks), torch.stack(vs), s, False, None)
    state = DecodeState(
        kv=_laid_out(KVCache(k=ks, v=vs, pos=torch.full(
            (cfg.n_layers,), s, dtype=torch.int32, device=x.device))),
        cross_k=cross_k, cross_v=cross_v)
    return _logits(params, x, cfg, dt), state


def decode_step(params: dict, token: torch.Tensor, state: DecodeState, cfg):
    """``token`` (B, 1) -> ``(logits (B, Vp), new DecodeState)``.  Raises
    ``ValueError`` under a context with ``seq_shard`` on: one token has no
    sequence to shard."""
    require_ported(cfg)
    ctx = current_ctx()
    if ctx is not None and ctx.seq_shard:
        raise ValueError("decode_step runs under a context with seq_shard "
                         "off (a decode cell's, as the dry run makes it); "
                         "the active one has it on")
    dt = Dtypes.compute(cfg)
    x = embed_inputs(params, token, cfg)                  # (B, 1, D)
    if cfg.family in ("ssm", "hybrid"):
        x, new_state = _decode_ssm(params, x, state, cfg, dt)
    elif cfg.family == "audio":
        x, new_state = _decode_audio(params, x, state, cfg, dt)
    else:
        x, new_state = _decode_attn(params, x, state, cfg, dt)
    return _logits(params, x, cfg, dt), new_state


def _decode_attn(params: dict, x: torch.Tensor, state: DecodeState, cfg, dt):
    caches = []
    kv = _laid_out(state.kv)
    for i, w in enumerate(layer_windows(cfg)):
        lp = layer_params(params["layers"], i)
        a, cache = attn_decode(
            lp["attn"], rms_norm(x, lp["ln1"], cfg.norm_eps), _index(kv, i),
            cfg, window=w)
        x = x + shard_act(a, "btd")
        x = x + shard_act(ffn_apply(lp, rms_norm(x, lp["ln2"], cfg.norm_eps),
                                    cfg, dt)[0], "btd")
        caches.append(cache)
    return x, DecodeState(kv=_stack(caches))


def _decode_audio(params: dict, x: torch.Tensor, state: DecodeState, cfg,
                  dt):
    caches = []
    kv = _laid_out(state.kv)
    cross_k, cross_v = shard_state(state.cross_k), shard_state(state.cross_v)
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        a, cache = attn_decode(lp["attn"],
                               rms_norm(x, lp["ln1"], cfg.norm_eps),
                               _index(kv, i), cfg)
        x = x + shard_act(a, "btd")
        x = x + shard_act(cross_attend(
            lp["xattn"], rms_norm(x, lp["ln_x"], cfg.norm_eps), cross_k[i],
            cross_v[i], cfg), "btd")
        x = x + shard_act(mlp_apply(lp["mlp"],
                                    rms_norm(x, lp["ln2"], cfg.norm_eps),
                                    dt), "btd")
        caches.append(cache)
    return x, DecodeState(kv=_stack(caches), cross_k=cross_k,
                          cross_v=cross_v)


def _decode_ssm(params: dict, x: torch.Tensor, state: DecodeState, cfg, dt):
    shared = params.get("shared_attn")
    ssm = _laid_out(state.ssm)
    shared_kv = _laid_out(state.shared_kv) if shared is not None else None
    caches, shared_caches = [], []
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        out, cache = ssm_decode(lp["ssm"], rms_norm(x, lp["ln"], cfg.norm_eps),
                                _index(ssm, i), cfg, dt)
        x = x + shard_act(out, "btd")
        caches.append(cache)
        if cfg.family == "hybrid" and cfg.layer_is_attn(i):
            a, kv = attn_decode(
                shared["attn"], rms_norm(x, shared["ln1"], cfg.norm_eps),
                _index(shared_kv, len(shared_caches)), cfg,
                window=shared_window(cfg))
            x = x + shard_act(a, "btd")
            x = x + shard_act(mlp_apply(shared["mlp"], rms_norm(
                x, shared["ln2"], cfg.norm_eps), dt), "btd")
            shared_caches.append(kv)
    return x, DecodeState(
        ssm=_stack(caches),
        shared_kv=_stack(shared_caches) if shared_caches else None)
