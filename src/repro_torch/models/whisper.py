"""``repro_torch/models/whisper.py`` ↔ ``repro/models/whisper.py``.

The whisper-style encoder-decoder of the audio family.  The conv/mel
frontend is a stub, as in the reference: the encoder takes precomputed frame
embeddings (B, T_enc, D).  Encoder layers are bidirectional self-attention
(K6 at ``causal=False``, no RoPE; T_enc = 1,500 at full size, not a multiple
of K6's 64-key tile, whose keys at or past T_enc the kernels mask) + MLP;
decoder layers are causal self-attention through K6 with RoPE,
cross-attention over the encoder's output (plain torch, no RoPE) + MLP.
Parameters are the reference's ``init_encdec`` tree of float32 tensors, the
encoder's layers stacked on axis 0 of ``params["enc_layers"]``, the
decoder's on ``params["layers"]``; the layer loops are Python loops.  With
``cfg.remat`` a forward that takes a gradient checkpoints each layer
(``transformer.remat_call``).

Sharded (parameters as DTensors over a ``DeviceMesh``,
``distributed/sharding.py``): ``shard_act`` pins the reference's eight
points (the encoder's input and both residual adds, the decoder's input
and its three residual adds, the logits ``"btv"``; under ``seq_shard``
the encoder's frames and the decoder's tokens are sequence-sharded, an
uneven split where the model axis does not divide them, as DTensor's
``torch.chunk``; the encoder's output is gathered once for the
cross-attention, and the decoder's last hidden state before the
unembedding).  The reference's
``param_shardings`` treats a leaf as layer-stacked only under
``/layers/``, so ``enc_layers``' attention weights may be sharded on their
layer axis (``P("data", "model", None)`` on a 2 x 2 mesh); the port keeps
those placements, and :func:`encoder_forward` gathers that axis before
its layer loop (``_whole_layers``: dimension 0 replicated, every other
placement kept), as GSPMD serves a scan over a sharded stacked axis.
"""
from __future__ import annotations

import torch

from repro_torch._device import is_dtensor, resolve_device, seeded_generator
from repro_torch.distributed.sharding import gather_seq, shard_act
from repro_torch.models.attention import attn_apply, attn_init
from repro_torch.models.layers import (Dtypes, dense_init, mlp_apply,
                                       mlp_init, rms_norm)
from repro_torch.models.transformer import (embed_inputs, remat_call,
                                            require_ported, stacked_layers,
                                            unstack_layers)

__all__ = ["decoder_forward", "decoder_layer", "encdec_forward",
           "encdec_param_shapes", "encoder_forward", "encoder_layer",
           "init_encdec"]


def _require_audio(cfg) -> None:
    require_ported(cfg)
    if cfg.family != "audio":
        raise ValueError(f"{cfg.name} is a decoder-only {cfg.family} LM: its "
                         "entry points are models.transformer's")


def encdec_param_shapes(cfg) -> dict:
    """The shape of every parameter, in the layout of ``init_encdec``."""
    _require_audio(cfg)
    d, vp, f = cfg.d_model, cfg.padded_vocab, cfg.d_ff
    hd, hq, hkv = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads
    attn = {"w_q": (d, hq * hd), "w_k": (d, hkv * hd), "w_v": (d, hkv * hd),
            "w_o": (hq * hd, d)}
    mlp = {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}

    def stacked(tree, n):
        return {k: stacked(v, n) if isinstance(v, dict) else (n, *v)
                for k, v in tree.items()}

    enc = {"ln1": (d,), "ln2": (d,), "attn": attn, "mlp": mlp}
    dec = {"ln1": (d,), "ln_x": (d,), "ln2": (d,), "attn": attn,
           "xattn": attn, "mlp": mlp}
    return {"embed": (vp, d), "unembed": (d, vp),
            "enc_pos": (cfg.encoder_frames, d), "final_ln": (d,),
            "enc_final_ln": (d,),
            "enc_layers": stacked(enc, cfg.n_encoder_layers),
            "layers": stacked(dec, cfg.n_layers)}


def _enc_layer_init(generator: torch.Generator, cfg, device) -> dict:
    return {
        "ln1": torch.zeros(cfg.d_model, device=device),
        "ln2": torch.zeros(cfg.d_model, device=device),
        "attn": attn_init(generator, cfg, device=device),
        "mlp": mlp_init(generator, cfg.d_model, cfg.d_ff, device=device),
    }


def _dec_layer_init(generator: torch.Generator, cfg, device) -> dict:
    return {
        "ln1": torch.zeros(cfg.d_model, device=device),
        "ln_x": torch.zeros(cfg.d_model, device=device),
        "ln2": torch.zeros(cfg.d_model, device=device),
        "attn": attn_init(generator, cfg, device=device),
        "xattn": attn_init(generator, cfg, device=device),
        "mlp": mlp_init(generator, cfg.d_model, cfg.d_ff, device=device),
    }


def init_encdec(cfg, seed: int = 0, *, device=None) -> dict:
    """Random parameters from ``seeded_generator(device, seed)``:
    the reference's distributions (normal embeddings scaled by
    ``d_model ** -0.5``, encoder positions by 0.02, truncated-normal fan-in
    matrices, zero norm gains), not its numbers."""
    _require_audio(cfg)
    dev = resolve_device(device)
    gen = seeded_generator(dev, seed)
    vp, d = cfg.padded_vocab, cfg.d_model
    return {
        "embed": torch.randn((vp, d), generator=gen, device=dev)
        .mul_(d ** -0.5),
        "unembed": dense_init(gen, d, vp, device=dev),
        "enc_pos": torch.randn((cfg.encoder_frames, d), generator=gen,
                               device=dev).mul_(0.02),
        "final_ln": torch.zeros(d, device=dev),
        "enc_final_ln": torch.zeros(d, device=dev),
        "enc_layers": stacked_layers(lambda: _enc_layer_init(gen, cfg, dev),
                                     cfg.n_encoder_layers),
        "layers": stacked_layers(lambda: _dec_layer_init(gen, cfg, dev),
                                 cfg.n_layers),
    }


def _positions(x: torch.Tensor) -> torch.Tensor:
    b, s, _ = x.shape
    return torch.arange(s, device=x.device)[None, :].expand(b, s)


def encoder_layer(lp: dict, x: torch.Tensor, cfg,
                  positions: torch.Tensor) -> torch.Tensor:
    """One encoder layer: bidirectional self-attention through K6 (no RoPE),
    then the MLP, each residual."""
    x = x + shard_act(attn_apply(lp["attn"],
                                 rms_norm(x, lp["ln1"], cfg.norm_eps), cfg,
                                 positions, causal=False, use_rope=False),
                      "btd")
    return x + shard_act(mlp_apply(lp["mlp"],
                                   rms_norm(x, lp["ln2"], cfg.norm_eps),
                                   x.dtype), "btd")


def decoder_layer(lp: dict, x: torch.Tensor, enc: torch.Tensor, cfg,
                  positions: torch.Tensor) -> torch.Tensor:
    """One decoder layer: causal self-attention through K6 (RoPE),
    cross-attention over ``enc`` (no RoPE), the MLP, each residual."""
    x = x + shard_act(attn_apply(lp["attn"],
                                 rms_norm(x, lp["ln1"], cfg.norm_eps), cfg,
                                 positions), "btd")
    x = x + shard_act(attn_apply(lp["xattn"],
                                 rms_norm(x, lp["ln_x"], cfg.norm_eps), cfg,
                                 positions, kv_x=enc, use_rope=False), "btd")
    return x + shard_act(mlp_apply(lp["mlp"],
                                   rms_norm(x, lp["ln2"], cfg.norm_eps),
                                   x.dtype), "btd")


def _whole_layers(layers: dict) -> dict:
    """A stacked layer tree whose DTensor leaves sharded on their layer
    axis (dimension 0) are gathered on it, every other placement kept; the
    rest as they are."""
    from torch.distributed.tensor import Replicate, Shard

    def whole(t):
        if isinstance(t, dict):
            return {k: whole(v) for k, v in t.items()}
        if not (is_dtensor(t) and Shard(0) in t.placements):
            return t
        return t.redistribute(t.device_mesh, [
            Replicate() if p == Shard(0) else p for p in t.placements])

    return whole(layers)


def encoder_forward(params: dict, frames, cfg) -> torch.Tensor:
    """``frames`` (B, T_enc, D) stub embeddings -> (B, T_enc, D) in the
    compute dtype."""
    _require_audio(cfg)
    pos_emb = params["enc_pos"]
    frames = torch.as_tensor(frames, device=pos_emb.device)
    x = shard_act((frames + pos_emb[None, :frames.shape[1]]).to(
        Dtypes.compute(cfg)), "btd")
    positions = _positions(x)
    run = remat_call(cfg, params)
    for lp in unstack_layers(_whole_layers(params["enc_layers"]),
                             cfg.n_encoder_layers):
        x = run(encoder_layer, lp, x, cfg, positions)
    return rms_norm(x, params["enc_final_ln"], cfg.norm_eps)


def decoder_forward(params: dict, tokens, enc_out: torch.Tensor,
                    cfg) -> torch.Tensor:
    """``tokens`` (B, S), ``enc_out`` (B, T_enc, D) -> logits (B, S, Vp)."""
    _require_audio(cfg)
    dt = Dtypes.compute(cfg)
    x = embed_inputs(params, tokens, cfg)
    enc = gather_seq(enc_out.to(dt))
    positions = _positions(x)
    run = remat_call(cfg, params)
    for lp in unstack_layers(params["layers"], cfg.n_layers):
        x = run(decoder_layer, lp, x, enc, cfg, positions)
    x = gather_seq(rms_norm(x, params["final_ln"], cfg.norm_eps))
    return shard_act(x @ params["unembed"].to(dt), "btv")


def encdec_forward(params: dict, tokens, frames, cfg):
    """Returns ``(logits (B, S, Vp), aux_loss)``, ``aux_loss`` 0 (no MoE)."""
    enc = encoder_forward(params, frames, cfg)
    logits = decoder_forward(params, tokens, enc, cfg)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)
