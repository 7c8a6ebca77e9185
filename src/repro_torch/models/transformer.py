"""``repro_torch/models/transformer.py`` ↔ ``repro/models/transformer.py``.

The decoder-only LM for the dense, MoE, SSM, hybrid and vlm families (the
audio family's encoder-decoder is ``models/whisper.py``, which shares this
module's helpers).  Parameters are a dict of float32 tensors in the
reference's ``init_lm`` layout, the layers stacked on axis 0
(``params["layers"]["attn"]["w_q"]`` is ``(L, d_model, Hq * D)``, an MoE
layer's ``params["layers"]["moe"]["w_gate"]`` ``(L, E, d_model, d_ff)``, an
SSM layer's ``params["layers"]["ssm"]["in_proj"]`` ``(L, d_model, 2 Di + 2 G
N + H)``; a hybrid's one shared attention block ``params["shared_attn"]``,
unstacked); the layer loop is a Python loop over that axis.  Per-layer
windows and the hybrid's attention points (``attn_flags``) are Python ints.
A vlm's ``patches`` (B, P, D) are prepended to the token embeddings.
``shard_act`` is called where the reference calls it (the embeddings, each
residual add, the hybrid's shared block, the logits): the identity on
plain tensors, a redistribution of DTensors when the parameters are
sharded over a ``DeviceMesh`` (``distributed/sharding.py``; under
``seq_shard`` the residual stream is sequence-sharded, every block gathers
it at its entry, and so does the unembedding, whose logits stay
vocabulary-sharded, ``"btv"``); the MoE
layers' aux losses, each the global one, are summed over the layers.  The embedding lookup is
``torch.nn.functional.embedding``, the same gather as indexing, which
DTensor shards over a vocabulary-sharded table.
``cfg.remat`` (the reference's ``jax.checkpoint`` around each layer body)
is ``torch.utils.checkpoint`` around each layer in a forward that takes a
gradient (``remat_call``); it recomputes and changes no value.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device, seeded_generator
from repro_torch.distributed.sharding import (current_ctx, gather_seq,
                                              shard_act, use_ctx)
from repro_torch.models.attention import (attn_apply, attn_init,
                                          self_attention)
from repro_torch.models.layers import (Dtypes, dense_init, mlp_apply,
                                       mlp_init, rms_norm)
from repro_torch.models.moe import moe_apply, moe_init, moe_param_shapes
from repro_torch.models.ssm import ssm_apply, ssm_init, ssm_param_shapes

__all__ = ["HUGE_WINDOW", "attn_flags", "embed_inputs", "ffn_apply",
           "init_lm", "layer_params", "layer_windows", "leaves",
           "lm_forward", "lm_param_shapes", "remat_call",
           "require_decoder_only", "require_ported", "shared_block",
           "shared_window", "stacked_layers", "unembedding",
           "unstack_layers"]

HUGE_WINDOW = 1 << 30  # "no window": (qi - kj) < 2^30 is always true

# every family of the reference; audio runs through models/whisper.py
_PORTED = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def require_ported(cfg) -> None:
    """Raise for a configuration outside the ported families."""
    if cfg.family not in _PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported; the port "
            f"runs the {', '.join(_PORTED)} families (ROADMAP Queue 1 lists "
            "what is left to port)")


def require_decoder_only(cfg) -> None:
    """Raise for a configuration this module's LM does not run: one outside
    the ported families, or the audio encoder-decoder."""
    require_ported(cfg)
    if cfg.family == "audio":
        raise ValueError(
            f"{cfg.name} is an encoder-decoder: its entry points are "
            "models.whisper's init_encdec and encdec_forward")


def leaves(tree: dict):
    """The tensors of a nested parameter dict, depth first."""
    for v in tree.values():
        yield from (leaves(v) if isinstance(v, dict) else (v,))


def remat_call(cfg, params: dict):
    """How a forward calls its layer bodies: ``fn(*args)`` under
    ``torch.utils.checkpoint`` (non-reentrant; the reference's
    ``jax.checkpoint``) when ``cfg.remat`` is set and a gradient of
    ``params`` is being taken, else directly.  So serving, which takes no
    gradient, runs each layer once.  The recompute runs under the sharding
    context of the forward (``use_ctx``): the backward of CUDA tensors runs
    in the autograd engine's own thread, where the thread-local context of
    the caller is unset."""
    if cfg.remat and torch.is_grad_enabled() and any(
            t.requires_grad for t in leaves(params)):
        ctx = current_ctx()

        def body(fn, *args):
            with use_ctx(ctx):
                return fn(*args)

        return lambda fn, *args: checkpoint(body, fn, *args,
                                            use_reentrant=False)
    return lambda fn, *args: fn(*args)


def _is_ssm(cfg) -> bool:
    return cfg.family in ("ssm", "hybrid")


def lm_param_shapes(cfg) -> dict:
    """The shape of every parameter, in the layout of ``init_lm`` (what
    ``models.convert`` checks the reference's parameters against)."""
    require_decoder_only(cfg)
    n, d, vp = cfg.n_layers, cfg.d_model, cfg.padded_vocab
    hd, hq, hkv, f = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff

    def stacked(tree):
        return {k: stacked(v) if isinstance(v, dict) else (n, *v)
                for k, v in tree.items()}

    attn = {"w_q": (d, hq * hd), "w_k": (d, hkv * hd), "w_v": (d, hkv * hd),
            "w_o": (hq * hd, d)}
    mlp = {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}
    if _is_ssm(cfg):
        layer = {"ln": (d,), "ssm": ssm_param_shapes(cfg)}
    elif cfg.n_experts:
        layer = {"ln1": (d,), "ln2": (d,), "attn": attn,
                 "moe": moe_param_shapes(cfg)}
    else:
        layer = {"ln1": (d,), "ln2": (d,), "attn": attn, "mlp": mlp}
    shapes = {"embed": (vp, d), "final_ln": (d,), "layers": stacked(layer)}
    if not cfg.tie_embeddings:
        shapes["unembed"] = (d, vp)
    if cfg.family == "hybrid":
        shapes["shared_attn"] = {"ln1": (d,), "ln2": (d,), "attn": attn,
                                 "mlp": mlp}
    return shapes


def _layer_init(generator: torch.Generator, cfg, device) -> dict:
    if _is_ssm(cfg):
        return {"ln": torch.zeros(cfg.d_model, device=device),
                "ssm": ssm_init(generator, cfg, device=device)}
    p = {
        "ln1": torch.zeros(cfg.d_model, device=device),
        "ln2": torch.zeros(cfg.d_model, device=device),
        "attn": attn_init(generator, cfg, device=device),
    }
    if cfg.n_experts:
        p["moe"] = moe_init(generator, cfg, device=device)
    else:
        p["mlp"] = mlp_init(generator, cfg.d_model, cfg.d_ff, device=device)
    return p


def stacked_layers(init_one, n_layers: int) -> dict:
    """``n_layers`` draws of ``init_one()``, stacked on axis 0.  The stacked
    tensors are allocated first and filled layer by layer, so that the
    parameters are held once, plus one layer's, never twice."""
    def empty(tree):
        return {k: empty(v) if isinstance(v, dict) else
                torch.empty((n_layers, *v.shape), dtype=v.dtype,
                            device=v.device) for k, v in tree.items()}

    def fill(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                fill(dst[k], v, i)
            else:
                dst[k][i].copy_(v)

    first = init_one()
    layers = empty(first)
    fill(layers, first, 0)
    del first
    for i in range(1, n_layers):
        fill(layers, init_one(), i)
    return layers


def init_lm(cfg, seed: int = 0, *, device=None) -> dict:
    """Random parameters from ``seeded_generator(device, seed)``:
    the reference's distributions (normal embeddings scaled by
    ``d_model ** -0.5``, truncated-normal fan-in matrices, zero norm gains),
    not its numbers."""
    require_decoder_only(cfg)
    dev = resolve_device(device)
    gen = seeded_generator(dev, seed)
    vp, d = cfg.padded_vocab, cfg.d_model
    params = {
        "embed": torch.randn((vp, d), generator=gen, device=dev)
        .mul_(d ** -0.5),
        "final_ln": torch.zeros(d, device=dev),
        "layers": stacked_layers(lambda: _layer_init(gen, cfg, dev),
                                 cfg.n_layers),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(gen, d, vp, device=dev)
    if cfg.family == "hybrid":
        params["shared_attn"] = {
            "ln1": torch.zeros(d, device=dev),
            "ln2": torch.zeros(d, device=dev),
            "attn": attn_init(gen, cfg, device=dev),
            "mlp": mlp_init(gen, d, cfg.d_ff, device=dev),
        }
    return params


def layer_params(layers: dict, i: int) -> dict:
    """Layer ``i``'s parameters: every stacked tensor indexed on axis 0."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in layers.items()}


def unstack_layers(layers: dict, n_layers: int) -> list:
    """Every layer's parameters, each stacked tensor unbound on axis 0 once.
    A forward that takes a gradient walks these: the gradient of a stacked
    tensor is then one stack of its layers' gradients, where indexing it per
    layer (``layer_params``) would add a full-size zero-filled gradient per
    layer."""
    split = {k: unstack_layers(v, n_layers) if isinstance(v, dict)
             else v.unbind(0) for k, v in layers.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(n_layers)]


def layer_windows(cfg) -> list:
    """Per-layer attention window (HUGE = full causal)."""
    win = []
    for i in range(cfg.n_layers):
        if cfg.local_global_ratio > 0:
            win.append(HUGE_WINDOW if cfg.layer_is_global(i)
                       else cfg.sliding_window)
        elif cfg.sliding_window is not None:
            win.append(cfg.sliding_window)
        else:
            win.append(HUGE_WINDOW)
    return win


def attn_flags(cfg) -> list:
    """Per-layer flag: apply the shared attention block (hybrid)."""
    return [1 if cfg.layer_is_attn(i) else 0 for i in range(cfg.n_layers)]


def shared_window(cfg) -> int:
    """The hybrid's shared attention window (HUGE = full causal)."""
    return cfg.sliding_window if cfg.sliding_window else HUGE_WINDOW


def shared_block(sp: dict, x: torch.Tensor, cfg, positions: torch.Tensor):
    """The hybrid's shared attention block (``_shared_block`` of the
    reference): attention through K6, then the MLP, each residual; returns
    ``(x, k, v)``, the attention's K (after RoPE) and V for the cache."""
    a, k, v = self_attention(sp["attn"], rms_norm(x, sp["ln1"], cfg.norm_eps),
                             cfg, positions, window=shared_window(cfg))
    x = x + shard_act(a, "btd")
    m = mlp_apply(sp["mlp"], rms_norm(x, sp["ln2"], cfg.norm_eps), x.dtype)
    return x + shard_act(m, "btd"), k, v


def embed_inputs(params: dict, tokens, cfg, patches=None) -> torch.Tensor:
    """Token embeddings in the compute dtype, a vlm's ``patches`` (B, P, D)
    prepended, constrained to ``"btd"``.  Sharded, the lookup of a
    vocabulary-sharded table is a masked partial sum, which DTensor cannot
    concatenate with the batch-sharded patches: the tokens' rows are
    reduced to ``"btd"`` first (and their sequence gathered, under
    ``seq_shard``)."""
    emb = params["embed"]
    x = F.embedding(torch.as_tensor(tokens, device=emb.device), emb).to(
        Dtypes.compute(cfg))
    if patches is not None:
        x = torch.cat([torch.as_tensor(patches, device=emb.device).to(x.dtype),
                       gather_seq(shard_act(x, "btd"))], dim=1)
    return shard_act(x, "btd")


def unembedding(params: dict, cfg, dt) -> torch.Tensor:
    """The output projection in ``dt``: the embedding's transpose if tied."""
    unemb = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return unemb.to(dt)


def ffn_apply(lp: dict, h: torch.Tensor, cfg, dt):
    """A layer's feed-forward block on the normed ``h``: the gated MLP, or
    the MoE layer; returns ``(out, aux_loss)``, ``aux_loss`` None if dense."""
    if cfg.n_experts:
        return moe_apply(lp["moe"], h, cfg, dt)
    return mlp_apply(lp["mlp"], h, dt), None


def _layer(params: dict, lp: dict, x: torch.Tensor, positions, cfg, dt,
           window: int, flag: int):
    """One layer of ``lm_forward``: ``(x, its MoE aux loss or None)``."""
    if _is_ssm(cfg):
        x = x + shard_act(ssm_apply(lp["ssm"],
                                    rms_norm(x, lp["ln"], cfg.norm_eps), cfg,
                                    dt), "btd")
        if cfg.family == "hybrid" and flag:
            x = shared_block(params["shared_attn"], x, cfg, positions)[0]
        return x, None
    x = x + shard_act(attn_apply(lp["attn"],
                                 rms_norm(x, lp["ln1"], cfg.norm_eps), cfg,
                                 positions, window=window), "btd")
    m, aux = ffn_apply(lp, rms_norm(x, lp["ln2"], cfg.norm_eps), cfg, dt)
    return x + shard_act(m, "btd"), aux


def lm_forward(params: dict, tokens: torch.Tensor, cfg, patches=None):
    """Full-sequence forward; returns ``(logits (B, S, Vp), aux_loss)``,
    ``aux_loss`` the MoE layers' load-balance losses summed (0 otherwise).
    ``patches`` (B, P, D): a vlm's patch embeddings, prepended (S counts
    them).  Differentiable in ``params``; with ``cfg.remat`` a gradient's
    forward checkpoints each layer (``remat_call``)."""
    require_decoder_only(cfg)
    dt = Dtypes.compute(cfg)
    x = embed_inputs(params, tokens, cfg, patches)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    run = remat_call(cfg, params)
    for lp, w, flag in zip(unstack_layers(params["layers"], cfg.n_layers),
                           layer_windows(cfg), attn_flags(cfg)):
        x, aux_l = run(_layer, params, lp, x, positions, cfg, dt, w, flag)
        if aux_l is not None:
            aux = aux + aux_l
    x = gather_seq(rms_norm(x, params["final_ln"], cfg.norm_eps))
    return shard_act(x @ unembedding(params, cfg, dt), "btv"), aux
