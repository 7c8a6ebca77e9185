"""``repro_torch/models/transformer.py`` ↔ ``repro/models/transformer.py``.

The decoder-only LM for the dense, MoE, SSM, hybrid and vlm families.
Parameters are a dict of float32 tensors in the reference's ``init_lm``
layout, the layers stacked on axis 0 (``params["layers"]["attn"]["w_q"]`` is
``(L, d_model, Hq * D)``, an MoE layer's ``params["layers"]["moe"]
["w_gate"]`` ``(L, E, d_model, d_ff)``, an SSM layer's ``params["layers"]
["ssm"]["in_proj"]`` ``(L, d_model, 2 Di + 2 G N + H)``; a hybrid's one
shared attention block ``params["shared_attn"]``, unstacked); the layer loop
is a Python loop over that axis.  Per-layer windows and the hybrid's
attention points (``attn_flags``) are Python ints.  A vlm's ``patches``
(B, P, D) are prepended to the token embeddings.  The reference's
``shard_act`` / ``shard_attn_logits`` are the identity without a device
mesh and are dropped (LM sharding is ROADMAP Queue 1 item 12g).  The audio
family raises ``NotImplementedError`` (item 12e).
"""
from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch.models.attention import (attn_apply, attn_init,
                                          self_attention)
from repro_torch.models.layers import (Dtypes, dense_init, mlp_apply,
                                       mlp_init, rms_norm)
from repro_torch.models.moe import moe_apply, moe_init, moe_param_shapes
from repro_torch.models.ssm import ssm_apply, ssm_init, ssm_param_shapes

__all__ = ["HUGE_WINDOW", "attn_flags", "embed_inputs", "ffn_apply",
           "init_lm", "layer_params", "layer_windows", "lm_forward",
           "lm_param_shapes", "require_ported", "shared_block",
           "shared_window", "unembedding"]

HUGE_WINDOW = 1 << 30  # "no window": (qi - kj) < 2^30 is always true

_PORTED = ("dense", "moe", "ssm", "hybrid", "vlm")
# the reference's families the port does not run yet, by ROADMAP item
_NOT_PORTED = {"audio": "12e"}


def require_ported(cfg) -> None:
    """Raise for a configuration outside the ported families."""
    if cfg.family not in _PORTED:
        item = _NOT_PORTED.get(cfg.family, "12")
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet; the "
            f"port runs the {', '.join(_PORTED)} LMs (this family is ROADMAP "
            f"Queue 1 item {item})")


def _is_ssm(cfg) -> bool:
    return cfg.family in ("ssm", "hybrid")


def lm_param_shapes(cfg) -> dict:
    """The shape of every parameter, in the layout of ``init_lm`` (what
    ``models.convert`` checks the reference's parameters against)."""
    require_ported(cfg)
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


def _stacked_layers(generator: torch.Generator, cfg, device) -> dict:
    """Every layer's parameters, stacked on axis 0.  The stacked tensors are
    allocated first and filled layer by layer, so that the parameters are
    held once, plus one layer's, never twice."""
    def empty(tree):
        return {k: empty(v) if isinstance(v, dict) else
                torch.empty((cfg.n_layers, *v.shape), dtype=v.dtype,
                            device=device) for k, v in tree.items()}

    def fill(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                fill(dst[k], v, i)
            else:
                dst[k][i].copy_(v)

    first = _layer_init(generator, cfg, device)
    layers = empty(first)
    fill(layers, first, 0)
    del first
    for i in range(1, cfg.n_layers):
        fill(layers, _layer_init(generator, cfg, device), i)
    return layers


def init_lm(cfg, seed: int = 0, *, device=None) -> dict:
    """Random parameters from ``torch.Generator(device).manual_seed(seed)``:
    the reference's distributions (normal embeddings scaled by
    ``d_model ** -0.5``, truncated-normal fan-in matrices, zero norm gains),
    not its numbers."""
    require_ported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    vp, d = cfg.padded_vocab, cfg.d_model
    params = {
        "embed": torch.randn((vp, d), generator=gen, device=dev)
        .mul_(d ** -0.5),
        "final_ln": torch.zeros(d, device=dev),
        "layers": _stacked_layers(gen, cfg, dev),
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
    x = x + a
    m = mlp_apply(sp["mlp"], rms_norm(x, sp["ln2"], cfg.norm_eps), x.dtype)
    return x + m, k, v


def embed_inputs(params: dict, tokens, cfg, patches=None) -> torch.Tensor:
    """Token embeddings in the compute dtype, a vlm's ``patches`` (B, P, D)
    prepended."""
    emb = params["embed"]
    x = emb[torch.as_tensor(tokens, device=emb.device)].to(
        Dtypes.compute(cfg))
    if patches is not None:
        x = torch.cat([torch.as_tensor(patches, device=emb.device).to(x.dtype),
                       x], dim=1)
    return x


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


def lm_forward(params: dict, tokens: torch.Tensor, cfg, patches=None):
    """Full-sequence forward; returns ``(logits (B, S, Vp), aux_loss)``,
    ``aux_loss`` the MoE layers' load-balance losses summed (0 otherwise).
    ``patches`` (B, P, D): a vlm's patch embeddings, prepended (S counts
    them)."""
    require_ported(cfg)
    dt = Dtypes.compute(cfg)
    x = embed_inputs(params, tokens, cfg, patches)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    flags = attn_flags(cfg)
    for i, w in enumerate(layer_windows(cfg)):
        lp = layer_params(params["layers"], i)
        if _is_ssm(cfg):
            x = x + ssm_apply(lp["ssm"], rms_norm(x, lp["ln"], cfg.norm_eps),
                              cfg, dt)
            if cfg.family == "hybrid" and flags[i]:
                x = shared_block(params["shared_attn"], x, cfg, positions)[0]
            continue
        x = x + attn_apply(lp["attn"], rms_norm(x, lp["ln1"], cfg.norm_eps),
                           cfg, positions, window=w)
        m, aux_l = ffn_apply(lp, rms_norm(x, lp["ln2"], cfg.norm_eps), cfg,
                             dt)
        if aux_l is not None:
            aux = aux + aux_l
        x = x + m
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    return x @ unembedding(params, cfg, dt), aux
