"""``repro_torch/models/transformer.py`` ↔ ``repro/models/transformer.py``.

The decoder-only LM for the dense family.  Parameters are a dict of float32
tensors in the reference's ``init_lm`` layout, the layers stacked on axis 0
(``params["layers"]["attn"]["w_q"]`` is ``(L, d_model, Hq * D)``); the layer
loop is a Python loop over that axis.  Per-layer windows are Python ints.
The reference's ``shard_act`` / ``shard_attn_logits`` are the identity
without a device mesh and are dropped (the sharded path is ROADMAP Queue 1
item 10).  The MoE, SSM, hybrid, vlm and audio families raise
``NotImplementedError`` (ROADMAP Queue 1 item 12).
"""
from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch.models.attention import attn_apply, attn_init
from repro_torch.models.layers import (Dtypes, dense_init, mlp_apply,
                                       mlp_init, rms_norm)

__all__ = ["HUGE_WINDOW", "init_lm", "layer_params", "layer_windows",
           "lm_forward", "lm_param_shapes", "require_dense", "unembedding"]

HUGE_WINDOW = 1 << 30  # "no window": (qi - kj) < 2^30 is always true


def require_dense(cfg) -> None:
    """Raise for a configuration outside the ported dense family."""
    if cfg.family != "dense" or cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet; the "
            "port runs dense LMs only (MoE, SSM, hybrid, vlm and audio are "
            "ROADMAP Queue 1 item 12)")


def lm_param_shapes(cfg) -> dict:
    """The shape of every parameter, in the layout of ``init_lm`` (what
    ``models.convert`` checks the reference's parameters against)."""
    require_dense(cfg)
    n, d, vp = cfg.n_layers, cfg.d_model, cfg.padded_vocab
    hd, hq, hkv, f = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    shapes = {
        "embed": (vp, d),
        "final_ln": (d,),
        "layers": {
            "ln1": (n, d), "ln2": (n, d),
            "attn": {"w_q": (n, d, hq * hd), "w_k": (n, d, hkv * hd),
                     "w_v": (n, d, hkv * hd), "w_o": (n, hq * hd, d)},
            "mlp": {"w_gate": (n, d, f), "w_up": (n, d, f),
                    "w_down": (n, f, d)},
        },
    }
    if not cfg.tie_embeddings:
        shapes["unembed"] = (d, vp)
    return shapes


def _layer_init(generator: torch.Generator, cfg, device) -> dict:
    return {
        "ln1": torch.zeros(cfg.d_model, device=device),
        "ln2": torch.zeros(cfg.d_model, device=device),
        "attn": attn_init(generator, cfg, device=device),
        "mlp": mlp_init(generator, cfg.d_model, cfg.d_ff, device=device),
    }


def _stack(trees: list) -> dict:
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict)
            else torch.stack([t[k] for t in trees])
            for k, v in trees[0].items()}


def init_lm(cfg, seed: int = 0, *, device=None) -> dict:
    """Random parameters from ``torch.Generator(device).manual_seed(seed)``:
    the reference's distributions (normal embeddings scaled by
    ``d_model ** -0.5``, truncated-normal fan-in matrices, zero norm gains),
    not its numbers."""
    require_dense(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    vp, d = cfg.padded_vocab, cfg.d_model
    params = {
        "embed": torch.randn((vp, d), generator=gen, device=dev)
        .mul_(d ** -0.5),
        "final_ln": torch.zeros(d, device=dev),
        "layers": _stack([_layer_init(gen, cfg, dev)
                          for _ in range(cfg.n_layers)]),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(gen, d, vp, device=dev)
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


def unembedding(params: dict, cfg, dt) -> torch.Tensor:
    """The output projection in ``dt``: the embedding's transpose if tied."""
    unemb = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return unemb.to(dt)


def lm_forward(params: dict, tokens: torch.Tensor, cfg):
    """Full-sequence forward; returns ``(logits (B, S, Vp), aux_loss)``,
    ``aux_loss`` 0 for the dense family."""
    require_dense(cfg)
    dt = Dtypes.compute(cfg)
    emb = params["embed"]
    x = emb[torch.as_tensor(tokens, device=emb.device)].to(dt)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    for i, w in enumerate(layer_windows(cfg)):
        lp = layer_params(params["layers"], i)
        x = x + attn_apply(lp["attn"], rms_norm(x, lp["ln1"], cfg.norm_eps),
                           cfg, positions, window=w)
        x = x + mlp_apply(lp["mlp"], rms_norm(x, lp["ln2"], cfg.norm_eps), dt)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    return x @ unembedding(params, cfg, dt), torch.zeros(
        (), dtype=torch.float32, device=x.device)
