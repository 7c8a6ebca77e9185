"""``repro_torch/models/moe.py`` ↔ ``repro/models/moe.py``.

Mixture-of-Experts layer: token-choice top-k routing with static-shape
capacity dispatch.

Dispatch: flatten (token, expert-choice) assignments, group by expert with a
stable argsort, compute each assignment's slot inside its expert via
``searchsorted`` group starts, drop beyond-capacity assignments, and gather
tokens into an (E, C, D) buffer.  Expert FFNs run as batched products over
the expert axis (the reference's einsums, outside any Pallas kernel), and
the weighted outputs are scattered back with ``index_add_``.  The reference's
expert-parallel and expert-tensor-parallel shardings are mesh annotations;
on one device they are the identity and are dropped.

Aux load-balance loss (Switch-style): mean(fraction_tokens_e * mean_prob_e) * E.

On the card ``index_add_`` combines with atomics, so two runs of the layer
may differ in their last bits there; on the CPU it adds in order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init

__all__ = ["moe_apply", "moe_init", "moe_param_shapes"]


def moe_param_shapes(cfg) -> dict:
    """One layer's MoE parameter shapes, in ``moe_init``'s layout."""
    d, e = cfg.d_model, cfg.n_experts
    fe = cfg.moe_d_ff or cfg.d_ff
    shapes = {"router": (d, e), "w_gate": (e, d, fe), "w_up": (e, d, fe),
              "w_down": (e, fe, d)}
    if cfg.n_shared_experts:
        fs = fe * cfg.n_shared_experts
        shapes["shared"] = {"w_gate": (d, fs), "w_up": (d, fs),
                            "w_down": (fs, d)}
    return shapes


def moe_init(generator: torch.Generator, cfg, *, device) -> dict:
    """The reference's distributions (a truncated-normal router at scale
    0.02, normal experts scaled by fan-in), drawn from ``generator``."""
    d = cfg.d_model
    fe = cfg.moe_d_ff or cfg.d_ff
    e = cfg.n_experts

    def normal(shape, scale):
        return torch.randn(shape, generator=generator,
                           device=device).mul_(scale)

    params = {
        "router": dense_init(generator, d, e, scale=0.02, device=device),
        "w_gate": normal((e, d, fe), d ** -0.5),
        "w_up": normal((e, d, fe), d ** -0.5),
        "w_down": normal((e, fe, d), fe ** -0.5),
    }
    if cfg.n_shared_experts:
        fs = fe * cfg.n_shared_experts
        params["shared"] = {
            "w_gate": dense_init(generator, d, fs, device=device),
            "w_up": dense_init(generator, d, fs, device=device),
            "w_down": dense_init(generator, fs, d, scale=fs ** -0.5,
                                 device=device),
        }
    return params


def _dispatch_indices(top_i: torch.Tensor, n_experts: int, capacity: int):
    """top_i: (T, k) expert choices.  Returns (table, valid):
    table (E, C) holds flat assignment indices into (T*k,), sentinel T*k."""
    t, k = top_i.shape
    dev = top_i.device
    flat_e = top_i.reshape(-1)                              # (T*k,)
    order = torch.argsort(flat_e, stable=True)              # group by expert
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e,
                                torch.arange(n_experts, device=dev))  # (E,)
    pos = torch.arange(t * k, device=dev) - starts[sorted_e]  # slot in expert
    keep = pos < capacity
    dest = torch.where(keep, sorted_e * capacity + pos, n_experts * capacity)
    table = torch.full((n_experts * capacity + 1,), t * k, dtype=torch.int64,
                       device=dev)
    # dropped assignments all land on the sentinel slot, cut off below
    table[dest] = order
    table = table[:-1].reshape(n_experts, capacity)
    return table, table < t * k


def moe_apply(params: dict, x: torch.Tensor, cfg, compute_dtype):
    """x: (B, S, D) -> (y, aux_loss)."""
    b, s, d = x.shape
    t = b * s
    k = cfg.experts_per_token
    e = cfg.n_experts
    xt = x.reshape(t, d)

    logits = xt.to(torch.float32) @ params["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                   # (T, E)
    top_p, top_i = torch.topk(probs, k)                     # (T, k)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

    capacity = int(cfg.capacity_factor * t * k / e) + 1
    table, valid = _dispatch_indices(top_i, e, capacity)

    # gather tokens into expert buffers: (E, C, D)
    tok_of = torch.where(valid, table // k, t)              # sentinel row t
    xt_pad = torch.cat([xt, xt.new_zeros((1, d))], dim=0)
    xe = xt_pad[tok_of].to(compute_dtype)

    wg = params["w_gate"].to(compute_dtype)
    wu = params["w_up"].to(compute_dtype)
    wd = params["w_down"].to(compute_dtype)
    h = F.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wu)
    ye = torch.bmm(h, wd)                                   # (E, C, D)

    # combine: scatter back with routing weights
    wslot = torch.where(
        valid, top_p.reshape(-1)[table.clamp_max(t * k - 1)], 0.0,
    ).to(compute_dtype)
    y = torch.zeros((t + 1, d), dtype=compute_dtype, device=x.device)
    y.index_add_(0, tok_of.reshape(-1),
                 (ye * wslot[..., None]).reshape(-1, d))
    y = y[:t]

    if cfg.n_shared_experts:
        sp = params["shared"]
        xc = xt.to(compute_dtype)
        hg = F.silu(xc @ sp["w_gate"].to(compute_dtype))
        hu = xc @ sp["w_up"].to(compute_dtype)
        y = y + (hg * hu) @ sp["w_down"].to(compute_dtype)

    # Switch-style load-balance aux loss
    frac = torch.zeros((e,), dtype=torch.float32, device=x.device).index_add_(
        0, top_i.reshape(-1), torch.ones((t * k,), device=x.device)) / (t * k)
    imp = probs.mean(0)
    aux = (frac * imp).sum() * e

    return y.reshape(b, s, d), aux
