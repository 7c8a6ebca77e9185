"""``repro_torch/models/moe.py`` ↔ ``repro/models/moe.py``.

Mixture-of-Experts layer: token-choice top-k routing with static-shape
capacity dispatch.

Dispatch: flatten (token, expert-choice) assignments, group by expert with a
stable argsort, compute each assignment's slot inside its expert via
``searchsorted`` group starts, drop beyond-capacity assignments, and gather
tokens into an (E, C, D) buffer.  Expert FFNs run as batched products over
the expert axis (the reference's einsums, outside any Pallas kernel), and
each token gathers its kept choices' outputs back, weighted (the
reference's scatter-add, summed in choice order without atomics).

Sharded (DTensor tokens, parameters under ``param_shardings``: experts over
``model`` when ``cfg.expert_parallel``, else their FFN width), the routing
is the reference's global one, as GSPMD computes it: the top-k of each
rank's tokens is gathered, every rank builds the same dispatch table over
all T tokens (capacity ``int(cf * T * k / E) + 1``, one stable sort), and
keeps its slice of the buffer: its experts, and its share of the capacity
slots over the data axes (:func:`_experts_sharded`).  The table, gather and
combine have no DTensor rule; they run on each rank's shards through
``local_map``, with their gradients' layouts stated.  A sequence-sharded
``x`` (``seq_shard``) is gathered on its sequence first, as every
block's input is (``sharding.gather_seq``): the rows are then sharded
over the batch only, and the dispatch is the one above.  A per-rank dispatch
with a local capacity (Megatron's, DeepSpeed's) would drop other
assignments: it is not this layer.

Aux load-balance loss (Switch-style): mean(fraction_tokens_e * mean_prob_e) * E,
over all T tokens.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch._device import is_dtensor
from repro_torch.distributed.sharding import gather_seq, product_weight
from repro_torch.models.layers import dense_init

__all__ = ["moe_apply", "moe_dispatch_table", "moe_init", "moe_param_shapes"]


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


def _top_k(probs: torch.Tensor, k: int):
    """Each row's ``k`` largest probabilities, renormalised, and their
    expert ids: ``(top_p, top_i)``, each (T, k)."""
    top_p, top_i = torch.topk(probs, k)
    return top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9), top_i


def _dispatch_indices(top_i: torch.Tensor, n_experts: int, capacity: int,
                      slots: int = 0):
    """top_i: (T, k) expert choices.  Returns (table, valid): table (E, C)
    holds flat assignment indices into (T*k,), sentinel T*k; with ``slots``
    > C it is (E, slots), the slots past C all sentinel."""
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
    if slots > capacity:
        table = F.pad(table, (0, slots - capacity), value=t * k)
    return table, table < t * k


def _gather(xt: torch.Tensor, table: torch.Tensor, k: int) -> torch.Tensor:
    """The expert buffers (E, C, D): each slot's token row of ``xt`` (T, D),
    zeros at a sentinel slot."""
    t, d = xt.shape
    tok_of = torch.where(table < t * k, table // k, t)      # sentinel row t
    return torch.cat([xt, xt.new_zeros((1, d))], dim=0)[tok_of]


def _expert_ffn(params: dict, xe: torch.Tensor, dt) -> torch.Tensor:
    """The experts' gated FFNs on their buffers: (E, C, D) -> (E, C, D)."""
    wg = product_weight(params["w_gate"], dt)
    wu = product_weight(params["w_up"], dt)
    wd = product_weight(params["w_down"], dt)
    h = F.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wu)
    return torch.bmm(h, wd)


def _combine(ye: torch.Tensor, table: torch.Tensor,
             top_p: torch.Tensor) -> torch.Tensor:
    """The slots' outputs ``ye`` (E, C, D) brought back to their tokens,
    weighted by their routing probabilities ``top_p`` (T, k): (T, D).  Each
    token gathers its kept choices' slots (a zero row for a dropped one, or
    one not in ``table``) and sums them in choice order: the reference's
    scatter-add, without the atomics that would add in another order on
    every call."""
    t, k = top_p.shape
    n, d = table.numel(), ye.shape[-1]
    slot_of = torch.full((t * k + 1,), n, dtype=torch.int64, device=ye.device)
    # every assignment has at most one slot; the sentinel's entry is cut off
    slot_of[table.reshape(-1)] = torch.arange(n, device=ye.device)
    rows = torch.cat([ye.reshape(n, d), ye.new_zeros((1, d))], dim=0)
    picked = rows[slot_of[:-1].reshape(t, k)]                # (T, k, D)
    return (picked * top_p.to(ye.dtype)[..., None]).sum(dim=1)


def _expert_fraction(top_i: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Each expert's share of the (T*k) assignments, float32 (E,)."""
    flat = top_i.reshape(-1)
    ones = torch.ones(flat.shape, dtype=torch.float32, device=flat.device)
    return torch.zeros((n_experts,), dtype=torch.float32,
                       device=flat.device).index_add_(0, flat, ones) / (
        flat.numel())


def _replicas(fn, t):
    """``fn`` of a replicated DTensor, run on each rank's copy: replicated."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    rep = [Replicate()] * t.device_mesh.ndim
    return local_map(fn, out_placements=rep, in_placements=(rep,),
                     device_mesh=t.device_mesh)(t)


def _route(probs: torch.Tensor, k: int):
    """``_top_k`` of the router's probabilities (T, E); of a DTensor row by
    row on each rank's tokens, then gathered: every rank holds the routing
    of all T tokens, replicated, as the global dispatch needs."""
    if not is_dtensor(probs):
        return _top_k(probs, k)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = probs.device_mesh
    rows = [p if p == Shard(0) else Replicate() for p in probs.placements]
    probs = probs.redistribute(mesh, rows)
    top_p, top_i = local_map(lambda p: _top_k(p, k), out_placements=(
        rows, rows), in_placements=(rows,), device_mesh=mesh)(probs)
    rep = [Replicate()] * mesh.ndim
    return top_p.redistribute(mesh, rep), top_i.redistribute(mesh, rep)


def _experts_sharded(params: dict, xt, top_p, top_i, capacity: int, dt):
    """Dispatch, expert FFNs and combine of DTensor tokens ``xt`` (T, D)
    under the global routing ``top_p`` / ``top_i`` (replicated).

    The buffer (E, C, D) has its experts over the mesh dimensions that
    shard the experts' weights (expert parallelism) and its capacity slots
    over those that shard the tokens (the data axes; C padded with sentinel
    slots to a multiple of their size), so no expert's work is repeated.
    Every rank computes the same table from the replicated routing, keeps
    its slice of it, gathers its slots' rows from the all-gathered tokens,
    and scatters its slots' weighted outputs into a (T, D) ``Partial`` sum,
    reduce-scattered back to the tokens' rows here and reduced over the
    expert dimensions by the caller's ``shard_act(..., "btd")``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, rows = xt.device_mesh, list(xt.placements)
    rep = [Replicate()] * mesh.ndim
    k, e = top_i.shape[1], params["w_gate"].shape[0]
    buf = [Shard(0) if p == Shard(0) else Shard(1) if r == Shard(0)
           else Replicate()
           for p, r in zip(params["w_gate"].placements, rows)]
    n_slot = math.prod(mesh.size(i) for i, p in enumerate(buf)
                       if p == Shard(1))
    slots = -(-capacity // n_slot) * n_slot
    table = _replicas(
        lambda ti: _dispatch_indices(ti, e, capacity, slots)[0],
        top_i).redistribute(mesh, buf)                   # each rank's slice
    summed = [Partial() if isinstance(p, Shard) else Replicate()
              for p in buf]
    xe = local_map(lambda xs, tab: _gather(xs, tab, k), out_placements=buf,
                   in_placements=(rep, buf), in_grad_placements=(summed, buf),
                   device_mesh=mesh)(xt.redistribute(mesh, rep), table)
    ye = _expert_ffn(params, xe.to(dt), dt)
    ye_pl = [b if isinstance(b, Shard) else
             p if isinstance(p, Partial) else Replicate()
             for b, p in zip(buf, ye.placements)]
    ye = ye.redistribute(mesh, ye_pl)
    out = [Replicate() if p == Replicate() else Partial() for p in ye_pl]
    y = local_map(_combine, out_placements=out,
                  in_placements=(ye_pl, buf, rep),
                  in_grad_placements=([p if isinstance(p, Shard) else
                                       Replicate() for p in ye_pl], buf,
                                      out), device_mesh=mesh)(ye, table, top_p)
    return y.redistribute(mesh, [Shard(0) if b == Shard(1) else o
                                 for b, o in zip(buf, out)])


def _routing(params: dict, xt: torch.Tensor, cfg):
    """The router's probabilities (T, E) of the tokens ``xt`` (T, D), their
    routing ``(top_p, top_i)`` (T, k) (of DTensor tokens gathered:
    replicated) and the capacity, ``int(cf * T * k / E) + 1`` over all T."""
    k, e = cfg.experts_per_token, cfg.n_experts
    logits = xt.to(torch.float32) @ product_weight(params["router"],
                                                   torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = _route(probs, k)
    return probs, top_p, top_i, int(cfg.capacity_factor * xt.shape[0] * k
                                    / e) + 1


def moe_dispatch_table(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """The dispatch table (E, C) of the tokens ``x`` (B, S, D) that
    ``moe_apply`` routes: every (token, choice) assignment kept, by slot,
    as its flat index, sentinel T*k where none; of DTensor tokens, the
    global table, replicated."""
    x = gather_seq(x)
    _, _, top_i, capacity = _routing(params, x.reshape(-1, x.shape[-1]), cfg)

    def table(ti):
        return _dispatch_indices(ti, cfg.n_experts, capacity)[0]

    return _replicas(table, top_i) if is_dtensor(top_i) else table(top_i)


def moe_apply(params: dict, x: torch.Tensor, cfg, compute_dtype):
    """x: (B, S, D) -> (y, aux_loss).  DTensor tokens (sharded by batch) are
    routed globally: the capacity counts all B S tokens and the stable sort
    orders all assignments, so exactly the assignments the unsharded layer
    drops are dropped."""
    x = gather_seq(x)
    b, s, d = x.shape
    t = b * s
    k = cfg.experts_per_token
    e = cfg.n_experts
    xt = x.reshape(t, d)
    probs, top_p, top_i, capacity = _routing(params, xt, cfg)
    if is_dtensor(xt):
        y = _experts_sharded(params, xt, top_p, top_i, capacity,
                             compute_dtype)
        frac = _replicas(lambda ti: _expert_fraction(ti, e), top_i)
    else:
        table = _dispatch_indices(top_i, e, capacity)[0]
        ye = _expert_ffn(params, _gather(xt, table, k).to(compute_dtype),
                         compute_dtype)
        y = _combine(ye, table, top_p)
        frac = _expert_fraction(top_i, e)

    if cfg.n_shared_experts:
        sp = params["shared"]
        xc = xt.to(compute_dtype)
        hg = F.silu(xc @ product_weight(sp["w_gate"], compute_dtype))
        hu = xc @ product_weight(sp["w_up"], compute_dtype)
        y = y + (hg * hu) @ product_weight(sp["w_down"], compute_dtype)

    # Switch-style load-balance aux loss: mean over tokens of the routed
    # probability mass, by expert, against each expert's share; the sum
    # over sharded tokens is reduced, so every rank holds the global loss
    aux = (probs * frac).sum()
    if is_dtensor(aux):
        from torch.distributed.tensor import Replicate
        aux = aux.redistribute(aux.device_mesh,
                               [Replicate()] * aux.device_mesh.ndim)
    return y.reshape(b, s, d), aux * (e / t)
