"""``repro_torch/training/optimizer.py`` ↔ ``repro/training/optimizer.py``.

AdamW with decoupled weight decay and a warmup + cosine learning-rate
schedule, in plain tensor ops on a nested dict of parameters, in the
reference's order: the gradients clipped by their global norm, the moments
updated in float32, bias correction by ``step``, the decay applied to the
float32 parameter.  Functional as in the reference: an update returns new
parameters and a new state and leaves its arguments as they were.  ``step``
and the learning rate are 0-d tensors on the parameters' device, so an
update never waits for the device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch._device import is_dtensor
from repro_torch.distributed.sharding import redistribute

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "global_norm", "tree_map", "warmup_cosine"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32
    mu: dict
    nu: dict


def tree_map(fn, tree: dict, *rest: dict) -> dict:
    """``fn`` over the leaves of nested dicts of one structure."""
    return {k: tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def _leaves(tree: dict):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def warmup_cosine(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def adamw_init(params: dict) -> AdamWState:
    """Zero float32 moments, ``step`` 0, on the parameters' device."""
    device = next(_leaves(params)).device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        mu=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params),
        nu=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params))


def global_norm(tree: dict) -> torch.Tensor:
    """The square root of every leaf's squares summed.  Of DTensors (each
    sharded or replicated on each mesh dimension), every rank sums its
    shards' squares, a replicated leaf's over the ranks that hold a copy,
    and one all-reduce over the whole mesh adds the ranks' sums: adding
    the leaves' own sums as DTensors reduces some of them one by one in
    some PyTorch versions."""
    leaves = list(_leaves(tree))
    if not (leaves and is_dtensor(leaves[0])):
        return torch.sqrt(sum(leaf.to(torch.float32).square().sum()
                              for leaf in leaves))
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = leaves[0].device_mesh
    local = sum(leaf.to_local().to(torch.float32).square().sum()
                / math.prod(mesh.size(i) for i, p in
                            enumerate(leaf.placements) if p.is_replicate())
                for leaf in leaves)
    total = DTensor.from_local(local, mesh, [Partial()] * mesh.ndim,
                               run_check=False)
    return torch.sqrt(redistribute(total, [Replicate()] * mesh.ndim))


def adamw_update(cfg: AdamWConfig, grads: dict, state: AdamWState,
                 params: dict):
    """Returns ``(new_params, new_state, metrics)``; ``metrics`` holds the
    gradients' global norm before clipping and the step's learning rate."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    lr = warmup_cosine(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, device=step.device), stepf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, device=step.device), stepf)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m2 = cfg.b1 * m + (1 - cfg.b1) * g
        v2 = cfg.b2 * v + (1 - cfg.b2) * g * g
        delta = (m2 / b1c) / (torch.sqrt(v2 / b2c) + cfg.eps) \
            + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), m2, v2

    out = tree_map(upd, params, grads, state.mu, state.nu)
    new_params, new_mu, new_nu = (_pick(out, i) for i in range(3))
    return new_params, AdamWState(step=step, mu=new_mu, nu=new_nu), {
        "grad_norm": gnorm, "lr": lr}


def _pick(tree: dict, i: int) -> dict:
    """Element ``i`` of every tuple leaf of ``tree``."""
    return {k: _pick(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}
