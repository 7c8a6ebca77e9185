"""``repro_torch/distributed/compression.py`` ↔ ``repro/distributed/compression.py``.

Gradient compression for a cross-pod (DCN) all-reduce, run around the
reduce: compress -> all-reduce -> decompress.

* ``bf16_compress`` casts float32 gradients to bfloat16 (round to nearest
  even, as the reference's ``astype``: equal to it bit for bit), and
  ``bf16_decompress`` back (2x traffic cut).
* ``int8_compress`` is per-tensor symmetric int8 with stochastic rounding
  (4x cut): ``scale = max(max|g|, 1e-12) / 127``, ``q = floor(g / scale) +
  (u < frac)`` for uniforms ``u`` in [0, 1), clipped to [-127, 127].
  Stochastic rounding keeps E[deq(q(g))] = g, so SGD remains unbiased.

The reference draws ``u`` from a ``jax.random`` key (threefry), which torch
cannot reproduce.  So the port draws it from an explicit ``torch.Generator``
(on the gradient's device), or takes it as ``uniforms=`` (a tensor for one
gradient, a tree matching the gradients for ``compress_tree``), which lets
``q`` equal the reference's bit for bit when its uniforms are replayed.
``compress_tree`` draws per leaf in JAX's leaf order (``_tree.flatten``),
as the reference splits its key.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch._tree import flatten, map_leaves, unflatten

__all__ = ["bf16_compress", "bf16_decompress", "int8_compress",
           "int8_decompress", "compress_tree", "decompress_tree"]


def bf16_compress(g: torch.Tensor) -> torch.Tensor:
    return g.to(torch.bfloat16)


def bf16_decompress(g: torch.Tensor) -> torch.Tensor:
    return g.to(torch.float32)


def int8_compress(g: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  uniforms: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 with stochastic rounding: ``(q, scale)``.
    The uniforms are ``uniforms`` if given, else drawn from ``generator``."""
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    scaled = g / scale
    floor = torch.floor(scaled)
    frac = scaled - floor
    if uniforms is not None:
        rnd = torch.as_tensor(uniforms, device=g.device)
        if rnd.shape != g.shape:
            raise ValueError(f"uniforms of shape {tuple(rnd.shape)} for a "
                             f"gradient of shape {tuple(g.shape)}")
    elif generator is not None:
        rnd = torch.rand(g.shape, generator=generator, device=g.device)
    else:
        raise ValueError("int8_compress needs a generator or uniforms")
    q = floor + (rnd < frac).to(scaled.dtype)
    q = torch.clamp(q, -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_tree(grads, mode: str, generator=None, uniforms=None):
    if mode == "none":
        return grads, None
    if mode == "bf16":
        return map_leaves(bf16_compress, grads), None
    if mode == "int8":
        leaves, treedef = flatten(grads)
        draws = ([None] * len(leaves) if uniforms is None
                 else flatten(uniforms)[0])
        if len(draws) != len(leaves):
            raise ValueError("uniforms do not match the gradients' structure")
        qs, scales = zip(*(int8_compress(leaf, generator, u)
                           for leaf, u in zip(leaves, draws)))
        return unflatten(treedef, qs), unflatten(treedef, scales)
    raise ValueError(mode)


def decompress_tree(grads, aux, mode: str):
    if mode == "none":
        return grads
    if mode == "bf16":
        return map_leaves(bf16_decompress, grads)
    if mode == "int8":
        return map_leaves(int8_decompress, grads, aux)
    raise ValueError(mode)
