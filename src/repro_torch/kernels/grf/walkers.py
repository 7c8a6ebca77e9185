"""``repro_torch/kernels/grf/walkers.py`` ↔ ``repro/kernels/grf/walkers.py``.

Batched terminating random walks over a padded CSR neighbor table, the
sampling half of the GRF backend.  Every node launches ``n_walkers``
walkers; each carries an importance-sampling *load* that keeps the
estimator unbiased:

* the next hop is drawn **uniformly** over the current node's neighbors, and
  the load multiplies by the importance weight ``deg(u) * P[u, v]``, so that
  ``E[load_t * f(pos_t)] = (P^t f)(start)`` exactly;
* with ``p_halt > 0`` walkers stop geometrically; survivors divide their load
  by ``(1 - p_halt)`` per step, so stopping thins the population without
  bias (dead walkers keep stepping with load 0, so the arrays stay
  rectangular).

Randomness.  A step consumes two uniforms per walker, ``u`` of shape
``(W, 2)``: ``u[:, 0]`` picks the neighbor slot, ``u[:, 1]`` decides halting.
:func:`walk_step` takes them as an argument, and :func:`sample_walks` (and
``core.grf``'s streamed estimator) ask ``draw(t)`` for step ``t = 1..T``.
The default :func:`default_draw` is a ``torch.Generator`` on the walkers'
device, seeded with ``seed``, that draws ``torch.rand((W, 2))`` once per step
in step order.  That keeps the reference's promises within the port, on a
given device: the same ``(seed, shapes)`` give the same walks bit for bit;
walks of horizon ``T`` are the first ``T`` steps of horizon ``T' > T``; and
``sample_walks`` and the streamed estimator consume the same walks.  The
reference's threefry streams are not reproduced, and the CPU and CUDA
generators give different walks for one seed.  A test that wants the
reference's walks passes the reference's uniforms through ``draw``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch._device import seeded_generator

__all__ = ["Draw", "default_draw", "sample_walks", "start_state", "walk_step"]

Draw = Callable[[int], torch.Tensor]


def default_draw(seed: int, n_walkers_total: int, device) -> Draw:
    """``draw(t)``: ``(W, 2)`` float32 uniforms for step ``t``, steps in order 1, 2, ..."""
    gen = seeded_generator(device, seed)
    expected = [1]

    def draw(t: int) -> torch.Tensor:
        if t != expected[0]:
            raise ValueError(f"default_draw serves steps in order: asked for "
                             f"step {t}, next is {expected[0]}")
        expected[0] += 1
        return torch.rand((n_walkers_total, 2), generator=gen, device=device)

    return draw


def walk_step(nbr: torch.Tensor, prob: torch.Tensor, deg: torch.Tensor,
              pos: torch.Tensor, load: torch.Tensor, alive: torch.Tensor,
              u: torch.Tensor, p_halt: float = 0.0):
    """Advance every walker one step; returns ``(pos, load, alive)``.

    ``nbr``/``prob`` are the padded ``(N, max_deg)`` neighbor table and
    transition probabilities, ``deg`` the true ``(N,)`` neighbor counts;
    ``pos`` (int32), ``load`` (float32) and ``alive`` (bool) are the ``(W,)``
    walker state and ``u`` the step's ``(W, 2)`` uniforms.
    """
    d = deg[pos]                                        # (W,) true degrees
    slot = torch.minimum((u[:, 0] * d).to(torch.int32), d - 1)
    nxt = nbr[pos, slot]
    # uniform proposal over deg(u) neighbors -> importance weight deg * P
    mult = d.to(torch.float32) * prob[pos, slot]
    if p_halt > 0.0:
        alive = alive & (u[:, 1] >= p_halt)
        mult = mult / (1.0 - p_halt)  # survivor correction: stays unbiased
    load = load * mult * alive.to(torch.float32)
    return nxt, load, alive


def start_state(n: int, n_walkers: int, device):
    """Walkers of every node at their start: ``(pos, load, alive)``, each ``(N*m,)``."""
    pos = torch.arange(n, dtype=torch.int32, device=device).repeat_interleave(
        n_walkers)
    w = pos.shape[0]
    return (pos, torch.ones((w,), dtype=torch.float32, device=device),
            torch.ones((w,), dtype=torch.bool, device=device))


def sample_walks(nbr: torch.Tensor, prob: torch.Tensor, deg: torch.Tensor, *,
                 n_steps: int, n_walkers: int, seed: int = 0,
                 p_halt: float = 0.0, draw: Optional[Draw] = None):
    """Full walk histories: ``(pos, load)``, each ``(N, m, n_steps + 1)``.

    ``pos[i, w, t]``/``load[i, w, t]`` are walker ``w`` of node ``i`` after
    ``t`` steps (``t = 0`` is the start: ``pos = i``, ``load = 1``), so
    ``mean_w load[:, :, t] * f(pos[:, :, t])`` estimates ``P^t f`` for every
    ``t <= n_steps`` from one walk set.  O(N m T) memory, for analysis and
    tests; ``core.grf.grf_label_propagate`` streams the same steps.
    ``draw`` defaults to :func:`default_draw` with ``seed``.
    """
    n = nbr.shape[0]
    pos, load, alive = start_state(n, int(n_walkers), nbr.device)
    if draw is None:
        draw = default_draw(seed, pos.shape[0], nbr.device)
    ps, ls = [pos], [load]
    for t in range(1, int(n_steps) + 1):
        pos, load, alive = walk_step(nbr, prob, deg, pos, load, alive,
                                     draw(t), p_halt)
        ps.append(pos)
        ls.append(load)
    shape = (n, int(n_walkers), int(n_steps) + 1)
    return (torch.stack(ps, dim=-1).reshape(shape),
            torch.stack(ls, dim=-1).reshape(shape))
