"""``repro_torch/distributed/pipeline.py`` ↔ ``repro/distributed/pipeline.py``.

Pipeline parallelism (GPipe schedule): layers are split into ``n_stages``
contiguous stages, the batch into ``n_micro`` microbatches, and the stages
run the pipelined schedule.  The reference expresses it as one
``shard_map`` program over a mesh axis, ``jax.lax.ppermute`` moving each
activation to the next stage.  The port keeps the single-controller design
of the sharded engine (``distributed/sharding.py``): one process drives the
devices along the axis, stage ``s`` runs on the axis's ``s``-th device, and
the ``ppermute`` is a ``.to()`` onto the next stage's device.  Within one
clock tick the stages' work is independent, so on distinct devices it
overlaps (each device runs its own queue); a device listed several times
(``["cuda:0"] * 4``) checks the schedule, not a speed-up.

Bubble fraction is (S-1)/(M+S-1).  The reference's scan runs every stage at
each of its M + S - 1 ticks and throws away the bubble's results; the port
runs only the (stage, microbatch) pairs that carry a microbatch, so
``stage_fn`` is called ``n_micro * n_stages`` times.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch._tree import map_leaves

__all__ = ["pipeline_forward"]


def pipeline_forward(
    stage_fn: Callable,      # (stage_params, x, stage_idx) -> x
    stage_params,            # tree stacked over stages on axis 0
    x: torch.Tensor,         # (n_micro, micro_batch, ...) microbatched input
    mesh,                    # launch.mesh.LocalMesh
    axis: str = "pod",
):
    """GPipe forward over ``axis``: each device along ``axis`` holds one
    stage's params; activations move stage to stage.  Returns the last
    stage's outputs for every microbatch, ``(n_micro, micro_batch, ...)``,
    on the last stage's device."""
    devices = mesh.devices_along(axis)
    n_stages = mesh.shape[axis]
    n_micro = x.shape[0]
    params = [map_leaves(lambda p: p[s].to(dev), stage_params)
              for s, dev in enumerate(devices)]
    acts: list = [None] * n_micro     # microbatch m's activation, in flight
    for t in range(n_micro + n_stages - 1):
        for s in range(n_stages):
            m = t - s
            if not 0 <= m < n_micro:
                continue
            h = x[m] if s == 0 else acts[m]
            acts[m] = stage_fn(params[s], h.to(devices[s]), s)
    return torch.stack([a.to(devices[-1]) for a in acts])
