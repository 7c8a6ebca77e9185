"""``repro_torch/launch/mesh.py`` ↔ ``repro/launch/mesh.py`` (its local mesh).

A :class:`LocalMesh` is what one process drives: axis names, their sizes
and a flat, row-major tuple of torch devices (repeats allowed, so that
``["cpu"] * D`` or ``["cuda:0"] * D`` can stand for D devices, as
``distributed.sharding.leaf_mesh`` allows).  It plays the part of the
reference's ``jax.sharding.Mesh`` for ``ShardCtx`` (``shape``, axis names)
and for ``distributed.pipeline.pipeline_forward`` (the devices along an
axis).  Defined as functions, so importing this module touches no device.

The reference's ``make_production_mesh`` (a 16 x 16 or 2 x 16 x 16 TPU
mesh for the dry run) is not here: it belongs to the dry-run tooling,
ROADMAP Queue 1 item 12h.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch._device import resolve_device

__all__ = ["make_production_mesh", "make_local_mesh", "mesh_axis_names"]


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    axis_names: tuple
    sizes: tuple
    devices: tuple       # row-major over ``sizes``

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes) or \
                math.prod(self.sizes) != len(self.devices):
            raise ValueError(f"a mesh of shape {self.sizes} over axes "
                             f"{self.axis_names} needs "
                             f"{math.prod(self.sizes)} devices, got "
                             f"{len(self.devices)}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    def devices_along(self, axis: str) -> tuple:
        """The devices at each index of ``axis``, every other index 0."""
        k = self.axis_names.index(axis)
        stride = math.prod(self.sizes[k + 1:])
        return tuple(self.devices[i * stride] for i in range(self.sizes[k]))


def make_production_mesh(*, multi_pod: bool = False) -> LocalMesh:
    """16x16 single-pod (256 chips) or 2x16x16 multi-pod (512 chips), over
    ``meta`` devices: a layout to plan shardings on, not to run."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return LocalMesh(axes, shape, (torch.device("meta"),) * math.prod(shape))


def make_local_mesh(data: int | None = None, model: int = 1, devices=None):
    """Small ``("data", "model")`` mesh over ``devices`` (default: every
    visible CUDA device; without a card that raises, pass e.g.
    ``devices=["cpu"] * D``)."""
    if devices is None:
        resolve_device(None)  # raises without a card: no CPU fallback
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [resolve_device(d) for d in devices]
    if data is None:
        data = len(devs) // model
    return LocalMesh(("data", "model"), (data, model), tuple(devs))


def mesh_axis_names(mesh) -> tuple[str, ...]:
    return tuple(mesh.axis_names)
