"""``repro_torch/launch/mesh.py`` ↔ ``repro/launch/mesh.py`` (its local mesh).

A :class:`LocalMesh` is what one process drives: axis names, their sizes
and a flat, row-major tuple of torch devices (repeats allowed, so that
``["cpu"] * D`` or ``["cuda:0"] * D`` can stand for D devices, as
``distributed.sharding.leaf_mesh`` allows).  It plays the part of the
reference's ``jax.sharding.Mesh`` for ``ShardCtx`` (``shape``, axis names)
and for ``distributed.pipeline.pipeline_forward`` (the devices along an
axis).  ``make_production_mesh`` is the reference's 16 x 16 (or 2 x 16 x 16)
mesh as such a layout, over ``meta`` devices.  Defined as functions, so
importing this module touches no device.

The SPMD form: :func:`device_mesh` is a ``torch.distributed`` ``DeviceMesh``
over the same axis names, one rank a device, built over whatever default
process group the caller has set up (``torch.distributed.tensor`` shards
the LM over it, ``distributed/sharding.py``).  :func:`file_process_group`
sets one up from a ``FileStore`` (NCCL on the card, gloo on the CPU; no
network), :func:`fake_process_group` a fake one of any size, whose
collectives move nothing, for counting a sharded step on one process
(``launch/dryrun.py``).  ``LocalMesh`` stays for ``pipeline_forward`` and
the serving engine's single controller.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch._device import resolve_device

__all__ = ["make_production_mesh", "make_local_mesh", "mesh_axis_names"]

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


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
    shape, axes = PRODUCTION[multi_pod]
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
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a :class:`LocalMesh` or a ``DeviceMesh``."""
    if isinstance(mesh, LocalMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def device_mesh(sizes: tuple, axis_names: tuple, device_type: str):
    """A ``DeviceMesh`` of ``sizes`` over ``axis_names``, rank-major, over
    the default process group, whose world size must be their product."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("device_mesh needs a default process group: "
                           "set one up first (file_process_group, "
                           "fake_process_group or torchrun)")
    n = math.prod(sizes)
    if dist.get_world_size() != n:
        raise ValueError(f"a mesh of shape {tuple(sizes)} needs {n} ranks, "
                         f"the process group has {dist.get_world_size()}")
    return DeviceMesh(device_type, torch.arange(n).reshape(tuple(sizes)),
                      mesh_dim_names=tuple(axis_names))


def production_device_mesh(*, multi_pod: bool = False):
    """:func:`make_production_mesh`'s shape as a ``DeviceMesh`` of device
    type ``cuda`` (256 or 512 ranks: a fake process group, for counting;
    DTensor leaves ``meta`` shards on ``meta``)."""
    return device_mesh(*PRODUCTION[multi_pod], "cuda")


@contextlib.contextmanager
def file_process_group(backend: str, rank: int, world_size: int,
                       store_path: str, device=None):
    """The default process group for the block, rendezvous through a
    ``FileStore`` at ``store_path`` (every rank passes the same new path);
    destroyed on exit.  ``device``: NCCL's device for this rank."""
    store = dist.FileStore(str(store_path), world_size)
    kw = {"device_id": torch.device(device)} if device is not None else {}
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size, **kw)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """A default process group of ``world_size`` ranks driven by this one
    process as rank 0: collectives are issued and return at once, moving
    nothing.  A sharded step runs rank 0's part of the program on it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
