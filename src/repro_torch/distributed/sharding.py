"""``repro_torch/distributed/sharding.py`` ↔ ``repro/distributed/sharding.py``
(its leaf-order part, ``LEAF_AXIS``, ``leaf_mesh`` and ``leaf_sharding``).

The sharded serving engine (``serving/_sharded.py``) partitions LEAF-ORDER
arrays — label stacks ``(n_leaves, K)``, the leaf mask — row-wise over a 1-D
mesh of shards.  A complete perfect-binary-tree level always has a
power-of-two row count, so a power-of-two shard count divides it evenly and
every shard owns one aligned subtree of the partition tree.

The reference's mesh is a ``jax.sharding.Mesh`` driven by one process: its
collectives are parts of one ``shard_map`` program.  The port keeps that
single-controller design: a :class:`LeafMesh` is an ordered tuple of torch
devices that one process drives, a shard's body runs on its own device, and
an all-gather is a concatenation of the shards' tensors moved to each
shard's device.  A device may hold more than one shard, which plays the part
of the reference's forced host device count: the CPU tests run 2, 4 and 8
shards on ``["cpu"] * D``, the card runs them on ``cuda:0``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch._device import resolve_device

__all__ = ["LEAF_AXIS", "LeafMesh", "LeafSharding", "leaf_mesh",
           "leaf_sharding"]

LEAF_AXIS = "leaves"


@dataclasses.dataclass(frozen=True)
class LeafMesh:
    """An ordered, power-of-two tuple of shard devices along one axis."""

    devices: tuple
    axis: str = LEAF_AXIS

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct_devices(self) -> tuple:
        """The mesh's devices without repeats, in first-use order."""
        return tuple(dict.fromkeys(self.devices))


@dataclasses.dataclass(frozen=True)
class LeafSharding:
    """The row-stripe layout of leaf-order arrays over a :class:`LeafMesh`:
    shard ``s`` of ``D`` holds rows ``[s * R / D, (s + 1) * R / D)`` of an
    ``R``-row array (the reference's ``NamedSharding(mesh, P(axis, None))``)."""

    mesh: LeafMesh

    def stripes(self, n_rows: int) -> list:
        """``(start, stop)`` of each shard's rows; ``n_rows`` must divide."""
        d = self.mesh.size
        if n_rows % d:
            raise ValueError(f"{n_rows} rows do not divide over {d} shards")
        rps = n_rows // d
        return [(s * rps, (s + 1) * rps) for s in range(d)]

    def scatter(self, x: torch.Tensor) -> list:
        """Each shard's row stripe of ``x``, on the shard's device."""
        return [x[a:b].to(dev) for (a, b), dev in
                zip(self.stripes(x.shape[0]), self.mesh.devices)]

    def gather(self, parts, device) -> torch.Tensor:
        """The all-gather: the shards' stripes concatenated on ``device``."""
        return torch.cat([p.to(device) for p in parts], dim=0)


def leaf_mesh(devices=None, *, axis: str = LEAF_AXIS) -> LeafMesh:
    """1-D mesh over ``devices`` (default: every visible CUDA device).

    The count must be a power of two: each shard then owns a whole subtree
    of the (perfect binary) partition tree, which is what makes the sharded
    CollectUp/DistributeDown decomposition exact.  Without a card the
    default raises ``RuntimeError``, as every entry point of the port does;
    pass ``devices=["cpu"] * D`` to run on the CPU.
    """
    if devices is None:
        resolve_device(None)  # raises without a card: no CPU fallback
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [resolve_device(d) for d in devices]
    n = len(devs)
    if n < 1 or n & (n - 1):
        raise ValueError(
            f"leaf_mesh wants a power-of-two device count, got {n}")
    return LeafMesh(devices=tuple(devs), axis=axis)


def leaf_sharding(mesh: LeafMesh) -> LeafSharding:
    """Row-stripe layout for leaf-order ``(n_leaves, K)`` arrays."""
    return LeafSharding(mesh)
