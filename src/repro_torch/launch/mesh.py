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

The launcher's ranks (``launch/train.py``): one rank a device, NCCL on
``cuda:LOCAL_RANK``, gloo on the CPU, no fallback (:func:`backend_for`,
:func:`rank_device`).  :func:`spawn_ranks` starts N ranks with
``torch.multiprocessing`` (``spawn``) that meet through
:func:`file_process_group` over a store file in a fresh temporary
directory; :func:`env_process_group` is one rank under ``torchrun``
(``env://``).  :func:`make_local_device_mesh` is the reference's
``make_local_mesh()`` over them: ``(world_size, 1)`` over ``("data",
"model")``.  :func:`all_reduce_int` and :func:`broadcast_int` agree on one
integer across the ranks (a preemption request, the step to resume).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import signal
import tempfile
import threading

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


def backend_for(device_type: str) -> str:
    """The process group's backend for ranks on ``device_type``: NCCL for
    CUDA (raises where this PyTorch has none: no fallback to gloo), gloo
    for the CPU."""
    if device_type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("CUDA ranks need NCCL, and this PyTorch has "
                               "no NCCL backend")
        return "nccl"
    if device_type == "cpu":
        return "gloo"
    raise ValueError(f"no rank backend for device type {device_type!r}")


def rank_device(device_type: str, local_rank: int) -> torch.device:
    """The device of the rank ``local_rank`` of this host: ``cuda:
    local_rank`` (made current; raises without that card) or the CPU."""
    if device_type != "cuda":
        return resolve_device(device_type)
    resolve_device("cuda")
    if local_rank >= torch.cuda.device_count():
        raise RuntimeError(f"rank {local_rank} of this host has no card: "
                           f"{torch.cuda.device_count()} visible")
    dev = torch.device("cuda", local_rank)
    torch.cuda.set_device(dev)
    return dev


@contextlib.contextmanager
def local_process_group(device_type: str, rank: int, world_size: int,
                        store_path: str):
    """Rank ``rank`` of ``world_size`` on this host, rendezvous through the
    store file at ``store_path``: the default process group for the block
    (destroyed on exit); yields the rank's device."""
    dev = rank_device(device_type, rank)
    with file_process_group(backend_for(device_type), rank, world_size,
                            store_path,
                            device=dev if dev.type == "cuda" else None):
        yield dev


@contextlib.contextmanager
def env_process_group(device_type: str):
    """This process as one rank of a ``torchrun`` launch (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``PORT`` from its
    environment, ``env://``): the default process group for the block
    (destroyed on exit); yields the rank's device."""
    dev = rank_device(device_type, int(os.environ.get("LOCAL_RANK", 0)))
    kw = {"device_id": dev} if dev.type == "cuda" else {}
    dist.init_process_group(backend_for(device_type), init_method="env://",
                            **kw)
    try:
        yield dev
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, nprocs: int, *args) -> None:
    """Run ``fn(rank, nprocs, store_path, *args)`` in ``nprocs`` spawned
    processes (``fn`` and ``args`` picklable; ``store_path`` a new file
    in a fresh temporary directory, for :func:`local_process_group`).
    Returns when every rank has exited 0.  If one fails, the others are
    killed and its traceback is raised here
    (``torch.multiprocessing.ProcessRaisedException``).  A SIGTERM to this
    process is passed on to every rank while they run."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            fn, args=(nprocs, os.path.join(tmp, "store"), *args),
            nprocs=nprocs, start_method="spawn", join=False)
        with _forwarded(signal.SIGTERM, ctx.pids()):
            while not ctx.join(grace_period=0):
                pass


@contextlib.contextmanager
def _forwarded(signum, pids):
    """``signum`` sent to this process is sent on to ``pids`` for the
    block (where it can be: a handler needs the main thread)."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def forward(*_):
        for pid in pids:
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, signum)

    prev = signal.signal(signum, forward)
    try:
        yield
    finally:
        signal.signal(signum, prev)


def make_local_device_mesh(device_type: str):
    """The reference's ``make_local_mesh()`` as a ``DeviceMesh``: every
    rank of the default process group along ``"data"``, ``"model"`` of
    size 1."""
    return device_mesh((dist.get_world_size(), 1), ("data", "model"),
                       device_type)


def _int_tensor(value: int) -> torch.Tensor:
    """``value`` on the device the default group's backend reduces on."""
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    return torch.tensor([int(value)], dtype=torch.int64, device=dev)


def all_reduce_int(value: int, op=dist.ReduceOp.MAX) -> int:
    """``value`` reduced over every rank of the default group by ``op``
    (every rank calls it)."""
    t = _int_tensor(value)
    dist.all_reduce(t, op=op)
    return int(t.item())


def broadcast_int(value: int, src: int = 0) -> int:
    """Rank ``src``'s ``value`` on every rank of the default group (every
    rank calls it)."""
    t = _int_tensor(value)
    dist.broadcast(t, src=src)
    return int(t.item())
