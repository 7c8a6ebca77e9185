"""``repro_torch/runtime/checkpoint.py`` ↔ ``repro/runtime/checkpoint.py``.

Fault-tolerant checkpointing: atomic, async, elastic, in the reference's
on-disk format::

    <dir>/step_000123/
        manifest.json      # step, config fingerprint, tree structure, shapes
        arrays.npz         # flat {index -> ndarray}, full (unsharded) values
    <dir>/LATEST           # atomic pointer file

* **Atomicity**: writes go to ``step_X.tmp-<pid>-<n>`` then ``os.rename``; a
  crashed writer never corrupts the pointer; LATEST is rewritten last.
* **Async**: ``save_async`` copies every leaf to host memory before it
  returns (the only blocking part) and writes in a daemon thread.  A leaf
  already on the CPU is cloned: ``Tensor.numpy()`` shares the tensor's
  memory, so without the copy a later in-place write would reach the file
  being written (the reference's ``np.asarray`` of a JAX array is a copy).
* **Interchange**: leaves are numbered in JAX's order (``_tree.flatten``:
  dict keys sorted, tuple and ``NamedTuple`` fields in order), so a
  checkpoint written by either package restores in the other with every
  leaf in its place; :func:`config_fingerprint` hashes a configuration as
  the reference does.
* **Elastic**: the stored arrays are whole.  :func:`restore` places each
  leaf on the device of the matching leaf of ``like``, or on ``device``;
  where ``like``'s leaf is a DTensor, the result is a DTensor of its mesh
  and placements, each rank keeping its own shard of the stored array: the
  port's form of the reference's ``shardings``.  So a checkpoint moves
  between the CPU and the card, between device lists of any length, and
  between any numbers of ranks.
* **Sharded state**: under a ``torch.distributed`` process group,
  :func:`save` and :func:`save_async` are collectives that every rank calls
  with its own shards of the same tree.  Each DTensor leaf is gathered whole
  (``full_tensor()``, in ``_tree.flatten``'s leaf order, the same on every
  rank); only rank 0 of the default group writes (in ``save_async``, in its
  background thread); ``save`` returns on every rank once rank 0's write
  has ended, and raises on every rank if it failed.  Without a process
  group nothing of this runs.

A failed background write is raised by the next ``save_async`` or by
``wait_for_saves`` (the reference's thread would only print it).
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._device import is_dtensor, resolve_device
from repro_torch._tree import flatten, unflatten

__all__ = ["save", "save_async", "restore", "latest_step", "config_fingerprint"]

_TMP_COUNTER = itertools.count()


def config_fingerprint(cfg) -> str:
    if dataclasses.is_dataclass(cfg):
        payload = json.dumps(dataclasses.asdict(cfg), sort_keys=True, default=str)
    else:
        payload = repr(cfg)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def _host_array(leaf) -> np.ndarray:
    """A numpy view of a leaf for writing (a CPU tensor's memory is shared)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _host_copy(leaf):
    """A copy of a leaf in host memory that no later write to it reaches."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        return t.clone() if t.device.type == "cpu" else t.to("cpu")
    return np.array(leaf)


def _sharded() -> bool:
    """Whether this process is one rank of a ``torch.distributed`` group."""
    return dist.is_available() and dist.is_initialized()


def _gathered(leaves: list, to_host) -> list:
    """``to_host`` of each leaf's whole value on the writing rank (rank 0
    of the default group, or the only process), ``[]`` on every other: a
    DTensor leaf is gathered first, a collective every rank joins in this
    order, one leaf at a time."""
    writer = not _sharded() or dist.get_rank() == 0
    host = []
    for leaf in leaves:
        if is_dtensor(leaf):
            leaf = leaf.detach().full_tensor()
        if writer:
            host.append(to_host(leaf))
    return host


def save(ckpt_dir: str | Path, step: int, tree: Any, fingerprint: str = "",
         _collective: bool = True) -> Path:
    """Synchronous atomic checkpoint write.  Under a process group (and
    ``_collective``, which only ``save_async``'s writer thread turns off on
    its host snapshot) every rank calls it: rank 0 writes, and every rank
    returns once the checkpoint exists or raises if the write failed."""
    leaves, treedef = flatten(tree)
    if not (_collective and _sharded()):
        return _write(Path(ckpt_dir), step, treedef,
                      [_host_array(leaf) for leaf in leaves], fingerprint)
    from repro_torch.launch.mesh import all_reduce_int

    host, error = _gathered(leaves, _host_array), None
    if dist.get_rank() == 0:
        try:
            _write(Path(ckpt_dir), step, treedef, host, fingerprint)
        except Exception as e:  # every rank must hear of it, then raise
            error = e
    del host
    if not all_reduce_int(error is None, dist.ReduceOp.MIN):
        raise RuntimeError(f"checkpoint step {step}: rank 0's write "
                           "failed") from error
    return Path(ckpt_dir) / f"step_{step:08d}"


def _write(ckpt_dir: Path, step: int, treedef, host: list,
           fingerprint: str) -> Path:
    """Write the host arrays ``host`` as ``step``'s checkpoint, atomically."""
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / (f"step_{step:08d}.tmp-{os.getpid()}"
                      f"-{next(_TMP_COUNTER)}")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    np.savez(tmp / "arrays.npz", **{str(i): a for i, a in enumerate(host)})
    manifest = {
        "step": step,
        "fingerprint": fingerprint,
        "treedef": str(treedef),
        "n_leaves": len(host),
        "shapes": [list(a.shape) for a in host],
        "dtypes": [str(a.dtype) for a in host],
        "time": time.time(),
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)

    ptr_tmp = ckpt_dir / f".LATEST.tmp-{os.getpid()}-{next(_TMP_COUNTER)}"
    ptr_tmp.write_text(final.name)
    os.rename(ptr_tmp, ckpt_dir / "LATEST")
    return final


class _AsyncSaver:
    """Single background writer; at most one outstanding save (newer wins)."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._lock = threading.Lock()

    def submit(self, ckpt_dir, step, tree, fingerprint=""):
        # snapshot to host synchronously (cheap vs serialization); sharded
        # leaves are gathered by every rank, and only the writer (rank 0)
        # keeps a snapshot and starts a thread
        leaves, treedef = flatten(tree)
        host = _gathered(leaves, _host_copy)
        if _sharded() and dist.get_rank() != 0:
            return
        snapshot = unflatten(treedef, host)

        def work():
            try:
                save(ckpt_dir, step, snapshot, fingerprint,
                     _collective=False)
            except Exception as e:  # raised again by the caller's next wait
                self._error = e

        with self._lock:
            self._join()  # backpressure: never queue > 1
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def _join(self):
        if self._thread is not None:
            self._thread.join()
        error, self._error = self._error, None
        if error is not None:
            raise RuntimeError("a background checkpoint write failed") \
                from error

    def wait(self):
        with self._lock:
            self._join()


_SAVER = _AsyncSaver()


def save_async(ckpt_dir, step, tree, fingerprint=""):
    """Snapshot ``tree`` to host memory, then write it in the background.
    Under a process group every rank calls it (the snapshot gathers
    DTensor leaves); rank 0 writes."""
    _SAVER.submit(ckpt_dir, step, tree, fingerprint)


def wait_for_saves():
    """Wait for this process's background write, raising its failure (on
    the ranks of a group only rank 0 has one)."""
    _SAVER.wait()


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    ptr = Path(ckpt_dir) / "LATEST"
    if not ptr.exists():
        return None
    name = ptr.read_text().strip()
    if not (Path(ckpt_dir) / name / "manifest.json").exists():
        return None
    return int(name.split("_")[1])


def restore(ckpt_dir: str | Path, like: Any, step: Optional[int] = None,
            device: Any = None, expect_fingerprint: str = ""):
    """Restore into the structure of ``like``; returns ``(tree, step)``.

    Each leaf is a tensor of the stored dtype, on ``device`` if given, else
    on the device of the matching leaf of ``like`` (the CPU for a leaf that
    is not a tensor): the stored global arrays are placed onto the
    *current* devices regardless of those they were saved from.  Where
    ``like``'s leaf is a DTensor, the leaf is a DTensor on its mesh with
    its placements, whose local tensor is this rank's shard of the stored
    array (``device`` does not apply; no collective: every rank reads the
    file).
    """
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    if expect_fingerprint and manifest["fingerprint"] != expect_fingerprint:
        raise ValueError(
            f"checkpoint fingerprint {manifest['fingerprint']} != expected "
            f"{expect_fingerprint} — refusing to load a mismatched config"
        )
    leaves, treedef = flatten(like)
    if len(leaves) != manifest["n_leaves"]:
        raise ValueError("checkpoint structure mismatch")
    if device is not None:
        devices = [resolve_device(device)] * len(leaves)
    else:
        devices = [leaf.device if isinstance(leaf, torch.Tensor)
                   else torch.device("cpu") for leaf in leaves]
    out = []
    with np.load(d / "arrays.npz") as data:
        for i, (ref, dev) in enumerate(zip(leaves, devices)):
            a = data[str(i)]
            if tuple(a.shape) != tuple(ref.shape):
                raise ValueError(f"leaf {i}: shape {a.shape} != {ref.shape}")
            t = torch.from_numpy(a)
            out.append(_shard_like(t, ref, i) if is_dtensor(ref)
                       else t.to(dev))
    return unflatten(treedef, out), step


def _shard_like(whole: torch.Tensor, like, i: int):
    """The stored array ``whole`` laid out as the DTensor ``like``: this
    rank's shard of it, on ``like``'s device."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import own_shard

    pl = tuple(like.placements)
    if any(p.is_partial() for p in pl):
        raise ValueError(f"leaf {i}: cannot restore onto a Partial DTensor")
    local = own_shard(whole, pl, like.device_mesh).to(like.device)
    if tuple(local.shape) != tuple(like.to_local().shape):
        raise ValueError(f"leaf {i}: shard {tuple(local.shape)} != "
                         f"{tuple(like.to_local().shape)} (uneven shards)")
    return DTensor.from_local(local, like.device_mesh, pl, run_check=False,
                              shape=whole.shape, stride=whole.stride())
