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
  leaf on the device of the matching leaf of ``like``, or on ``device``:
  the port's form of the reference's ``shardings``.  So a checkpoint moves between the CPU and
  the card, and between device lists of any length.

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

from repro_torch._device import resolve_device
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


def save(ckpt_dir: str | Path, step: int, tree: Any,
         fingerprint: str = "") -> Path:
    """Synchronous atomic checkpoint write."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / (f"step_{step:08d}.tmp-{os.getpid()}"
                      f"-{next(_TMP_COUNTER)}")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    leaves, treedef = flatten(tree)
    host = [_host_array(leaf) for leaf in leaves]
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
        # snapshot to host synchronously (cheap vs serialization)
        leaves, treedef = flatten(tree)
        snapshot = unflatten(treedef, [_host_copy(leaf) for leaf in leaves])

        def work():
            try:
                save(ckpt_dir, step, snapshot, fingerprint)
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
    _SAVER.submit(ckpt_dir, step, tree, fingerprint)


def wait_for_saves():
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
    *current* devices regardless of those they were saved from.
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
            out.append(torch.from_numpy(a).to(dev))
    return unflatten(treedef, out), step
