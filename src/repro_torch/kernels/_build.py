"""Build and load the port's CUDA kernels (no counterpart in ``repro``).

Each ``csrc/*.cu`` source has a plain C interface.  It is compiled with
``nvcc`` for ``sm_90a`` into a shared library under ``build/repro_torch/`` at
the root of the checkout (listed in ``.gitignore``) at first use, and loaded
with ``ctypes``.  Sources include the shared headers of ``kernels/csrc/``
(``INCLUDE_DIR``, passed as ``-I``).  The library's name carries a digest of
the source, every header there and the flags, so an edited source or header
builds anew and an unchanged one is reused.
Sources build concurrently: each holds only its own lock.  Nothing here runs
at import time.

Every source exports ``const char* cuda_error_string(int)`` beside its entry
points, each of which returns ``cudaGetLastError()`` after its launch;
:func:`launch` turns a non-zero code into an exception.  :func:`check_operand`
and :func:`on_card` are the wrappers' shared operand checks and dispatch rule:
a CUDA tensor launches the kernel, a CPU tensor runs the plain version, and
any other device raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = ["BUILD_DIR", "INCLUDE_DIR", "NVCC_FLAGS", "BuiltLibrary",
           "check_operand", "digest", "launch", "load_library", "on_card"]

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
INCLUDE_DIR = Path(__file__).resolve().parent / "csrc"   # shared headers
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class BuiltLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float   # 0.0 when an earlier build of this digest was reused
    log: str               # nvcc's output, ``-Xptxas -v`` lines included


_LOCK = threading.Lock()          # guards _SOURCE_LOCKS
_SOURCE_LOCKS: dict[Path, threading.Lock] = {}
_LOADED: dict[Path, BuiltLibrary] = {}   # written under the source's lock


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError("nvcc not found: building the CUDA kernels needs "
                           "the CUDA toolkit on PATH or in /usr/local/cuda")
    return nvcc


def load_library(source: Path) -> BuiltLibrary:
    """Compile ``source`` (once per content digest) and load it.

    Every launch calls this, so a loaded library is found by a dict lookup
    on ``source`` as given, with no file-system call.
    """
    built = _LOADED.get(source)
    if built is not None:
        return built
    with _LOCK:
        lock = _SOURCE_LOCKS.setdefault(source, threading.Lock())
    with lock:
        if source not in _LOADED:
            _LOADED[source] = _build(Path(source).resolve())
        return _LOADED[source]


def digest(source: Path, include_dir: Path = INCLUDE_DIR) -> str:
    """The build's key: the source, every ``*.cuh`` in ``include_dir`` (name
    and bytes) and the flags."""
    h = hashlib.sha256(Path(source).read_bytes())
    for header in sorted(Path(include_dir).glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _build(source: Path) -> BuiltLibrary:
    out = BUILD_DIR / f"{source.stem}-{digest(source)}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(INCLUDE_DIR),
                               "-o", str(tmp), str(source)],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name}:\n{log}")
        os.replace(tmp, out)
    built = BuiltLibrary(lib=ctypes.CDLL(str(out)), path=out,
                         build_seconds=seconds, log=log)
    built.lib.cuda_error_string.argtypes = [ctypes.c_int]
    built.lib.cuda_error_string.restype = ctypes.c_char_p
    return built


def on_card(what: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one."""
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"{what}: unsupported device {t.device}")
    return False


def check_operand(name: str, t: torch.Tensor, shape: tuple, device,
                  dtypes=(torch.float32,)) -> None:
    """Raise ``ValueError`` unless ``t`` is what a kernel takes."""
    if t.device != device or t.dtype not in dtypes:
        raise ValueError(f"{name} must be {' or '.join(map(str, dtypes))} on "
                         f"{device}, got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.numel() >= 2 ** 31:
        raise ValueError(f"{name} is too large for int32 indexing")


def launch(built: BuiltLibrary, fn_name: str, device: torch.device,
           *args) -> None:
    """Call entry point ``fn_name`` with ``args`` and the current stream of ``device``."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(built.lib, fn_name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: "
                           + built.lib.cuda_error_string(err).decode())
