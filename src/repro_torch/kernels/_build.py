"""Build and load the port's CUDA kernels (no counterpart in ``repro``).

Each ``csrc/*.cu`` source has a plain C interface.  It is compiled with
``nvcc`` for ``sm_90a`` into a shared library under ``build/repro_torch/`` at
the root of the checkout (listed in ``.gitignore``) at first use, and loaded
with ``ctypes``.  The library's name carries a digest of the source and the
flags, so an edited source builds anew and an unchanged one is reused.
Nothing here runs at import time.
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

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "BuiltLibrary", "load_library"]

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class BuiltLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float   # 0.0 when an earlier build of this digest was reused
    log: str               # nvcc's output, ``-Xptxas -v`` lines included


_LOCK = threading.Lock()
_LOADED: dict[Path, BuiltLibrary] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError("nvcc not found: building the CUDA kernels needs "
                           "the CUDA toolkit on PATH or in /usr/local/cuda")
    return nvcc


def load_library(source: Path) -> BuiltLibrary:
    """Compile ``source`` (once per content digest) and load it."""
    source = Path(source).resolve()
    with _LOCK:
        if source in _LOADED:
            return _LOADED[source]
        digest = hashlib.sha256(source.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        out = BUILD_DIR / f"{source.stem}-{digest}.so"
        seconds, log = 0.0, ""
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            t0 = time.perf_counter()
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                   str(source)], capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {source.name}:\n{log}")
            os.replace(tmp, out)
        built = BuiltLibrary(lib=ctypes.CDLL(str(out)), path=out,
                             build_seconds=seconds, log=log)
        _LOADED[source] = built
        return built
