"""Device resolution for the port's entry points (no counterpart in ``repro``).

``None`` means the CUDA card.  There is no fallback: without a card the
caller must ask for the CPU (``device="cpu"``), as the tests do, or the call
raises.  Resolving a device also turns TF32 off for float32 matrix products
and convolutions, so every matmul in the port runs in full float32 like the
reference.  A ``meta`` device holds shapes and types only (the dry run,
``launch/dryrun.py``, counts work on it); it is no fallback.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "seeded_generator"]


def resolve_device(device=None) -> torch.device:
    """The torch device an entry point runs on; ``None`` -> ``cuda``.

    Raises ``RuntimeError`` for a CUDA device when no card is present.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device unless device='cpu' is passed, "
            "and no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def seeded_generator(device: torch.device, seed: int) -> torch.Generator:
    """``torch.Generator(device).manual_seed(seed)``; for a ``meta`` device,
    which has no generator and draws no values, a CPU one."""
    dev = torch.device(device)
    return torch.Generator(device="cpu" if dev.type == "meta" else dev) \
        .manual_seed(int(seed))
