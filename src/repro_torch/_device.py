"""Device resolution for the port's entry points (no counterpart in ``repro``).

``None`` means the CUDA card.  There is no fallback: without a card the
caller must ask for the CPU (``device="cpu"``), as the tests do, or the call
raises.  Resolving a device also turns TF32 off for float32 matrix products
and convolutions, so every matmul in the port runs in full float32 like the
reference.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


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
