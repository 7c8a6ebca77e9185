"""Sub-seeds of a run's ``--seed``: one independent stream per purpose."""
from __future__ import annotations

import hashlib


def subseed(seed: int, purpose: str) -> int:
    """A 63-bit seed for ``purpose`` drawn from ``seed`` (any whole number,
    of any size: the driver's seeds exceed 32 bits)."""
    digest = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1
