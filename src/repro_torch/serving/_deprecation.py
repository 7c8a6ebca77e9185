"""``repro_torch/serving/_deprecation.py`` ↔ ``repro/serving/_deprecation.py``.

Once-per-process deprecation warnings for the legacy serving shims.

Every deprecated deep module (``repro_torch.serving.engine``, ``.queue``,
``.metrics``, ``.propagate``, ``.decode``) funnels its import-time warning
through :func:`warn_once` so a process that imports several shims — or
re-imports one via different paths — sees exactly ONE warning per module,
not one per import site.  Python's module cache already makes a plain
module-level ``warnings.warn`` fire once per process, but only as long as
the module stays cached; test harnesses that purge ``sys.modules`` (or
``importlib.reload``) would re-fire it.  Centralizing the ledger here also
gives tests a deterministic reset point: clear ``_WARNED`` and the next
import warns again.

The blessed surface (``import repro_torch.serving``) never calls this module —
the warning-free property of the public path is pinned by
``tests/test_torch_surface.py``.
"""
from __future__ import annotations

import warnings

__all__ = ["warn_once"]

# module names that have already warned this process (tests clear this)
_WARNED: set[str] = set()


def warn_once(module: str, replacement: str) -> None:
    """Emit ``module``'s DeprecationWarning once per process.

    ``stacklevel=3`` skips this helper and the shim's module body so the
    warning points at the importer's frame, same as the historical
    module-level ``warnings.warn(..., stacklevel=2)`` did.
    """
    if module in _WARNED:
        return
    _WARNED.add(module)
    warnings.warn(
        f"{module} is deprecated; {replacement}",
        DeprecationWarning, stacklevel=3)
