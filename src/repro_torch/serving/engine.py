"""``repro_torch/serving/engine.py`` ↔ ``repro/serving/engine.py``.

Deprecated shim: import from :mod:`repro_torch.serving` instead.

The engine implementation moved to the private ``repro_torch.serving._engine``
module when the abstract :mod:`repro_torch.serving.engine_api` contract landed;
this module re-exports the historical names so existing imports keep
working, with a once-per-process :class:`DeprecationWarning` at import time.
"""
from repro_torch.serving._batching import PropagateRequest
from repro_torch.serving._deprecation import warn_once
from repro_torch.serving._engine import PropagateEngine
from repro_torch.serving._queue import DeadlineExceeded, QueueFull

warn_once(
    "repro_torch.serving.engine",
    "import PropagateEngine, PropagateRequest, QueueFull, and "
    "DeadlineExceeded from repro_torch.serving")

__all__ = ["PropagateEngine", "QueueFull", "DeadlineExceeded",
           "PropagateRequest"]
