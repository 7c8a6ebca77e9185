"""``repro_torch/serving/metrics.py`` ↔ ``repro/serving/metrics.py``.

Deprecated shim: import from :mod:`repro_torch.serving` instead.

The metrics implementation moved to the private ``repro_torch.serving._metrics``
module; this module re-exports the historical names so existing imports
keep working, with a once-per-process :class:`DeprecationWarning` at
import time.  The public snapshot type (``MetricsSnapshot``) is re-exported from
:mod:`repro_torch.serving`; the mutable sink (``EngineMetrics``) is
engine-internal.
"""
from repro_torch.serving._deprecation import warn_once
from repro_torch.serving._metrics import (LATENCY_WINDOW, EngineMetrics,
                                          MetricsSnapshot)

warn_once(
    "repro_torch.serving.metrics",
    "import MetricsSnapshot from repro_torch.serving (the mutable sink lives in "
    "repro_torch.serving._metrics)")

__all__ = ["EngineMetrics", "LATENCY_WINDOW", "MetricsSnapshot"]
