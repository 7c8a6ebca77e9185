"""``repro_torch/serving/queue.py`` ↔ ``repro/serving/queue.py``.

Deprecated shim: import from :mod:`repro_torch.serving` instead.

The queue implementation moved to the private ``repro_torch.serving._queue``
module; this module re-exports the historical names so existing imports
keep working, with a once-per-process :class:`DeprecationWarning` at
import time.  The public exceptions (``QueueFull``, ``DeadlineExceeded``) are re-exported
from :mod:`repro_torch.serving`; the queue machinery itself (``RequestQueue``,
``QueueEntry``, ``DISCIPLINES``) is engine-internal.
"""
from repro_torch.serving._deprecation import warn_once
from repro_torch.serving._queue import (DEFAULT_AGING_S, DISCIPLINES,
                                        DeadlineExceeded, QueueEntry,
                                        QueueFull, RequestQueue)

warn_once(
    "repro_torch.serving.queue",
    "import QueueFull and DeadlineExceeded from repro_torch.serving (queue "
    "internals live in repro_torch.serving._queue)")

__all__ = ["DEFAULT_AGING_S", "DISCIPLINES", "DeadlineExceeded", "QueueEntry",
           "QueueFull", "RequestQueue"]
