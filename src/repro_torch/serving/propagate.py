"""``repro_torch/serving/propagate.py`` ↔ ``repro/serving/propagate.py``.

Deprecated shim: import from :mod:`repro_torch.serving` instead.

The static-batching implementation moved to the private
``repro_torch.serving._propagate`` module (and the shared coalescing vocabulary
to ``repro_torch.serving._batching``); this module re-exports the historical
names so existing imports keep working, with a once-per-process
:class:`DeprecationWarning` at import time.
"""
from repro_torch.serving._batching import (ALPHA_SIG_DIGITS,
                                           DEFAULT_WIDTH_BUCKETS,
                                           PropagateRequest, bucket_width,
                                           canonical_alpha, group_key,
                                           pad_to_width, stack_group)
from repro_torch.serving._deprecation import warn_once
from repro_torch.serving._propagate import propagate_many

warn_once(
    "repro_torch.serving.propagate",
    "import PropagateRequest and propagate_many from repro_torch.serving "
    "(coalescing helpers live in repro_torch.serving._batching)")

__all__ = [
    "ALPHA_SIG_DIGITS",
    "DEFAULT_WIDTH_BUCKETS",
    "PropagateRequest",
    "bucket_width",
    "canonical_alpha",
    "group_key",
    "pad_to_width",
    "propagate_many",
    "stack_group",
]
