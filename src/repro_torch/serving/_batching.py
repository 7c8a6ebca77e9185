"""``repro_torch/serving/_batching.py`` ↔ ``repro/serving/_batching.py``.

Canonical request/coalescing vocabulary shared by the whole serving tier.

Before this module existed, the width-bucket / group-key logic lived twice —
once in ``serving/propagate.py`` (static request lists) and once inline in
``serving/engine.py::_dispatch`` (the live scheduler) — and request
validation was scattered across ``submit`` call sites.  Everything that
decides *which requests may share a device dispatch* now lives here, once:

* :class:`PropagateRequest` — the one request type every serving entry point
  accepts, including the multi-tenant ``tenant`` routing tag, with
  :meth:`PropagateRequest.validate` pinning every bad-input error at submit
  time (bad alpha, unknown backend, non-positive deadline, shape problems)
  instead of letting it surface deep inside a batched dispatch;
* width buckets (:func:`bucket_width`, :data:`DEFAULT_WIDTH_BUCKETS`) and
  padding/stacking helpers — a bounded set of dispatch shapes whatever widths
  users send;
* alpha canonicalization (:func:`canonical_alpha`) and the two group keys:
  :func:`group_key` (static batching: alpha joins the key because
  ``propagate_many`` dispatches one scalar alpha per group) and
  :func:`dispatch_group_key` (the engine: alpha rides as a per-request
  array, so only ``(n_iters, backend)`` — plus the width bucket when width
  coalescing is off — fragments a group);
* :func:`batch_bucket` — power-of-two batch-axis padding.

Tenant routing deliberately does NOT appear in any group key: the fleet
(``serving/fleet.py``) routes by tenant *above* the per-tenant engines, so
within a tenant the coalescing rules here apply unchanged — tenancy never
fragments an otherwise-coalescible batch.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence

import numpy as np
import torch

__all__ = [
    "ALPHA_SIG_DIGITS",
    "DEFAULT_WIDTH_BUCKETS",
    "PropagateRequest",
    "batch_bucket",
    "bucket_width",
    "canonical_alpha",
    "dispatch_group_key",
    "group_key",
    "pad_to_width",
    "stack_group",
]

# powers of two keep the folded channel axis (batch * Cb) lane-friendly
DEFAULT_WIDTH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)

# alphas agreeing to this many significant digits share a dispatch group:
# float32 LP cannot distinguish finer alpha differences anyway, and a raw
# float(alpha) key would let 0.01 vs 0.010000001 fragment the batch.
ALPHA_SIG_DIGITS = 6


@dataclasses.dataclass(frozen=True)
class PropagateRequest:
    """One LP query: seed labels (N, C), its recipe, and its QoS tags.

    ``alpha`` / ``n_iters`` are the propagation recipe (paper eq. 15).  The
    remaining fields are scheduler-v2 QoS tags, all optional:

    * ``priority`` — larger = more urgent; consumed by the engine's
      ``"priority"`` queue discipline (ignored by ``"fifo"``/``"edf"``).
    * ``deadline_ms`` — relative deadline from submit; under the ``"edf"``
      discipline requests are served earliest-deadline-first and fast-fail
      with :class:`~repro_torch.serving._queue.DeadlineExceeded` once expired.
      Other disciplines still count late completions in the metrics.
    * ``backend`` — per-request transition-matrix routing: ``None`` (the
      serving default), ``"vdt"``, ``"exact"`` (e.g. validation-tagged
      traffic pinned to the ground-truth eq.-3 walk), ``"grf"`` (the
      Monte-Carlo walker estimator), or ``"auto"``; see
      :func:`repro_torch.core.label_prop.route_backend`.
    * ``rtol`` — the request's relative accuracy target, in ``(0, 1]``.
      Consumed two ways: ``backend="auto"`` routing (a loose rtol on a
      sparse graph permits grf), and — on a grf dispatch without an
      explicit ``n_walkers`` — the walker budget is sized from it via
      :func:`repro_torch.core.grf.walkers_for_rtol` (CLT: ``m ~= 1/rtol^2``).
      Advisory for the deterministic backends.
    * ``n_walkers`` — explicit grf walker budget (overrides ``rtol``
      sizing and the engine default).  Deliberately NOT part of the
      dispatch group key: a grf group dispatches at the MAX budget over
      its members — more walkers strictly reduces every member's variance,
      exactly like width coalescing padding to the largest bucket — so
      heterogeneous budgets never fragment a batch.
    * ``tenant`` — multi-tenant routing tag, consumed by
      :class:`~repro_torch.serving.fleet.EngineFleet`: which registered tenant
      (fitted tree + engine + fair-queueing weight) serves this request.
      ``None`` means "the only tenant" on a single-tenant fleet and is
      ignored by a bare :class:`~repro_torch.serving.engine_api.Engine`.
    """
    y0: Any  # (N, C) numpy array or torch tensor
    alpha: float = 0.01
    n_iters: int = 500
    priority: int = 0
    deadline_ms: Optional[float] = None
    backend: Optional[str] = None
    tenant: Optional[str] = None
    rtol: Optional[float] = None
    n_walkers: Optional[int] = None

    def validate(self, *, n: int, buckets: Sequence[int],
                 default_backend: str = "vdt") -> "PropagateRequest":
        """Normalize this request for serving, or raise a pinned ValueError.

        Every way a request can be malformed surfaces HERE, at submit time,
        with a typed, stable error — never as a shape/trace failure deep
        inside a batched dispatch that would poison a whole group:

        * ``y0`` must be ``(N, C)`` with ``C`` inside a configured width
          bucket (the returned request holds a private ``float32`` copy, so
          the caller may reuse its buffer after submit);
        * ``alpha`` must be finite and in ``[0, 1]`` — eq. 15 is a convex
          combination of the walk and the seed, anything outside diverges;
        * ``n_iters`` must be a positive integer;
        * ``backend`` must resolve via
          :func:`repro_torch.core.label_prop.route_backend` (unknown tags
          raise).  ``rtol`` feeds the ``"auto"`` rule, but an engine
          serves the *complete* fitted kernel graph (density ~1), so auto
          traffic resolves to exact/vdt — grf serving is an explicit
          per-request or engine-default tag;
        * ``rtol``, when given, must be finite and in ``(0, 1]``;
        * ``n_walkers``, when given, must be a positive integer;
        * ``deadline_ms``, when given, must be ``> 0``.

        Returns a new :class:`PropagateRequest` with the backend resolved
        to a concrete scan implementation and every field normalized to its
        canonical python type.  ``tenant`` passes through untouched — the
        fleet validates it against the registry at routing time.
        """
        from repro_torch.core.label_prop import route_backend

        y0 = self.y0
        if isinstance(y0, torch.Tensor):
            y0 = y0.detach().cpu()
        y0 = np.array(y0, np.float32)  # private copy, see docstring
        if y0.ndim != 2 or y0.shape[0] != n:
            raise ValueError(f"y0 must be (N={n}, C), got {y0.shape}")
        bucket_width(y0.shape[1], buckets)  # width must fit a bucket
        alpha = float(self.alpha)
        if not math.isfinite(alpha) or not 0.0 <= alpha <= 1.0:
            raise ValueError(
                f"alpha must be finite and in [0, 1] (eq. 15 is a convex "
                f"combination), got {alpha}")
        n_iters = int(self.n_iters)
        if n_iters < 1:
            raise ValueError(f"n_iters must be >= 1, got {n_iters}")
        rtol = self.rtol
        if rtol is not None:
            rtol = float(rtol)
            if not (math.isfinite(rtol) and 0.0 < rtol <= 1.0):
                raise ValueError(
                    f"rtol must be finite and in (0, 1], got {rtol}")
        n_walkers = self.n_walkers
        if n_walkers is not None:
            n_walkers = int(n_walkers)
            if n_walkers < 1:
                raise ValueError(f"n_walkers must be >= 1, got {n_walkers}")
        backend = route_backend(self.backend, default_backend, n=n,
                                rtol=rtol)
        deadline_ms = self.deadline_ms
        if deadline_ms is not None:
            deadline_ms = float(deadline_ms)
            if not deadline_ms > 0:
                raise ValueError(f"deadline_ms must be > 0, got {deadline_ms}")
        return PropagateRequest(
            y0=y0, alpha=alpha, n_iters=n_iters, priority=int(self.priority),
            deadline_ms=deadline_ms, backend=backend, tenant=self.tenant,
            rtol=rtol, n_walkers=n_walkers)


def bucket_width(c: int, buckets: Sequence[int]) -> int:
    """Smallest configured bucket ``>= c`` (the padded channel width)."""
    for b in buckets:
        if c <= b:
            return b
    raise ValueError(
        f"label width {c} exceeds the largest bucket {max(buckets)}; "
        f"extend `buckets` to serve wider label matrices")


def batch_bucket(n: int, cap: int) -> int:
    """Next power of two ``>= n``, capped at the configured max batch."""
    b = 1
    while b < n:
        b <<= 1
    return min(b, cap)


def canonical_alpha(alpha: float) -> float:
    """Round ``alpha`` to :data:`ALPHA_SIG_DIGITS` significant digits.

    The canonical value is used both as the group key AND as the alpha
    actually dispatched, so two requests that group together produce
    bit-identical recipes.
    """
    return float(f"{float(alpha):.{ALPHA_SIG_DIGITS}g}")


def group_key(alpha: float, n_iters: int, c: int,
              buckets: Sequence[int],
              backend: str = "vdt") -> tuple[float, int, int, str]:
    """Static-batching group key ``(canonical alpha, n_iters, width bucket,
    backend)`` — the :func:`~repro_torch.serving._propagate.propagate_many` policy.

    ``backend`` must already be resolved (``"vdt"`` / ``"exact"``, see
    :func:`repro_torch.core.label_prop.route_backend`): only requests running
    against the same transition matrix can share a dispatch, and resolving
    BEFORE keying means ``None``/``"auto"`` tags that route to the same
    concrete backend never fragment an otherwise-coalescible batch.
    """
    return (canonical_alpha(alpha), int(n_iters), bucket_width(c, buckets),
            backend)


def dispatch_group_key(request: PropagateRequest, buckets: Sequence[int],
                       *, coalesce_widths: bool = True) -> tuple[int, str, int]:
    """Live-scheduler group key ``(n_iters, backend, width bucket or 0)``.

    The engine's coalescing policy: alpha NEVER joins the key (each
    request's alpha rides its dispatch as one element of an alpha array),
    and with ``coalesce_widths=True`` (the default) neither does the width
    bucket — the whole group zero-pads to its largest bucket, because one
    batched dispatch has a large fixed cost and a small per-column
    marginal cost.  ``request.backend`` must already be resolved (see
    :meth:`PropagateRequest.validate`).
    """
    cb = bucket_width(request.y0.shape[1], buckets)
    return (int(request.n_iters), request.backend or "vdt",
            0 if coalesce_widths else cb)


def pad_to_width(y0: torch.Tensor, cb: int) -> torch.Tensor:
    """Zero-pad ``(N, C)`` seed labels to ``(N, cb)`` on the channel axis."""
    c = y0.shape[-1]
    if c == cb:
        return y0
    return torch.nn.functional.pad(y0, (0, cb - c))


def stack_group(y0s: Sequence[torch.Tensor], cb: int) -> torch.Tensor:
    """Stack same-bucket seed matrices into one ``(B, N, cb)`` batch."""
    return torch.stack([pad_to_width(y0, cb) for y0 in y0s])
