"""``repro_torch/serving/_propagate.py`` ↔ ``repro/serving/_propagate.py``.

Multi-request Label-Propagation serving over one fitted VDT.

One fitted :class:`~repro_torch.core.vdt.VariationalDualTree` can answer many
concurrent propagation queries (different seed labels, different label
widths, different alphas) — the ROADMAP's many-users story.  This module
turns a heterogeneous request list into as few batched device dispatches as
possible:

  1. requests are grouped by ``(alpha, n_iters, width bucket)`` — only
     same-recipe requests can share a batched walk.  The alpha component of
     the key is *canonicalized* (rounded to
     :data:`~repro_torch.serving._batching.ALPHA_SIG_DIGITS` significant digits)
     so near-equal alphas coming from different clients (0.01 vs
     0.010000001) land in the same group instead of fragmenting into
     separate dispatches;
  2. within a group, each ``(N, C_r)`` label matrix is zero-padded on the
     channel axis to the bucket width ``Cb`` (the next configured bucket
     ``>= C_r``) so heterogeneous widths stack into one dispatch shape per
     bucket — LP is column-independent and linear, so zero seed columns stay
     identically zero and never leak into real columns;
  3. the stacked ``(B, N, Cb)`` batch runs through the channel-folded
     batched ``label_propagate`` (one Algorithm-1 dispatch per iteration for
     the WHOLE batch), chunked at ``max_batch`` to bound device memory, on the
     model's device;
  4. answers are sliced back to each request's true width and returned in
     request order.

The request type and the whole bucketing/grouping vocabulary live in the
canonical :mod:`repro_torch.serving._batching` module, shared with the
continuous-batching :class:`~repro_torch.serving.PropagateEngine` (which applies
the same policy to a live queue instead of a static request list) — this
module re-exports them for its historical import surface.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.serving._batching import (ALPHA_SIG_DIGITS,
                                           DEFAULT_WIDTH_BUCKETS,
                                           PropagateRequest, bucket_width,
                                           canonical_alpha, group_key,
                                           pad_to_width, stack_group)

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


def propagate_many(
    vdt,
    requests: Sequence[PropagateRequest],
    *,
    buckets: Sequence[int] = DEFAULT_WIDTH_BUCKETS,
    max_batch: int = 64,
) -> list[torch.Tensor]:
    """Serve many LP requests against ``vdt``; results in request order.

    Each returned tensor lies on the model's device and has the exact
    ``(N, C_r)`` shape of its request's seed matrix.  Requests sharing
    ``(canonical alpha, n_iters)`` and a width bucket are answered by a
    single batched ``label_propagate`` dispatch (chunked at
    ``max_batch``).  Malformed requests raise the
    pinned :meth:`PropagateRequest.validate
    <repro_torch.serving._batching.PropagateRequest.validate>` errors up front —
    before ANY dispatch runs — tagged with the offending request index.
    """
    buckets = tuple(sorted(set(int(b) for b in buckets)))
    n = vdt.tree.n_points
    results: list[Optional[torch.Tensor]] = [None] * len(requests)

    groups: dict[tuple, list[tuple[int, torch.Tensor, int]]] = {}
    for idx, req in enumerate(requests):
        try:
            req = req.validate(n=n, buckets=buckets, default_backend="vdt")
        except ValueError as exc:
            raise ValueError(f"request {idx}: {exc}") from None
        y0 = torch.as_tensor(req.y0, device=vdt.device)
        c = int(y0.shape[1])
        key = group_key(req.alpha, req.n_iters, c, buckets, req.backend)
        groups.setdefault(key, []).append((idx, y0, c))

    for (alpha, n_iters, cb, backend), items in groups.items():
        for lo in range(0, len(items), max_batch):
            chunk = items[lo:lo + max_batch]
            stack = stack_group([y0 for _, y0, _ in chunk], cb)
            out = vdt.label_propagate(stack, alpha=alpha, n_iters=n_iters,
                                      batched=True, backend=backend)
            for k, (idx, _, c) in enumerate(chunk):
                results[idx] = out[k, :, :c]
    return results  # type: ignore[return-value]
