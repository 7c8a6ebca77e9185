"""``repro_torch/serving/engine_api.py`` ↔ ``repro/serving/engine_api.py``.

The abstract serving-engine contract every LP engine implements.

This is the repo's counterpart of JetStream's ``engine_api.py``: a formal
API boundary between *what a serving engine promises* (this module) and
*how one particular engine delivers it* (``serving/_engine.py``'s
:class:`~repro_torch.serving.PropagateEngine`, the continuous-batching engine
over one fitted variational dual tree).  Everything above the engine — the
multi-tenant :class:`~repro_torch.serving.fleet.EngineFleet`, benchmarks,
examples — programs against :class:`Engine`, so a sharded multi-device
engine or a shared-memory multi-process engine can slot in underneath
without touching the routing/fair-queueing layer.

Params / state separation
-------------------------
An engine's data splits into two halves with very different lifecycles,
and the API keeps them formally apart:

* :attr:`Engine.fit_params` (:class:`FitParams`) — the **immutable fitted
  half**: the variational dual tree, its q distribution, dispatch buffers.
  Fitting is the expensive offline step (the paper's premise is that ONE
  fitted tree amortizes across millions of random-walk queries), and
  nothing on the serving path ever writes to it — which is exactly what
  makes it shareable: across engines in one process today, across worker
  processes via shared memory, and across the shards of a
  :class:`~repro_torch.serving.ShardedPropagateEngine`.
* :attr:`Engine.dispatch_state` (:class:`DispatchState`) — the **mutable
  serving half**: the bounded request queue, pooled host staging buffers,
  and the metrics sink.  Exactly one scheduler owns it; it is never shared
  and never outlives the engine.

Slot-based results
------------------
:class:`ResultSlab` is the result layout contract (JetStream's
``ResultTokens`` idea): a dispatch resolves the whole group's answers as
**one** device-to-host array plus per-slot index metadata, because copying
a single contiguous array to host is much faster than one transfer per
request.  Each request's future then resolves to a zero-copy view into the
slab, sliced back to its true label width.
"""
from __future__ import annotations

import abc
import dataclasses
from concurrent.futures import Future
from typing import Any, Mapping, Optional, Sequence

import numpy as np

from repro_torch.serving._batching import PropagateRequest
from repro_torch.serving._metrics import MetricsSnapshot

__all__ = ["DispatchState", "Engine", "FitParams", "ResultSlab"]


@dataclasses.dataclass(frozen=True)
class FitParams:
    """The immutable fitted half of an engine (see module docstring).

    ``model`` is the fitted object every dispatch reads (for the VDT
    engine: the :class:`~repro_torch.core.vdt.VariationalDualTree`, whose block
    structure, q distribution, and cached device dispatch buffers are all
    frozen at fit time).  ``n_points`` and ``divergence`` are the two
    pieces of fitted identity the serving layer itself consumes: the
    request-shape contract and the dispatch-key component.

    ``epoch`` is the model version under streaming updates
    (``core/streaming.py``): each :meth:`Engine.publish
    <repro_torch.serving.PropagateEngine.publish>` of an incrementally mutated
    tree replaces the engine's ``fit_params`` with a NEW immutable
    instance at the next epoch number — the params object itself never
    mutates, so anything holding epoch ``e``'s ``FitParams`` keeps
    serving epoch ``e`` bit-identically.
    """

    model: Any
    n_points: int
    divergence: str
    epoch: int = 0


@dataclasses.dataclass
class DispatchState:
    """Live handles to the mutable serving half of an engine.

    These are the engine's working structures, not copies: ``queue`` is
    the bounded request queue, ``staging`` the pooled host staging buffers
    keyed by ``(n_points, batch bucket, width bucket)`` — ``n_points``
    because epochs published by streaming updates may change the point
    count, and a buffer sized for one epoch's ``N`` cannot stage
    another's — and ``metrics`` the mutable event sink behind
    :meth:`Engine.metrics` snapshots.  The contract is ownership, not
    thread-safety: exactly one scheduler drives this state, and sharing it
    between schedulers (unlike :class:`FitParams`, which is freely
    shareable) is a bug.
    """

    queue: Any
    staging: Mapping[tuple[int, int, int], np.ndarray]
    metrics: Any


@dataclasses.dataclass(frozen=True)
class ResultSlab:
    """One dispatch's answers as a single host array + slot metadata.

    ``data`` is the dispatch's full ``(slots, N, width bucket)`` output,
    copied device-to-host **once** for the whole group.  ``widths[k]`` is
    slot ``k``'s true label width (``<=`` the bucket; padding columns and
    padding slots hold zeros).  :meth:`view` hands out per-request answers
    as zero-copy numpy views into that one array.
    """

    data: np.ndarray
    widths: tuple[int, ...]

    @property
    def slots(self) -> int:
        """Number of real (non-padding) request slots in the slab."""
        return len(self.widths)

    def view(self, slot: int) -> np.ndarray:
        """Slot ``slot``'s ``(N, widths[slot])`` answer — a view, not a copy."""
        if not 0 <= slot < len(self.widths):
            raise IndexError(
                f"slot {slot} out of range for a {len(self.widths)}-slot slab")
        return self.data[slot, :, : self.widths[slot]]


class Engine(abc.ABC):
    """Abstract continuous-batching LP serving engine.

    The contract (see the module docstring for the params/state split and
    the slot-based result layout):

    * :meth:`submit` is thread-safe, validates at the call site (pinned
      ``ValueError`` via :meth:`PropagateRequest.validate
      <repro_torch.serving._batching.PropagateRequest.validate>`; ``QueueFull``
      as backpressure), and returns a per-request
      :class:`~concurrent.futures.Future` resolving to the ``(N, C)``
      answer;
    * exactly one scheduler drives dispatches — a background thread, an
      external owner calling :meth:`step`/:meth:`flush` (how the fleet and
      the deterministic tests drive engines), never both;
    * :meth:`warmup` runs every reachable dispatch shape once (kernel
      libraries built, dispatch buffers cached) so production traffic
      never stalls on a first call;
    * :meth:`metrics` returns an immutable snapshot that never aliases
      live mutable state;
    * :meth:`shutdown` is idempotent; engines are context managers
      (``__exit__`` serves the backlog on clean exit, cancels it when
      unwinding an exception).
    """

    # ------------------------------------------------------- data halves
    @property
    @abc.abstractmethod
    def fit_params(self) -> FitParams:
        """The immutable fitted half — shareable, never written at serve time."""

    @property
    @abc.abstractmethod
    def dispatch_state(self) -> DispatchState:
        """The mutable serving half — owned by exactly one scheduler."""

    # --------------------------------------------------------- serving
    @abc.abstractmethod
    def submit(self, request: PropagateRequest, *, block: bool = True,
               timeout: Optional[float] = None) -> Future:
        """Enqueue one validated request; future of its ``(N, C)`` answer."""

    @abc.abstractmethod
    def warmup(self, widths: Optional[Sequence[int]] = None,
               n_iters: Sequence[int] = (500,),
               backends: Optional[Sequence[str]] = None) -> int:
        """Run the reachable dispatch grid once; returns dispatch shapes warmed."""

    @abc.abstractmethod
    def step(self) -> int:
        """One synchronous scheduler iteration; returns futures resolved."""

    @abc.abstractmethod
    def flush(self) -> int:
        """Serve the backlog present at call time; returns futures resolved."""

    # ----------------------------------------------------- introspection
    def capabilities(self) -> frozenset[str]:
        """The optional behaviors this engine instance actually provides.

        Capability introspection is the API's replacement for ``hasattr``
        probing: layers above an engine (the fleet's ``publish`` routing,
        preemption-aware load generators, operators' dashboards) ask the
        engine what it can do instead of guessing from its type or its
        attribute dict.  The vocabulary:

        * ``"publish"`` — epoch-versioned model swaps (:meth:`publish`
          honors the atomic-swap contract instead of raising);
        * ``"preempt"`` — segmented preemptible dispatch: long scans
          yield at segment boundaries to urgent arrivals, with the
          carry extractable bit-identically at every boundary;
        * ``"grf"`` — serves the Monte-Carlo walker backend
          (``backend="grf"`` requests are accepted);
        * ``"sharded"`` — dispatch state and label stacks are partitioned
          across a multi-device mesh (SPMD serving).

        The set reflects this *instance*'s live configuration, not just
        its class: e.g. an engine only reports ``"preempt"`` when its
        policy/segmenting configuration actually preempts.  The base
        implementation promises nothing; concrete engines override.
        """
        return frozenset()

    # -------------------------------------------------------- streaming
    def publish(self, model: Any, *, patched_points: int = 0,
                stale_blocks: int = 0) -> int:
        """Swap in a streaming-updated model as a new epoch; returns it.

        Optional capability (engines without online updates need not
        override).  The contract for engines that do: the swap is atomic
        with respect to :meth:`submit` — every already-queued or in-flight
        entry completes bit-identically against the epoch it was submitted
        under, every submit returning after ``publish`` sees the new
        epoch, and an old epoch's device/staging resources are released
        once its last entry resolves.
        """
        raise NotImplementedError(
            f"{type(self).__name__} does not support epoch publishing")

    # ------------------------------------------------------ observability
    @abc.abstractmethod
    def metrics(self) -> MetricsSnapshot:
        """Immutable point-in-time snapshot of engine health."""

    # --------------------------------------------------------- lifecycle
    @abc.abstractmethod
    def shutdown(self, wait: bool = True) -> None:
        """Stop intake; serve (``wait=True``) or cancel the backlog."""

    def __enter__(self) -> "Engine":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown(wait=exc == (None, None, None))
