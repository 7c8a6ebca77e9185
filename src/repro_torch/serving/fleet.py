"""``repro_torch/serving/fleet.py`` ↔ ``repro/serving/fleet.py``.

Multi-tenant engine fleet: one process, many fitted trees, fair shares.

The paper's premise is that one fitted variational dual tree amortizes
across arbitrarily many random-walk queries; a production process takes the
next step and serves *many* fitted trees — one per dataset/graph/customer —
from a single scheduler.  :class:`EngineFleet` is that front-end:

* **Registration** (``register``): ``tenant name -> fitted tree -> engine``.
  Each tenant gets its own :class:`~repro_torch.serving.PropagateEngine`
  (``start=False`` — the fleet owns the only scheduler) over its tree plus
  a fair-queueing ``weight``.  Several tenants may share one fitted tree
  (same graph, different traffic classes): ``fit_params`` is immutable, so
  sharing is free.
* **Routing** (``submit``): each request routes by its
  ``PropagateRequest.tenant`` tag to that tenant's engine — *above* the
  engines, so within a tenant the scheduler-v2 dispatch group key
  ``(n_iters, backend)`` applies unchanged and tenancy never fragments an
  otherwise-coalescible batch.  Per-tenant bounded queues mean one
  tenant's backpressure (``QueueFull``) never steals another tenant's
  capacity, and per-tenant futures/queues make cross-tenant interference
  structurally impossible: nothing the fleet does to tenant A's entries
  (cancel, expire, fail) can ever resolve a future belonging to tenant B.
* **Fair queueing** (``step_round`` / the background thread): weighted
  **deficit round robin** across the per-tenant queues.  Every round, each
  backlogged tenant's deficit grows by ``quantum * weight`` and the tenant
  dispatches microbatches (plain ``engine.step()`` calls) while its
  deficit covers their cost (one unit per request served):

      deficit_t += quantum * weight_t          # each round, if backlogged
      while deficit_t >= 1 and backlog_t:      # serve, paying per request
          deficit_t -= engine_t.step()

  A microbatch larger than the remaining deficit still dispatches whole
  (batching is the whole point) and drives the deficit negative — debt the
  tenant repays over later rounds, so *long-run* throughput shares converge
  to the weights even though individual dispatches are coarse.  Like the
  ``"priority"`` discipline's aging, the policy is **starvation-bounded**:
  a backlogged tenant's deficit grows every round regardless of the other
  tenants, so it dispatches at least once every
  ``ceil(max_batch / (quantum * weight))`` rounds — no weight is small
  enough to be starved outright.  An emptied tenant's deficit resets to
  zero (classic DRR), so idle time banks no credit.

Single-tenant parity: a fleet with one registered tenant adds routing and
a trivial DRR loop around exactly the same engine code path — dispatch
composition, padding, kernels, and results are bit-identical to driving a
bare ``PropagateEngine`` (pinned by ``tests/test_torch_fleet.py``).
"""
from __future__ import annotations

import copy
import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Callable, Mapping, Optional

from repro_torch.serving._batching import PropagateRequest
from repro_torch.serving._engine import PropagateEngine
from repro_torch.serving._metrics import MetricsSnapshot

__all__ = ["EngineFleet", "FleetMetricsSnapshot"]


@dataclasses.dataclass
class _Tenant:
    """One registered tenant: its engine, weight, and DRR accounting."""

    name: str
    engine: PropagateEngine
    weight: float
    deficit: float = 0.0  # DRR credit (may go negative: microbatch debt)
    served: int = 0  # lifetime requests resolved by fleet-driven dispatches


@dataclasses.dataclass(frozen=True)
class FleetMetricsSnapshot:
    """Point-in-time view of fleet health, tenant-keyed and deep-copied.

    Every mapping on this snapshot is freshly built (deep-copied) at
    snapshot time: mutating a snapshot can never corrupt the live
    scheduler's accounting, and two snapshots never alias each other —
    the namespacing contract ``tests/test_torch_fleet.py`` pins.

    ``fair_share_err`` is the worst relative deviation of any tenant's
    measured lifetime throughput share from its weight share,
    ``max_t |served_t / total - weight_t / sum(weights)| / (weight_t /
    sum(weights))`` — 0.0 is perfect weighted fairness; NaN until at least
    two tenants have been served.  Lifetime counters only converge to the
    weights under sustained all-tenants-backlogged load; windowed
    measurements (e.g. the ``multi-tenant`` benchmark scenario) should
    difference two snapshots instead.
    """

    tenants: Mapping[str, MetricsSnapshot]  # per-tenant engine snapshots
    weights: Mapping[str, float]  # configured fair-queueing weights
    served: Mapping[str, int]  # per-tenant requests resolved by the fleet
    rounds: int  # DRR rounds executed
    fair_share_err: float  # worst relative share deviation (see above)


def _fair_share_err(served: Mapping[str, int],
                    weights: Mapping[str, float]) -> float:
    total = sum(served.values())
    active = {t: w for t, w in weights.items() if w > 0}
    if total == 0 or len(active) < 2:
        return float("nan")
    wsum = sum(active.values())
    worst = 0.0
    for t, w in active.items():
        expected = w / wsum
        measured = served.get(t, 0) / total
        worst = max(worst, abs(measured - expected) / expected)
    return worst


class EngineFleet:
    """Multi-tenant serving front-end over per-tenant engines (see module
    docstring for the routing and fair-queueing semantics).

    Parameters
    ----------
    quantum:  DRR credit added per round per unit weight (requests).  The
              default of 8 lets a weight-1 tenant clear a typical
              microbatch every round or two while keeping per-round work
              bounded; fairness converges to the weights for any positive
              value, the quantum only sets how coarsely.
    clock:    monotonic time source handed to every registered engine (so
              one fake clock drives the whole fleet deterministically
              under test).
    start:    spawn the fleet scheduler thread.  ``start=False`` leaves
              scheduling to explicit ``step_round``/``flush`` calls — the
              deterministic mode the unit tests and golden parity checks
              drive.
    """

    def __init__(self, *, quantum: float = 8.0,
                 clock: Callable[[], float] = time.perf_counter,
                 start: bool = True):
        if quantum <= 0:
            raise ValueError(f"quantum must be > 0, got {quantum}")
        self.quantum = float(quantum)
        self._clock = clock
        self._tenants: dict[str, _Tenant] = {}
        self._rounds = 0
        self._lock = threading.Lock()
        self._work = threading.Event()  # set on submit: wake the scheduler
        self._stop = threading.Event()
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        if start:
            self._thread = threading.Thread(
                target=self._loop, name="engine-fleet", daemon=True)
            self._thread.start()

    # ---------------------------------------------------------- registration
    def register(self, tenant: str, vdt, *, weight: float = 1.0,
                 engine_cls: type = PropagateEngine,
                 **engine_kwargs) -> PropagateEngine:
        """Register ``tenant`` served by a new engine over ``vdt``.

        ``weight`` is the tenant's fair share (relative to the other
        tenants' weights).  ``engine_cls`` picks the engine implementation
        (default :class:`~repro_torch.serving.PropagateEngine`; routing,
        fair queueing, and the dispatch group key are engine-agnostic, so
        any :class:`~repro_torch.serving.Engine` slots in unchanged).
        ``engine_kwargs`` pass through to the engine constructor
        (``max_batch``, ``policy``, ``segment_iters``, ...) except
        ``start``/``clock``, which the fleet pins: the fleet owns the ONLY
        scheduler, so tenant engines never spawn their own threads, and
        all timing runs on the fleet clock.  Returns the tenant's engine
        (mainly so callers can ``warmup`` it).
        """
        if weight <= 0:
            raise ValueError(
                f"tenant weight must be > 0, got {weight} for {tenant!r}")
        for pinned in ("start", "clock"):
            if pinned in engine_kwargs:
                raise ValueError(
                    f"{pinned!r} is fleet-managed and cannot be passed "
                    f"per tenant")
        with self._lock:
            if self._closed:
                raise RuntimeError("fleet is shut down")
            if tenant in self._tenants:
                raise ValueError(f"tenant {tenant!r} already registered")
        # engine construction builds nothing but does touch the fitted
        # tree; keep it outside the lock so a slow register never blocks
        # the scheduler's tenant-list snapshot
        engine = engine_cls(vdt, start=False, clock=self._clock,
                            **engine_kwargs)
        with self._lock:
            if self._closed:  # lost a race with shutdown()
                engine.shutdown(wait=False)
                raise RuntimeError("fleet is shut down")
            if tenant in self._tenants:
                engine.shutdown(wait=False)
                raise ValueError(f"tenant {tenant!r} already registered")
            self._tenants[tenant] = _Tenant(
                name=tenant, engine=engine, weight=float(weight))
        return engine

    def tenants(self) -> tuple[str, ...]:
        """Registered tenant names, in registration (round-robin) order."""
        with self._lock:
            return tuple(self._tenants)

    # -------------------------------------------------------------- routing
    def submit(self, request: PropagateRequest, *, block: bool = True,
               timeout: Optional[float] = None) -> Future:
        """Route ``request`` to its tenant's engine; returns that future.

        ``request.tenant`` must name a registered tenant; ``None`` routes
        to the only tenant of a single-tenant fleet (and raises on a
        multi-tenant one — ambiguous routing is an error, not a guess).
        Validation, backpressure (``block``/``timeout``/``QueueFull``) and
        cancellation semantics are exactly the tenant engine's own
        ``submit`` contract.
        """
        with self._lock:
            if self._closed:
                raise RuntimeError("fleet is shut down")
            name = request.tenant
            if name is None:
                if len(self._tenants) != 1:
                    raise ValueError(
                        f"request.tenant is required on a fleet with "
                        f"{len(self._tenants)} tenants "
                        f"(registered: {sorted(self._tenants)})")
                name = next(iter(self._tenants))
            tenant = self._tenants.get(name)
            if tenant is None:
                raise ValueError(
                    f"unknown tenant {name!r} "
                    f"(registered: {sorted(self._tenants)})")
        fut = tenant.engine.submit(request, block=block, timeout=timeout)
        self._work.set()
        return fut

    def publish(self, tenant: Optional[str], model, *,
                patched_points: int = 0, stale_blocks: int = 0) -> int:
        """Publish a streaming-updated model to ONE tenant's engine.

        Routes to ``tenant``'s engine and returns its new epoch number
        (``None`` routes to the only tenant of a single-tenant fleet,
        mirroring :meth:`submit`).  Tenant isolation carries over to
        epochs: a publish swaps exactly one tenant's serving model —
        every other tenant's engine keeps its epoch, its pinned tree, and
        its bit-exact outputs (pinned by ``tests/test_torch_fleet.py``).  The
        per-engine atomicity contract is
        :meth:`PropagateEngine.publish
        <repro_torch.serving.PropagateEngine.publish>`'s own.
        """
        with self._lock:
            if self._closed:
                raise RuntimeError("fleet is shut down")
            if tenant is None:
                if len(self._tenants) != 1:
                    raise ValueError(
                        f"tenant is required on a fleet with "
                        f"{len(self._tenants)} tenants "
                        f"(registered: {sorted(self._tenants)})")
                tenant = next(iter(self._tenants))
            t = self._tenants.get(tenant)
            if t is None:
                raise ValueError(
                    f"unknown tenant {tenant!r} "
                    f"(registered: {sorted(self._tenants)})")
        if "publish" not in t.engine.capabilities():
            raise ValueError(
                f"tenant {tenant!r} engine "
                f"({type(t.engine).__name__}) does not advertise the "
                f"'publish' capability (capabilities: "
                f"{sorted(t.engine.capabilities())})")
        return t.engine.publish(model, patched_points=patched_points,
                                stale_blocks=stale_blocks)

    # ----------------------------------------------------------- scheduling
    def step_round(self) -> int:
        """One deficit-round-robin pass over the tenants; futures resolved.

        Visits tenants in registration order: a backlogged tenant earns
        ``quantum * weight`` credit and dispatches microbatches while the
        credit lasts (cost: one unit per future its dispatch resolves —
        completions, failures, and expired fast-fails all consume queue
        service, so all are charged); an idle tenant's credit resets.
        This is the whole fleet scheduler — the background thread calls
        the same code — so tests drive it deterministically.
        """
        with self._lock:
            tenants = list(self._tenants.values())
            self._rounds += 1
        resolved = 0
        for t in tenants:
            if len(t.engine._queue) == 0:
                t.deficit = 0.0  # classic DRR: idle tenants bank no credit
                continue
            t.deficit += self.quantum * t.weight
            while t.deficit >= 1.0 and len(t.engine._queue) > 0:
                served = t.engine.step()
                if served == 0:
                    break  # backlog was all cancelled entries
                t.deficit -= served
                with self._lock:
                    t.served += served
                resolved += served
        return resolved

    def flush(self) -> int:
        """DRR rounds until every tenant queue drains; futures resolved.

        Unlike a single engine's snapshot-bounded ``flush``, the fleet
        flush is a teardown/test helper: it assumes producers have stopped
        (``shutdown(wait=True)`` has already closed intake) and simply
        runs rounds to empty.
        """
        total = 0
        while True:
            with self._lock:
                backlog = sum(len(t.engine._queue)
                              for t in self._tenants.values())
            if backlog == 0:
                return total
            served = self.step_round()
            if served == 0 and self.step_round() == 0:
                # nothing serveable left (e.g. an all-cancelled backlog)
                return total
            total += served

    def _loop(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                backlog = sum(len(t.engine._queue)
                              for t in self._tenants.values())
            if backlog == 0:
                # sleep until a submit wakes us (or the periodic re-check)
                self._work.wait(timeout=0.05)
                self._work.clear()
                continue
            try:
                self.step_round()
            except Exception:
                # per-request faults resolve futures inside engine.step;
                # anything reaching here is fleet-internal.  Never let the
                # only scheduler die silently: the engines already count
                # scheduler_errors for their own faults, so just back off
                # a beat and keep serving.
                import logging

                logging.getLogger(__name__).exception(
                    "fleet scheduler round failed; backing off")
                self._stop.wait(0.05)

    # -------------------------------------------------------- observability
    def metrics(self) -> FleetMetricsSnapshot:
        """Deep-copied, tenant-keyed snapshot of the whole fleet.

        Per-tenant sections are the engines' own immutable
        :class:`~repro_torch.serving.MetricsSnapshot` objects plus the fleet's
        weight/served accounting — all copied at snapshot time, sharing no
        mutable structure with the live scheduler (see
        :class:`FleetMetricsSnapshot`).
        """
        with self._lock:
            tenants = dict(self._tenants)
            rounds = self._rounds
            served = {name: t.served for name, t in tenants.items()}
            weights = {name: t.weight for name, t in tenants.items()}
        return FleetMetricsSnapshot(
            tenants={name: t.engine.metrics() for name, t in tenants.items()},
            weights=copy.deepcopy(weights),
            served=copy.deepcopy(served),
            rounds=rounds,
            fair_share_err=_fair_share_err(served, weights),
        )

    # ----------------------------------------------------------- lifecycle
    def shutdown(self, wait: bool = True) -> None:
        """Stop intake fleet-wide; serve (``wait=True``) or cancel backlogs.

        Idempotent.  The fleet thread (if any) is joined first, so after
        return no dispatch is in flight anywhere; then every tenant engine
        shuts down with the same ``wait`` semantics it would honor alone
        (``wait=False`` still resolves already-expired EDF entries with the
        pinned ``DeadlineExceeded``).
        """
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._stop.set()
        self._work.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if wait:
            self.flush()
        with self._lock:
            tenants = list(self._tenants.values())
        for t in tenants:
            t.engine.shutdown(wait=wait)

    def __enter__(self) -> "EngineFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown(wait=exc == (None, None, None))
