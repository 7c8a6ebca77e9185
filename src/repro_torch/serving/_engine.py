"""``repro_torch/serving/_engine.py`` ↔ ``repro/serving/_engine.py``.

Continuous-batching async LP serving engine over one fitted VDT.

:class:`PropagateEngine` is the dynamic counterpart of
:func:`~repro_torch.serving.propagate.propagate_many`: instead of batching a
static request list, it owns a live bounded queue and a scheduler that
coalesces *whatever is waiting* into few batched device dispatches, while
clients block on per-request futures.

Scheduling policy (scheduler v2)
--------------------------------
One scheduler iteration (``step`` when driven manually, the background
thread's loop body otherwise):

1. wait for the queue to go non-empty, then linger for it to fill toward
   ``max_batch`` — the classic throughput/latency batching window.  The
   window is **rate-adaptive**: an EWMA of observed inter-arrival gaps
   estimates how long ``max_batch`` arrivals take, and the linger waits
   ``min(max_wait_ms, ewma_gap * missing_slots)`` (clamped to
   ``[0, max_wait_ms]``; under ``policy="edf"`` additionally capped at the
   earliest queued deadline, so batching can never itself expire the most
   urgent request).  The linger also ends as soon as arrivals quiesce for
   ~1ms, so a lone request never waits the full window.  All timing runs
   on the injectable ``clock``, so tests drive it deterministically;
2. atomically drain up to ``max_batch`` entries **in queue-discipline
   order** (``policy``: FIFO, priority with starvation-bounded aging, or
   earliest-deadline-first — see ``serving/queue.py``), dropping entries
   whose future was cancelled while queued and fast-failing expired EDF
   entries with :class:`DeadlineExceeded` before they cost a dispatch;
3. group the drained entries by ``(n_iters, backend)`` — only requests
   sharing a scan length and a transition matrix can share a dispatch.
   ``backend`` is **per-request** (exact/VDT hybrid routing, resolved at
   submit via :func:`repro_torch.core.label_prop.route_backend`), so validation
   or small-N traffic tagged ``backend="exact"`` rides the same engine as
   bulk VDT traffic without fragmenting either side's batches.  Alpha does
   NOT fragment groups — LP is column-independent, so each request's alpha
   rides the dispatch as one element of a per-request alpha array (see
   ``VariationalDualTree.label_propagate``).  Width does not fragment
   either by default (``coalesce_widths=True``): every request in the
   group is zero-padded to the group's largest width bucket, because one
   batched dispatch has a large fixed cost (tens of per-iteration kernel
   launches on the vdt backend, a whole distance pass per iteration on the
   exact one) and a small per-column marginal cost, so one fat dispatch
   beats several narrow ones.  (On the card K1 walks its distance tiles
   once per 16 folded columns, so past 16 the exact backend's marginal
   cost is no longer small.)  ``coalesce_widths=False`` restores
   per-width-bucket grouping (the ``propagate_many`` policy) for backends
   where compute scales hard with padded width;
4. per group, zero-pad widths to the chosen bucket, pad the batch axis to
   the next power of two (with zero rows at alpha 0), run one batched
   ``label_propagate`` on the group's backend, slice each answer back to
   its true width, and resolve the futures (counting completions that
   landed after their request's deadline as ``deadline_missed``).

Backends
--------
``"vdt"`` (the default) serves the fitted O(|B|) approximation — the
production path.  ``"exact"`` serves the exact eq.-3 matrix through the
distance-reusing fused kernel (``core.label_prop.lp_scan_fused``, K1 on the
card): the coalesced group shares one streaming pass per LP iteration, so
the pairwise-distance/softmax work — the reason exact LP was ever expensive
to batch — is paid once per iteration for the whole group (on the card,
once per 16 folded columns) instead of once per request.  ``"grf"`` serves
the graph-random-features walker estimator (``core/grf.py``, K5 on the
card): an unbiased Monte-Carlo estimate of the same eq.-15 walk whose
per-iteration cost is O(N * n_walkers), with the walker budget as a
per-request accuracy dial (explicit ``n_walkers``, or CLT-sized from
``rtol``) — grf groups dispatch at the max budget over their members and
always monolithically (no resume primitive), deterministically per
``grf_seed`` on a given device.  The engine-level ``backend`` is only the
*default*: each ``PropagateRequest(backend=...)`` may override it
(``"exact"`` for accuracy-validation traffic, ``"auto"`` for
route-by-size), making one engine a multi-backend hybrid.

Preemptible dispatch
--------------------
Without it, EDF only reorders the *queue*: a deadline-100ms request
arriving one segment into a 500-iteration bulk scan still waits out the
whole scan — head-of-line blocking behind in-flight work — and fast-fails
on expiry despite the device having had plenty of boundary opportunities
to serve it.  ``segment_iters=k`` (with ``policy="edf"``) fixes this:
scans longer than ``k`` run as resumable ``k``-iteration segments
(``VariationalDualTree.label_propagate_resume``; bit-identical to the
monolithic scan, since eq. 15 is a pure fixed-point iteration and the
carry plus the seed is the walk's complete state).  Between segments the
scheduler re-checks the queue: if any queued deadline falls before ``now +
est_iter_time * iters_remaining`` (per-iteration EWMA of measured segment
times), the walk yields — urgent entries drain (deadline-ordered prefix of
the EDF heap, everything else stays queued) and dispatch *now*,
non-preemptibly, then the suspended scan resumes from its carry.  Worst-
case added latency for an urgent arrival drops from ``O(n_iters)`` to one
segment: ``preempt_latency <= segment_iters * iter_time + urgent dispatch
cost``.  ``metrics()`` exposes ``preemptions`` (boundary yields) and
``preempt_iters`` (iterations still pending at those yields).

Dispatch-shape bound
--------------------
Dispatches have shapes ``(batch bucket, N, width bucket)`` per backend;
nothing is compiled per shape in torch (the CUDA kernels are built once per
source), but each shape has its own allocations and, on the exact backend,
its own K1 instantiation.  Each engine's ``metrics().dispatch_key`` reports
its default ``backend:divergence`` identity.  Width buckets come from the
shared ``buckets`` tuple and batch buckets are powers of two up to
``max_batch``, so steady-state traffic touches at most ``backends *
len(buckets) * log2(max_batch)`` shapes — whatever widths, alphas, and
arrival orders users produce.

Buffer reuse
------------
The engine keeps one host staging buffer (numpy, pageable) per ``(N,
batch bucket, width bucket)`` and refills it in place each scheduler
iteration; each group's stack is copied from it onto the model's device
synchronously, into a tensor of its own, before any device work reads it —
so an urgent service pass between two segments of a suspended walk may
refill the same buffer.  The fitted tree's dispatch buffers (block
indices, ``exp(log_q)``, leaf mask) are cached device-side on the
``VariationalDualTree`` itself.

Device
------
The engine runs wherever its model is: a model fitted without ``device``
lies on the card and every dispatch runs there; ``device="cpu"`` models
(the tests') dispatch on the CPU.  There is no device argument and no
fallback.  Each dispatch waits for the device before its futures resolve,
so the per-iteration time estimate reads finished device work.  The
background scheduler thread launches CUDA work on its own current stream
(torch's current stream is per thread).

Observability
-------------
Besides the reference's counters, ``metrics()`` reports where the scheduler
thread's time goes, in seconds on the engine's ``clock``: ``linger_s`` (the
batching window), then per dispatched group ``stage_s`` (grouping, filling
the host stack, the copy onto the device), ``walk_s`` (enqueueing the walk
and waiting for the device), ``copy_out_s`` (the result slab to the host)
and ``resolve_s`` (the futures).  Each phase is also a profiler span,
``engine.linger`` or ``engine.<phase>`` inside one ``engine.dispatch`` span
per drained microbatch (keyword values: its number and the entries'
``seq``s), opened on the scheduler thread only.  ``queued_s`` sums each
dispatched request's wait from ``t_submit`` to its dispatch's start,
``blocked_s`` each ``submit``'s wait for room in a full queue, and
``columns_real`` / ``columns_walked`` the true and the padded widths walked.

Concurrency contract
--------------------
``submit`` is thread-safe and may be called from any thread (or wrapped for
asyncio via ``asyncio.wrap_future(engine.submit(req))``).  Exactly one scheduler drives dispatches:
the background thread (``start=True``) or the caller of ``step``/``flush``
(``start=False``, the deterministic mode the unit tests use).
"""
from __future__ import annotations

import dataclasses
import logging
import threading
import time
from concurrent.futures import Future
from typing import Callable, Optional, Sequence

import numpy as np
import torch
# a profiler span whose keyword values reach the trace (``record_function``'s
# ``args`` string does not); about 1 us when no profiler runs
from torch._C._profiler import _RecordFunctionFast as _Span

from repro_torch.core.label_prop import route_backend
from repro_torch.serving._batching import (DEFAULT_WIDTH_BUCKETS,
                                           PropagateRequest, batch_bucket,
                                           bucket_width, dispatch_group_key)
from repro_torch.serving._metrics import EngineMetrics, MetricsSnapshot
from repro_torch.serving._queue import (DISCIPLINES, DeadlineExceeded,
                                        QueueEntry, QueueFull, RequestQueue)
from repro_torch.serving.engine_api import (DispatchState, Engine,
                                            FitParams, ResultSlab)

__all__ = ["PropagateEngine", "QueueFull", "DeadlineExceeded",
           "PropagateRequest"]


_log = logging.getLogger(__name__)


def _sync(device: torch.device) -> None:
    """Wait for ``device``, so that host clocks and results read finished
    work (the reference's ``block_until_ready``)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A copy of host array ``a`` on ``device`` that never aliases ``a``.

    The copy is synchronous (pageable source), so ``a`` may be refilled as
    soon as this returns.
    """
    return torch.from_numpy(a).to(device, copy=True)


@dataclasses.dataclass
class _Epoch:
    """One published model version and its serving refcount.

    ``pending`` counts entries accepted at this epoch that have not yet
    reached a terminal state (result, failure, cancel, expiry).  A
    non-current epoch whose pending count drains to zero is *retired*:
    its record — and with it the pinned model and ``FitParams`` — is
    dropped, and staging buffers sized for a point count no live epoch
    uses are pruned by the scheduler.  The current epoch is never retired.
    """

    eid: int
    vdt: object  # the fitted VariationalDualTree this epoch serves
    n: int  # its point count (the request-shape contract at this epoch)
    divergence: str
    fit_params: FitParams
    pending: int = 0


@dataclasses.dataclass
class _InFlightScan:
    """A segmented group dispatch suspended (or running) mid-walk.

    The resumable in-flight record behind preemptible dispatch: eq. 15 is
    a pure fixed-point iteration, so ``carry`` after ``iters_done`` steps
    plus the seed ``y0`` is the COMPLETE state of the walk — resuming from
    it (``VariationalDualTree.label_propagate_resume``) is bit-identical
    to never having paused.  The engine holds one of these per segmented
    group; between segments it re-checks the queue and, if an urgent
    arrival's deadline would expire before the remaining
    ``n_iters - iters_done`` iterations complete, yields the device to an
    urgent dispatch before resuming.
    """

    entries: list  # the group's QueueEntry list, batch-slot order
    carry: object  # (bb, N, cb) device tensor: the walk state so far
    y0: object  # (bb, N, cb) device tensor: seed labels (eq.-15 restart term)
    alphas: object  # (bb,) per-request alpha (padding rows: 0)
    n_iters: int
    backend: str
    iters_done: int = 0


class PropagateEngine(Engine):
    """Async continuous-batching server for LP requests on one fitted VDT.

    The first concrete implementation of the abstract
    :class:`~repro_torch.serving.engine_api.Engine` contract: ``fit_params`` is
    the fitted ``VariationalDualTree`` (immutable, shareable), and
    ``dispatch_state`` (queue + staging pool + metrics sink) is owned by
    whichever single scheduler drives ``step``/``flush`` — the background
    thread (``start=True``), a test, or an
    :class:`~repro_torch.serving.fleet.EngineFleet` serving this engine as one
    tenant.

    Parameters
    ----------
    vdt:         the fitted ``VariationalDualTree`` all requests run against.
    max_batch:   most requests coalesced into one device dispatch.
    max_wait_ms: cap on how long the scheduler lingers for a fuller batch
                 once the first request of an iteration has arrived; the
                 adaptive policy picks the actual window per iteration
                 (0 disables lingering entirely).
    max_queue:   bounded-queue capacity; ``submit`` beyond it blocks or
                 raises :class:`QueueFull` (backpressure).
    buckets:     label-width buckets, shared with ``propagate_many``.
    coalesce_widths: pad a whole group to its largest width bucket so mixed
                 widths share one dispatch (default; see module docstring).
    backend:     default transition-matrix backend — ``"vdt"`` (fitted
                 approximation), ``"exact"`` (streamed exact P via the
                 distance-reusing fused kernel), ``"grf"`` (the
                 Monte-Carlo walker estimator over the fitted kernel
                 graph) or ``"auto"`` (exact for small N; never grf on an
                 engine, whose complete kernel graph is dense).
                 Individual requests may override it; see *Backends* in
                 the module docstring.
    n_walkers:   default grf walker budget per dispatch.  A grf group
                 dispatches at the max over its members' budgets (an
                 explicit ``PropagateRequest.n_walkers``, else the CLT
                 sizing ``walkers_for_rtol(rtol)`` when the request
                 states an accuracy target, else this default) — walker
                 count never fragments a batch, mirroring width
                 coalescing.  ``metrics().n_walkers`` reports the budget
                 of the most recent grf dispatch.
    grf_seed:    PRNG seed for grf dispatches.  Together with the pinned
                 epoch's model it fully determines the walks, so repeated
                 dispatches of the same group are bit-identical — the
                 same determinism contract the other backends get for
                 free.  grf scans never segment (no resume primitive for
                 a Monte-Carlo series), so they dispatch monolithically
                 even under ``policy="edf"`` + ``segment_iters``.
    policy:      queue discipline — ``"fifo"`` (default, submission order),
                 ``"priority"`` (highest ``PropagateRequest.priority``
                 first with starvation-bounded aging) or ``"edf"``
                 (earliest ``deadline_ms`` first, expired requests
                 fast-fail with :class:`DeadlineExceeded`).
    aging_ms:    the ``"priority"`` discipline's starvation bound: waiting
                 ``aging_ms`` is worth one priority level, so a
                 default-priority request is never overtaken by
                 higher-priority traffic submitted more than
                 ``aging_ms * (priority gap)`` after it.
    adaptive_linger: scale the batching window by the observed arrival
                 rate (EWMA of inter-arrival gaps) instead of always
                 lingering toward ``max_wait_ms``.
    segment_iters: preemptible dispatch — split every LP scan longer than
                 this into ``segment_iters``-sized resumable segments and
                 re-check the queue at each boundary (see *Preemptible
                 dispatch* in the module docstring).  ``None`` (default)
                 dispatches monolithically.  Only effective under
                 ``policy="edf"``: the other disciplines carry no deadline
                 signal, so there is nothing to preempt for.
    clock:       monotonic time source (seconds).  Injectable so the
                 scheduler's timing decisions — linger windows, aging
                 ranks, deadline expiry, latency metrics — are
                 deterministic under test fake clocks instead of
                 wall-clock-flaky on loaded CI runners.
    start:       spawn the background scheduler thread.  ``start=False``
                 leaves scheduling to explicit ``step``/``flush`` calls —
                 deterministic, single-threaded, what the unit tests drive.
    """

    def __init__(
        self,
        vdt,
        *,
        max_batch: int = 32,
        max_wait_ms: float = 2.0,
        max_queue: int = 256,
        buckets: Sequence[int] = DEFAULT_WIDTH_BUCKETS,
        coalesce_widths: bool = True,
        backend: str = "vdt",
        n_walkers: int = 64,
        grf_seed: int = 0,
        policy: str = "fifo",
        aging_ms: float = 500.0,
        adaptive_linger: bool = True,
        segment_iters: Optional[int] = None,
        clock: Callable[[], float] = time.perf_counter,
        start: bool = True,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if policy not in DISCIPLINES:
            raise ValueError(
                f"policy must be one of {DISCIPLINES}, got {policy!r}")
        if segment_iters is not None and segment_iters < 1:
            raise ValueError(
                f"segment_iters must be >= 1 or None, got {segment_iters}")
        if n_walkers < 1:
            raise ValueError(f"n_walkers must be >= 1, got {n_walkers}")
        self.vdt = vdt
        self.n_walkers = int(n_walkers)
        self.grf_seed = int(grf_seed)
        self._last_n_walkers = 0  # gauge: budget of the latest grf dispatch
        self.n = int(vdt.tree.n_points)
        # the engine-level backend is the per-request DEFAULT; "auto"
        # resolves here against the fitted problem size (route_backend also
        # rejects unknown tags at construction, not at first dispatch)
        self.backend = route_backend(backend, "vdt", n=self.n)
        # divergence rides in the dispatch key: engines over different
        # fitted divergences never share a dispatch (the exact backend's
        # kernels are per divergence; the VDT backend's q encodes it as
        # data), and the metrics snapshot exposes the key so operators can
        # tell mixed-divergence deployments apart
        self.divergence = vdt.divergence_name
        self.dispatch_key = f"{self.backend}:{self.divergence}"
        self.policy = policy
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self.aging_ms = float(aging_ms)
        self.adaptive_linger = bool(adaptive_linger)
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.coalesce_widths = bool(coalesce_widths)
        self._clock = clock
        self._queue = RequestQueue(max_queue, discipline=policy,
                                   aging_s=self.aging_ms / 1e3, clock=clock)
        self._metrics = EngineMetrics()
        self._seq = 0
        self._n_dispatch = 0  # _dispatch calls so far (the spans' number)
        self._in_flight = 0
        self.segment_iters = None if segment_iters is None else int(segment_iters)
        # arrival-rate estimate feeding the adaptive linger window
        self._ewma_gap_s: Optional[float] = None
        self._last_arrival: Optional[float] = None
        self._linger_window_ms = float("nan")
        # per-LP-iteration device-time estimate (EWMA over completed
        # segments), feeding the preempt horizon: "would anything queued
        # expire before the remaining iterations finish?"
        self._ewma_iter_s: Optional[float] = None
        self._state_lock = threading.Lock()
        self._stop = threading.Event()
        self._closed = False
        # host staging pool: (n_points, batch bucket, width bucket) -> np
        # buffer, refilled in place every scheduler iteration.  n_points is
        # part of the key because streaming publishes can change N; buffers
        # for point counts no live epoch uses are pruned by the scheduler
        # once the old epoch drains (_staging_dirty).
        self._staging: dict[tuple[int, int, int], np.ndarray] = {}
        self._staging_dirty = False
        self._thread: Optional[threading.Thread] = None
        # epoch-versioned model records: every queued entry pins the epoch
        # it was submitted under, so a publish() mid-flight never changes
        # the bits of already-accepted work (see publish)
        self._fit_params = FitParams(
            model=vdt, n_points=self.n, divergence=self.divergence, epoch=0)
        self._epoch_id = 0
        self._epochs: dict[int, _Epoch] = {0: _Epoch(
            eid=0, vdt=vdt, n=self.n, divergence=self.divergence,
            fit_params=self._fit_params)}
        self._stale_blocks = 0
        if start:
            self._thread = threading.Thread(
                target=self._loop, name="propagate-engine", daemon=True)
            self._thread.start()

    # ------------------------------------------------- engine-api data halves
    def capabilities(self) -> frozenset[str]:
        """See :meth:`Engine.capabilities
        <repro_torch.serving.engine_api.Engine.capabilities>`.

        The continuous-batching engine always publishes epochs and serves
        the grf walker backend; ``"preempt"`` is configuration-dependent —
        segmented dispatch only actually happens under ``policy="edf"``
        (the one discipline with an urgency signal) with ``segment_iters``
        set, so only that configuration reports it.
        """
        caps = {"publish", "grf"}
        if self.policy == "edf" and self.segment_iters is not None:
            caps.add("preempt")
        return frozenset(caps)

    @property
    def fit_params(self) -> FitParams:
        """The fitted tree + its serving identity (immutable, shareable)."""
        return self._fit_params

    @property
    def dispatch_state(self) -> DispatchState:
        """Live handles to the queue / staging pool / metrics sink.

        These are the engine's working structures (not copies) — the
        mutable half that exactly one scheduler may drive; see
        :class:`~repro_torch.serving.engine_api.DispatchState`.
        """
        return DispatchState(queue=self._queue, staging=self._staging,
                             metrics=self._metrics)

    # -------------------------------------------------------------- warmup
    def warmup(self, widths: Optional[Sequence[int]] = None,
               n_iters: Sequence[int] = (500,),
               backends: Optional[Sequence[str]] = None) -> int:
        """Run every dispatch shape this traffic can reach once, up front.

        The scheduler only ever issues shapes ``(batch bucket, N, width
        bucket)``: every power-of-two batch bucket up to ``max_batch``
        crossed with the width buckets that ``widths`` (default: all
        configured buckets) fall into, per backend.  Nothing is compiled
        per shape in torch, but a first call still pays for what a warm
        call leaves behind: the kernel libraries (``nvcc`` at first use),
        the model's dispatch buffers and ``x_rows``, the grf graph, the
        caching allocator's blocks for the shape and the BLAS handles.  So
        each shape runs ONE iteration per backend (and one resumed
        iteration when preemptible dispatch is on and a scan of ``n_iters``
        would segment).  ``backends`` defaults to the engine's default
        backend only; a hybrid deployment that tags requests onto another
        backend should pass e.g. ``backends=("vdt", "exact")``.

        Returns the reference engine's count for the same arguments — one
        per ``(backend, n_iters, width bucket, batch bucket)``, plus one per
        resume warm-up — although ``n_iters`` values share the one call per
        shape (no state in torch depends on the iteration count).
        """
        cbs = sorted(set(bucket_width(int(w), self.buckets)
                         for w in (widths or self.buckets)))
        bbs = []
        b = 1
        while b < self.max_batch:
            bbs.append(b)
            b <<= 1
        bbs.append(self.max_batch)
        count = 0
        warmed = set()
        caps = self.capabilities()
        dev = self.vdt.device
        for be in (backends or (self.backend,)):
            be = route_backend(be, self.backend, n=self.n)
            if be == "grf" and "grf" not in caps:
                raise ValueError(
                    f"{type(self).__name__} does not serve backend='grf' "
                    f"(capabilities: {sorted(caps)})")
            for ni in n_iters:
                for cb in cbs:
                    for bb in bbs:
                        z = torch.zeros((bb, self.n, cb), dtype=torch.float32,
                                        device=dev)
                        alphas = np.zeros((bb,), np.float32)
                        if (be, cb, bb) not in warmed:
                            self._scan(self.vdt, z, alphas, 1, be)
                            _sync(dev)
                        count += 1
                        # grf has no resume primitive to warm: it always
                        # dispatches monolithically
                        if (self.segment_iters is not None and be != "grf"
                                and int(ni) > self.segment_iters):
                            if (be, cb, bb, "resume") not in warmed:
                                self._scan_resume(self.vdt, z, z, alphas, 1,
                                                  be)
                                _sync(dev)
                                warmed.add((be, cb, bb, "resume"))
                            count += 1
                        warmed.add((be, cb, bb))
        return count

    # ------------------------------------------------------------ submission
    def submit(self, request: PropagateRequest, *, block: bool = True,
               timeout: Optional[float] = None) -> Future:
        """Enqueue one request; returns the future of its (N, C) answer.

        Shape/route/recipe problems surface here, not at dispatch —
        :meth:`PropagateRequest.validate
        <repro_torch.serving._batching.PropagateRequest.validate>` pins every
        malformed-request ``ValueError`` (bad shape or width, alpha outside
        ``[0, 1]``, unknown backend tag, non-positive deadline) at the
        submit call site and takes a private copy of the label matrix, so
        the caller may reuse its buffer afterwards.  When the queue is
        full, ``block=True`` waits (up to ``timeout``) for capacity and
        ``block=False`` raises :class:`QueueFull` immediately.  The future
        supports ``cancel()`` any time before its dispatch starts; under
        ``policy="edf"`` it may instead resolve with
        :class:`DeadlineExceeded` if the deadline passes while it is still
        queued.
        """
        if self._closed:
            raise RuntimeError("engine is shut down")
        # pin the serving epoch: validate against the current epoch's shape
        # contract OUTSIDE the lock (validation copies the label matrix),
        # then re-check under the lock that no publish() landed meanwhile —
        # if one did, revalidate against the new epoch's N.  The pending
        # increment happens under the same lock that publishes epochs, so
        # an accepted entry's epoch can never retire before it resolves.
        while True:
            with self._state_lock:
                eid = self._epoch_id
                n = self._epochs[eid].n
            validated = request.validate(n=n, buckets=self.buckets,
                                         default_backend=self.backend)
            if (validated.backend == "grf"
                    and "grf" not in self.capabilities()):
                # capability-gated routing: an engine that cannot serve the
                # walker estimator rejects grf-tagged traffic at the submit
                # call site, like every other malformed-request error
                raise ValueError(
                    f"{type(self).__name__} does not serve backend='grf' "
                    f"(capabilities: {sorted(self.capabilities())})")
            now = self._clock()
            with self._state_lock:
                if self._epoch_id != eid:
                    continue  # publish raced the validation: revalidate
                self._epochs[eid].pending += 1
                seq = self._seq
                self._seq += 1
                # EWMA of inter-arrival gaps -> the adaptive linger's rate
                # estimate; beta 0.25 tracks bursts within ~4 arrivals while
                # smoothing one-off stalls
                if self._last_arrival is not None:
                    gap = max(now - self._last_arrival, 0.0)
                    if self._ewma_gap_s is None:
                        self._ewma_gap_s = gap
                    else:
                        self._ewma_gap_s += 0.25 * (gap - self._ewma_gap_s)
                self._last_arrival = now
            break
        fut: Future = Future()
        entry = QueueEntry(
            seq=seq, request=validated, future=fut, t_submit=now,
            priority=validated.priority,
            t_deadline=None if validated.deadline_ms is None
            else now + validated.deadline_ms / 1e3,
            epoch=eid)
        t_put = self._clock()
        try:
            self._queue.put(entry, block=block, timeout=timeout)
        except QueueFull:
            with self._state_lock:
                self._epochs[eid].pending -= 1
                self._retire_locked()
            self._metrics.count("rejected")
            raise
        finally:
            self._metrics.count("blocked_s", self._clock() - t_put)
        if self._closed and fut.cancel():
            # lost the race with shutdown(): the entry landed after (or
            # during) the final flush, so nobody may ever drain it — cancel
            # rather than hand back a future that could hang forever
            self._metrics.count("cancelled")
            raise RuntimeError("engine is shut down")
        self._metrics.count("submitted")
        return fut

    # ------------------------------------------------------------ scheduling
    def step(self) -> int:
        """One synchronous scheduler iteration: drain + dispatch, no linger.

        Returns the number of futures resolved (results, failures, and
        expired fast-fails).  This is the whole scheduler — the background
        thread calls the same code after its batching wait — so tests drive
        it deterministically.
        """
        self._prune_staging()
        live, cancelled, expired = self._queue.drain(self.max_batch)
        if cancelled:
            self._metrics.count("cancelled", len(cancelled))
            self._release(cancelled)
        resolved = 0
        for entry in expired:
            # edf fast-fail: the deadline passed while queued, so resolve
            # with the pinned exception instead of wasting a dispatch slot
            if entry.future.set_running_or_notify_cancel():
                entry.future.set_exception(DeadlineExceeded(
                    f"deadline_ms={entry.request.deadline_ms} expired "
                    f"before dispatch"))
                self._metrics.count("expired")
                resolved += 1
            else:
                self._metrics.count("cancelled")
        self._release(expired)
        if not live:
            return resolved
        with self._state_lock:
            self._in_flight += len(live)
        try:
            return resolved + self._dispatch(live)
        finally:
            with self._state_lock:
                self._in_flight -= len(live)

    def flush(self) -> int:
        """Drain the backlog *as of this call*; returns futures resolved.

        Deliberately NOT "step until empty": under concurrent producers a
        length-polling loop never terminates as long as arrivals keep pace
        with service (livelock — the flusher, e.g. ``shutdown(wait=True)``,
        would be held hostage by other threads' traffic).  Instead the
        backlog size and the queue's monotone pop counter are snapshotted
        once, and stepping stops as soon as that many entries have been
        popped — everything queued when ``flush`` was called is served,
        while entries racing in afterwards wait for the next scheduler
        pass.
        """
        backlog = len(self._queue)
        if backlog == 0:
            return 0
        start_popped = self._queue.popped
        total = 0
        while (self._queue.popped - start_popped < backlog
               and len(self._queue) > 0):
            total += self.step()
        return total

    # while lingering, arrivals quiescing for this long end the batching
    # window early — resubmit bursts from closed-loop clients land within a
    # few of these, so a lone request never waits out the window even when
    # the rate estimate is stale
    _QUIESCE_S = 1e-3

    def _linger_window_s(self) -> float:
        """Pick this iteration's batching window (seconds).

        Rate-adaptive: the EWMA inter-arrival gap estimates how long the
        remaining ``max_batch - queued`` slots take to fill, and that is
        the window — clamped to ``[0, max_wait_ms]`` (no estimate yet falls
        back to the cap; the quiesce early-exit protects lone requests
        either way).  Under ``policy="edf"`` the window is additionally
        capped at the earliest queued deadline so lingering can never
        itself expire the most urgent request.
        """
        window = cap = self.max_wait_ms / 1e3
        if self.adaptive_linger:
            with self._state_lock:
                gap = self._ewma_gap_s
            if gap is not None:
                missing = max(0, self.max_batch - len(self._queue))
                window = min(cap, gap * missing)
        nearest = self._queue.next_deadline()
        if nearest is not None:
            window = min(window, max(0.0, nearest - self._clock()))
        with self._state_lock:
            # under the lock: metrics() reads this gauge from other threads,
            # and an unsynchronized write can tear the snapshot
            self._linger_window_ms = window * 1e3
        return window

    def _linger(self) -> None:
        """Batching window: wait up to the adaptive window for a fuller
        batch, ending early once the batch is full or arrivals stop."""
        window = self._linger_window_s()
        if window <= 0:
            return
        deadline = self._clock() + window
        seen = len(self._queue)
        while seen < self.max_batch:
            # re-check the most urgent queued deadline every iteration: a
            # tight-deadline request ARRIVING mid-linger must shrink the
            # window, or the linger itself could expire it
            nearest = self._queue.next_deadline()
            if nearest is not None and nearest < deadline:
                deadline = nearest
            remaining = deadline - self._clock()
            if remaining <= 0:
                return
            self._queue.wait_atleast(
                self.max_batch, timeout=min(remaining, self._QUIESCE_S))
            grown = len(self._queue)
            if grown == seen:
                return  # quiesced: dispatch what we have
            seen = grown

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                if not self._queue.wait_nonempty(timeout=0.05):
                    continue
                if self.max_wait_ms > 0:
                    t0 = self._clock()
                    with _Span("engine.linger"):
                        self._linger()
                    self._metrics.count("linger_s", self._clock() - t0)
                self.step()
            except Exception:  # never let the scheduler thread die silently
                # per-group errors were already delivered via set_exception;
                # anything reaching here is scheduler-internal.  Count it
                # and log the traceback — a silently swallowed fault looks
                # exactly like a healthy idle engine from the outside —
                # then back off a beat so a persistent fault can't
                # busy-spin the thread
                self._metrics.count("scheduler_errors")
                _log.exception("scheduler iteration failed; backing off")
                self._stop.wait(0.05)

    def _dispatch(self, entries: list[QueueEntry],
                  preemptible: bool = True) -> int:
        """Group, pad, and serve one drained microbatch.

        ``preemptible=False`` forces monolithic scans — the urgent
        service pass dispatches with it so a preemption can never nest
        inside another preemption (unbounded recursion while the original
        suspended walk starves).

        The call is one ``engine.dispatch`` span (its number and the
        entries' ``seq``s as keyword values); each group in it runs the
        phases ``engine.stage`` (grouping has one of its own), ``engine.walk``,
        ``engine.copy_out`` and ``engine.resolve``, each span timed on the
        engine's clock into the ``MetricsSnapshot`` field of its name.
        """
        t_mark = self._clock()  # the first group's start: grouping is staging
        self._n_dispatch += 1
        with _Span("engine.dispatch", (), {
                "dispatch": self._n_dispatch,
                "seqs": ",".join(str(e.seq) for e in entries)}):
            return self._dispatch_groups(entries, preemptible, t_mark)

    def _dispatch_groups(self, entries: list[QueueEntry], preemptible: bool,
                         t_mark: float) -> int:
        # group by (epoch, n_iters, backend) (+ width bucket unless
        # coalescing) via the canonical serving-tier key: only requests
        # sharing a scan length AND a transition matrix can share a
        # dispatch — and under streaming updates the transition matrix IS
        # the epoch, so entries pinned to different epochs never coalesce
        # (each group dispatches against exactly the model its entries
        # were submitted under, bit-identically).  Backends were resolved
        # at submit, so None / "auto" tags that landed on the same
        # concrete backend coalesce.  Alpha always rides as a per-request
        # array and never fragments a group.
        groups: dict[tuple[int, int, str, int], list[QueueEntry]] = {}
        dead: list[QueueEntry] = []
        with _Span("engine.stage"):
            for entry in entries:
                if not entry.future.set_running_or_notify_cancel():
                    self._metrics.count("cancelled")  # cancelled post-drain
                    dead.append(entry)
                    continue
                key = (entry.epoch,) + dispatch_group_key(
                    entry.request, self.buckets,
                    coalesce_widths=self.coalesce_widths)
                groups.setdefault(key, []).append(entry)
            self._release(dead)

        resolved = 0
        for (epoch, n_iters, backend, cb), group in sorted(groups.items()):
            with self._state_lock:
                ep = self._epochs[epoch]  # pinned: pending > 0 keeps it live
            vdt, n = ep.vdt, ep.n
            if self.coalesce_widths:
                cb = max(bucket_width(e.request.y0.shape[1], self.buckets)
                         for e in group)
            n_walkers = None
            if backend == "grf":
                # max-over-group walker budget: more walkers strictly
                # tightens every member's estimate, so the hungriest
                # request sets the batch budget (the width-coalescing
                # argument applied to accuracy) — walker count never
                # fragments a group
                n_walkers = max(self._walker_budget(e.request)
                                for e in group)
                with self._state_lock:
                    self._last_n_walkers = n_walkers
            group.sort(key=lambda e: e.seq)  # deterministic batch layout
            urgent_resolved = 0
            try:
                with _Span("engine.stage"):
                    bb = batch_bucket(len(group), self.max_batch)
                    stack = self._staging.setdefault(
                        (n, bb, cb), np.zeros((bb, n, cb), np.float32))
                    stack.fill(0.0)
                    alphas = np.zeros((bb,), np.float32)  # padding: alpha 0
                    for k, entry in enumerate(group):
                        y0 = entry.request.y0
                        stack[k, :, :y0.shape[1]] = y0
                        alphas[k] = entry.request.alpha
                    # device-resident seed of its own: urgent dispatches
                    # between segments refill the SAME staging buffers, so
                    # no walk may read the staging pool after this
                    # synchronous copy
                    y0_dev = _to_device(stack, vdt.device)
                t_staged = self._clock()
                out, urgent_resolved, walk_s = self._propagate_group(
                    group, y0_dev, alphas, n_iters, backend, preemptible,
                    vdt, n_walkers=n_walkers)
            except Exception as exc:  # resolve the group, keep scheduling
                for entry in group:
                    entry.future.set_exception(exc)
                self._metrics.count("failed", len(group))
                self._release(group)
                resolved += len(group) + urgent_resolved
                t_mark = self._clock()
                continue
            resolved += urgent_resolved
            widths = tuple(e.request.y0.shape[1] for e in group)
            self._metrics.record_dispatch(
                len(group), stage_s=t_staged - t_mark, walk_s=walk_s,
                queued_s=sum(t_mark - e.t_submit for e in group),
                columns_real=sum(widths), columns_walked=bb * cb)
            # slot-based result layout (engine_api.ResultSlab): ONE
            # device-to-host copy for the whole group, then each future
            # resolves to a zero-copy view sliced to its true width —
            # host-transfer cost per dispatch is one contiguous array,
            # however many requests coalesced into it
            t0 = self._clock()
            with _Span("engine.copy_out"):
                slab = ResultSlab(data=out.cpu().numpy(), widths=widths)
            t_done = self._clock()
            latencies, missed = [], 0
            with _Span("engine.resolve"):
                for k, entry in enumerate(group):
                    entry.future.set_result(slab.view(k))
                    latencies.append(t_done - entry.t_submit)
                    if (entry.t_deadline is not None
                            and t_done > entry.t_deadline):
                        # answered, but late: visible in metrics so
                        # operators can tell "meets deadlines" from
                        # "merely completes"
                        missed += 1
                self._release(group)
            t_mark = self._clock()
            self._metrics.record_resolved(
                latencies, deadline_missed=missed, copy_out_s=t_done - t0,
                resolve_s=t_mark - t_done)
            resolved += len(group)
        return resolved

    # ------------------------------------------------------ epoch lifecycle
    def _release(self, entries) -> None:
        """Drop the epoch pins of terminally-resolved entries; retire drained
        epochs.  Called exactly once per accepted entry, at whichever path
        resolves it (result, failure, cancel, or expiry)."""
        if not entries:
            return
        with self._state_lock:
            for entry in entries:
                ep = self._epochs.get(entry.epoch)
                if ep is not None:
                    ep.pending -= 1
            self._retire_locked()

    def _retire_locked(self) -> None:
        """Drop non-current epochs with no pending entries (lock held).

        Retiring releases the epoch's pinned model (its device dispatch
        buffers go with it once no one else references the tree) and flags
        the staging pool for pruning — buffers sized for a point count no
        live epoch serves are freed by the scheduler thread on its next
        pass (`_prune_staging`), never by whatever submit/publish thread
        happened to drop the last pin.
        """
        dead = [eid for eid, ep in self._epochs.items()
                if eid != self._epoch_id and ep.pending <= 0]
        for eid in dead:
            del self._epochs[eid]
        if dead:
            self._metrics.count("epochs_retired", len(dead))
            self._staging_dirty = True

    def _prune_staging(self) -> None:
        """Free staging buffers no live epoch can use (scheduler thread
        only — the staging pool is single-owner dispatch state)."""
        if not self._staging_dirty:
            return
        with self._state_lock:
            live_n = {ep.n for ep in self._epochs.values()}
            self._staging_dirty = False
        for key in [k for k in self._staging if k[0] not in live_n]:
            del self._staging[key]

    def publish(self, model, *, patched_points: int = 0,
                stale_blocks: int = 0) -> int:
        """Swap in a streaming-updated tree as the next epoch; returns it.

        The epoch-versioned model swap behind online inserts/deletes
        (``core/streaming.py``): ``model`` — typically ``update.vdt`` from
        :func:`~repro_torch.core.streaming.insert_points` /
        :func:`~repro_torch.core.streaming.delete_points` — becomes the current
        epoch atomically with respect to :meth:`submit`.  Entries already
        queued or in flight stay pinned to their submission epoch and
        complete **bit-identically** against that tree (streaming
        mutations are copy-on-write, so the old epoch's arrays are frozen
        by construction); every submit returning after this call validates
        against and dispatches on the new epoch.  Old epochs retire as
        their last entry resolves — their model pin drops and staging
        buffers sized only for them are pruned — and ``metrics()`` tracks
        the swap (``epoch``/``live_epochs`` gauges, ``epochs_published`` /
        ``epochs_retired`` / ``patched_points`` counters).

        ``patched_points`` / ``stale_blocks`` are the streaming update's
        bookkeeping (``StreamUpdate.patched_points`` /
        ``StreamUpdate.stale_blocks``), surfaced as metrics so operators
        can watch model drift and pending refinement debt.  Thread-safe;
        may be called from any thread, any number of times.
        """
        if self._closed:
            raise RuntimeError("engine is shut down")
        n = int(model.tree.n_points)
        divergence = model.divergence_name
        with self._state_lock:
            eid = self._epoch_id + 1
            fp = FitParams(model=model, n_points=n, divergence=divergence,
                           epoch=eid)
            self._epochs[eid] = _Epoch(eid=eid, vdt=model, n=n,
                                       divergence=divergence, fit_params=fp)
            self._epoch_id = eid
            self.vdt = model
            self.n = n
            self.divergence = divergence
            self.dispatch_key = f"{self.backend}:{divergence}"
            self._fit_params = fp
            self._stale_blocks = int(stale_blocks)
            self._retire_locked()
        self._metrics.count("epochs_published")
        if patched_points:
            self._metrics.count("patched_points", int(patched_points))
        return eid

    def _walker_budget(self, request: PropagateRequest) -> int:
        """One grf request's walker budget: explicit > rtol-sized > default."""
        if request.n_walkers is not None:
            return int(request.n_walkers)
        if request.rtol is not None:
            from repro_torch.core.grf import walkers_for_rtol

            return walkers_for_rtol(request.rtol)
        return self.n_walkers

    # ------------------------------------------------------- device dispatch
    # The two scan hooks below are the ONLY places the scheduler touches
    # device math.  Everything above them — queue disciplines, grouping,
    # staging, segmentation, epoch pinning, metrics — is device-layout
    # agnostic, so an engine that runs the same eq.-15 walk on different
    # hardware (``serving/_sharded.py::ShardedPropagateEngine``) overrides
    # exactly these two methods and inherits the whole scheduler.

    def _scan(self, vdt, stack, alphas, n_iters: int, backend: str, *,
              n_walkers=None):
        """One monolithic batched LP dispatch: ``(bb, N, cb)`` in and out.

        ``vdt`` is the pinned epoch's fitted tree (NOT necessarily
        ``self.vdt`` — entries dispatch against the epoch they were
        submitted under).  ``stack`` lies on the model's device;
        ``alphas`` is the per-request ``(bb,)`` numpy array (padding rows
        0); ``n_walkers`` only matters to grf dispatches.  Returns without
        waiting for the device.
        """
        kw = {}
        if backend == "grf":
            kw = {"n_walkers": int(n_walkers) if n_walkers is not None
                  else self.n_walkers, "seed": self.grf_seed}
        return vdt.label_propagate(stack, alpha=alphas, n_iters=int(n_iters),
                                   batched=True, backend=backend, **kw)

    def _scan_resume(self, vdt, carry, y0, alphas, n_iters, backend: str):
        """``n_iters`` more eq.-15 steps from a mid-walk ``(bb, N, cb)``
        carry — the segmented-dispatch primitive (bit-identical to never
        having paused)."""
        return vdt.label_propagate_resume(carry, y0, alpha=alphas,
                                          n_iters=n_iters, batched=True,
                                          backend=backend)

    def _propagate_group(self, group: list[QueueEntry], y0_dev: torch.Tensor,
                         alphas: np.ndarray, n_iters: int, backend: str,
                         preemptible: bool, vdt=None, n_walkers=None):
        """Run one group's LP walk, segmented and preemptible when enabled.

        Returns ``(out, urgent_resolved, walk_s)`` where ``out`` is the
        group's final ``(bb, N, cb)`` label stack, ``urgent_resolved``
        counts futures resolved by urgent service passes taken at segment
        boundaries (0 on the monolithic path), and ``walk_s`` the engine
        clock's seconds in this walk's own scans and device waits (each an
        ``engine.walk`` span; the urgent passes between segments are
        not in it).

        The walk is segmented only when it is worth anything: preemption
        enabled (``segment_iters``), the EDF discipline (the only one with
        an urgency signal), the scan actually longer than one segment, and
        an outer (non-nested) dispatch.  Each segment resumes from the
        previous carry via ``label_propagate_resume`` — bit-identical to
        the monolithic scan (eq. 15 is a pure fixed-point iteration, and
        neither K1 nor the VDT walk reduces with atomics: on the card the
        walk's block combine is a kernel that sums each node's blocks in a
        fixed order, ``kernels/block_combine``).  After each segment the
        measured per-iteration device time feeds an EWMA, and if anything
        queued would expire before the estimated completion of the
        remaining iterations, the walk yields the device to
        :meth:`_service_urgent` before resuming.
        """
        if vdt is None:
            vdt = self.vdt
        dev = vdt.device
        seg = self.segment_iters
        # grf always dispatches monolithically: the MC series estimator has
        # no exact resume primitive (label_propagate_resume rejects grf).
        # Otherwise segment only when this configuration actually preempts
        # — the capability the engine itself reports, not an attribute probe
        if (backend == "grf" or not preemptible
                or "preempt" not in self.capabilities()
                or int(n_iters) <= seg):
            t0 = self._clock()
            with _Span("engine.walk"):
                out = self._scan(vdt, y0_dev, alphas, n_iters, backend,
                                 n_walkers=n_walkers)
                _sync(dev)
            return out, 0, self._clock() - t0
        rec = _InFlightScan(entries=group, carry=y0_dev, y0=y0_dev,
                            alphas=alphas, n_iters=int(n_iters),
                            backend=backend)
        urgent_resolved = 0
        walk_s = 0.0
        while rec.iters_done < rec.n_iters:
            k = min(seg, rec.n_iters - rec.iters_done)
            t0 = self._clock()
            with _Span("engine.walk"):
                rec.carry = self._scan_resume(vdt, rec.carry, rec.y0,
                                              rec.alphas, k, rec.backend)
                _sync(dev)
            dt = max(self._clock() - t0, 0.0)
            walk_s += dt
            rec.iters_done += k
            with self._state_lock:
                per_iter = dt / k
                if self._ewma_iter_s is None:
                    self._ewma_iter_s = per_iter
                else:
                    self._ewma_iter_s += 0.25 * (per_iter - self._ewma_iter_s)
                est_iter_s = self._ewma_iter_s
            remaining = rec.n_iters - rec.iters_done
            if remaining <= 0:
                break
            horizon = self._clock() + est_iter_s * remaining
            if self._queue.deadline_before(horizon):
                # segment-boundary yield: an arrival's deadline would
                # expire before the in-flight walk completes — serve it
                # now, then resume from the carry bit-identically
                self._metrics.count("preemptions")
                self._metrics.count("preempt_iters", remaining)
                urgent_resolved += self._service_urgent(horizon)
        return rec.carry, urgent_resolved, walk_s

    def _service_urgent(self, horizon: float) -> int:
        """Serve queued entries whose deadline falls before ``horizon``.

        The preemption service pass: pops ONLY urgent entries (the EDF
        heap is deadline-ordered, so this is a prefix drain) and
        dispatches them with ``preemptible=False`` — the suspended walk is
        already waiting, and a nested preemption could starve it without
        bound.  Cancelled/expired entries popped on the way resolve
        exactly as in :meth:`step`.
        """
        live, cancelled, expired = self._queue.drain_urgent(
            self.max_batch, horizon)
        if cancelled:
            self._metrics.count("cancelled", len(cancelled))
            self._release(cancelled)
        resolved = 0
        for entry in expired:
            if entry.future.set_running_or_notify_cancel():
                entry.future.set_exception(DeadlineExceeded(
                    f"deadline_ms={entry.request.deadline_ms} expired "
                    f"before dispatch"))
                self._metrics.count("expired")
                resolved += 1
            else:
                self._metrics.count("cancelled")
        self._release(expired)
        if not live:
            return resolved
        with self._state_lock:
            self._in_flight += len(live)
        try:
            return resolved + self._dispatch(live, preemptible=False)
        finally:
            with self._state_lock:
                self._in_flight -= len(live)

    # ----------------------------------------------------------- lifecycle
    def metrics(self) -> MetricsSnapshot:
        with self._state_lock:
            in_flight = self._in_flight
            linger_window_ms = self._linger_window_ms
            epoch = self._epoch_id
            stale_blocks = self._stale_blocks
            live_epochs = len(self._epochs)
            n_walkers = self._last_n_walkers
        return self._metrics.snapshot(
            queue_depth=len(self._queue), in_flight=in_flight,
            dispatch_key=self.dispatch_key, policy=self.policy,
            linger_window_ms=linger_window_ms, epoch=epoch,
            stale_blocks=stale_blocks, live_epochs=live_epochs,
            n_walkers=n_walkers)

    def shutdown(self, wait: bool = True) -> None:
        """Stop accepting work; serve (``wait=True``) or cancel the backlog.

        Idempotent.  New ``submit`` calls raise ``RuntimeError`` immediately;
        the background scheduler thread (if any) is joined before the
        backlog is handled, so after return no dispatch is in flight.
        ``wait=False`` cancels every queued *live* future instead of
        serving it (counted under ``cancelled`` in the metrics) — but
        entries whose EDF deadline already expired still resolve with the
        pinned :class:`DeadlineExceeded` (counted under ``expired``):
        "expired" is an outcome the client was promised a typed exception
        for, and a teardown path must not degrade it into a bare cancel.
        Also invoked by the context manager: ``__exit__`` serves the
        backlog on a clean exit and cancels it when unwinding an exception.
        """
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if wait:
            self.flush()
        else:
            live, cancelled, expired = self._queue.drain(self._queue.maxsize)
            n_cancelled = len(cancelled)
            for entry in live:
                entry.future.cancel()
                n_cancelled += 1
            for entry in expired:
                if entry.future.set_running_or_notify_cancel():
                    entry.future.set_exception(DeadlineExceeded(
                        f"deadline_ms={entry.request.deadline_ms} expired "
                        f"before dispatch (engine shut down)"))
                    self._metrics.count("expired")
                else:
                    n_cancelled += 1
            self._metrics.count("cancelled", n_cancelled)
            self._release(live + cancelled + expired)
