"""``repro_torch/serving/_metrics.py`` ↔ ``repro/serving/_metrics.py``.

Engine observability: thread-safe counters + latency quantiles.

The engine records one event per lifecycle transition (submit, reject,
cancel, expire, dispatch, complete); :meth:`EngineMetrics.snapshot` folds
them into an immutable :class:`MetricsSnapshot` that benchmarks and
operators read.  Latencies live in a bounded ring (newest
:data:`LATENCY_WINDOW` samples), so a long-running engine reports *recent*
p50/p95 rather than lifetime ones and memory stays O(1).
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque

__all__ = ["EngineMetrics", "MetricsSnapshot", "LATENCY_WINDOW"]

# newest-K latency ring: big enough for stable p95, small enough to be O(1)
LATENCY_WINDOW = 4096


def _quantile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return float("nan")
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


@dataclasses.dataclass(frozen=True)
class MetricsSnapshot:
    """Point-in-time view of engine health (all times milliseconds).

    Counter fields are monotone lifetime totals; gauge fields
    (``queue_depth``, ``in_flight``, ``linger_window_ms``) are
    instantaneous; latency quantiles cover the newest
    :data:`LATENCY_WINDOW` completed requests, measured from queue accept
    (``submit`` return) to future resolution — i.e. they include
    queueing/linger time, not just device time.  Conservation: every
    accepted request ends in exactly one of ``completed``, ``failed``,
    ``cancelled`` or ``expired`` (``submitted`` minus those four = queued
    or in flight); ``rejected`` requests were never accepted and appear in
    no other counter.  ``deadline_missed`` is an annotation on
    ``completed``: answers that resolved successfully but after their
    request's deadline (only the ``edf`` discipline fast-fails instead).
    """

    dispatch_key: str = ""  # engine identity: "backend:divergence" — two
    #   engines sharing a process but differing in backend or fitted
    #   divergence report different keys, mirroring the fact that their
    #   dispatches can never share (or cross-contaminate) a kernel
    #   launch.  A hybrid engine (per-request backends) reports its
    #   DEFAULT backend here; per-group backends ride the dispatch itself.
    policy: str = ""  # queue discipline: "fifo" | "priority" | "edf"
    submitted: int = 0  # accepted into the queue (excludes rejected)
    rejected: int = 0  # refused at submit: queue at capacity (backpressure)
    cancelled: int = 0  # future.cancel() won before the dispatch started
    expired: int = 0  # edf fast-fail: deadline passed while queued
    deadline_missed: int = 0  # completed, but later than the deadline
    completed: int = 0  # futures resolved with a result
    failed: int = 0  # futures resolved with an exception (bad dispatch)
    dispatches: int = 0  # batched device dispatches issued
    batched_requests: int = 0  # real (non-padding) requests in those dispatches
    scheduler_errors: int = 0  # scheduler-internal faults the loop survived
    #   (NOT per-request failures — those resolve futures and count under
    #   ``failed``); nonzero here means the background thread hit and
    #   logged an unexpected exception, so check the logs
    preemptions: int = 0  # segment-boundary yields: an in-flight segmented
    #   scan paused so urgent-deadline arrivals could dispatch first
    preempt_iters: int = 0  # LP iterations still pending at those yields —
    #   the amount of in-flight work each preemption stepped in front of
    epochs_published: int = 0  # streaming model swaps accepted (publish())
    epochs_retired: int = 0  # old epochs fully drained and dropped — their
    #   pinned FitParams and any staging buffers sized for them released
    patched_points: int = 0  # points inserted/deleted across all publishes
    epoch: int = 0  # current serving epoch (gauge; 0 = the fitted model)
    stale_blocks: int = 0  # blocks awaiting refinement priority on the
    #   current epoch, as reported by the last publish (gauge)
    live_epochs: int = 1  # epochs still pinned by queued/in-flight entries,
    #   including the current one (gauge; >1 means an old epoch is still
    #   draining)
    n_walkers: int = 0  # walker budget of the most recent grf dispatch
    #   (gauge; 0 = no grf group dispatched yet).  A grf group dispatches
    #   at the MAX budget over its members, so this is the budget actual
    #   device work ran at — the accuracy-vs-latency dial operators watch
    queue_depth: int = 0  # entries waiting right now (gauge)
    in_flight: int = 0  # drained but not yet resolved (gauge)
    linger_window_ms: float = float("nan")  # current adaptive batching window
    latency_p50_ms: float = float("nan")  # windowed submit->result median
    latency_p95_ms: float = float("nan")  # windowed tail latency
    latency_mean_ms: float = float("nan")  # windowed mean

    @property
    def batch_occupancy(self) -> float:
        """Mean real requests per dispatch (the continuous-batching win)."""
        if self.dispatches == 0:
            return float("nan")
        return self.batched_requests / self.dispatches


class EngineMetrics:
    """Mutable, lock-guarded event sink behind :class:`MetricsSnapshot`."""

    def __init__(self, latency_window: int = LATENCY_WINDOW):
        self._lock = threading.Lock()
        self._counts = dict(
            submitted=0,
            rejected=0,
            cancelled=0,
            expired=0,
            deadline_missed=0,
            completed=0,
            failed=0,
            dispatches=0,
            batched_requests=0,
            scheduler_errors=0,
            preemptions=0,
            preempt_iters=0,
            epochs_published=0,
            epochs_retired=0,
            patched_points=0,
        )
        self._latencies_ms: deque[float] = deque(maxlen=latency_window)

    def count(self, event: str, n: int = 1) -> None:
        with self._lock:
            self._counts[event] += n

    def record_dispatch(self, n_requests: int) -> None:
        with self._lock:
            self._counts["dispatches"] += 1
            self._counts["batched_requests"] += n_requests

    def record_latency(self, seconds: float) -> None:
        with self._lock:
            self._latencies_ms.append(seconds * 1e3)

    def snapshot(
        self,
        queue_depth: int = 0,
        in_flight: int = 0,
        dispatch_key: str = "",
        policy: str = "",
        linger_window_ms: float = float("nan"),
        epoch: int = 0,
        stale_blocks: int = 0,
        live_epochs: int = 1,
        n_walkers: int = 0,
    ) -> MetricsSnapshot:
        with self._lock:
            lat = sorted(self._latencies_ms)
            counts = dict(self._counts)
        mean = sum(lat) / len(lat) if lat else float("nan")
        return MetricsSnapshot(
            dispatch_key=dispatch_key,
            policy=policy,
            queue_depth=queue_depth,
            in_flight=in_flight,
            linger_window_ms=linger_window_ms,
            epoch=epoch,
            stale_blocks=stale_blocks,
            live_epochs=live_epochs,
            n_walkers=n_walkers,
            latency_p50_ms=_quantile(lat, 0.50),
            latency_p95_ms=_quantile(lat, 0.95),
            latency_mean_ms=mean,
            **counts,
        )
