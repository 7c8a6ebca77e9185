"""``repro_torch/serving/_queue.py`` ↔ ``repro/serving/_queue.py``.

Pluggable queue-discipline layer for the continuous-batching engine.

A condition-variable wrapper around an ordered container, purpose-built for
the scheduler's access pattern:

* producers (``PropagateEngine.submit``) ``put`` one entry, either failing
  fast (``QueueFull``) or blocking until space frees — the engine's
  backpressure;
* the single scheduler consumer waits for the queue to go non-empty
  (``wait_nonempty``) and then ``drain``\\ s up to a whole microbatch in one
  lock acquisition, skipping entries whose future was already cancelled.

``stdlib queue.Queue`` fits none of this: no multi-item atomic drain, no
cancellation filtering, and its unfinished-task accounting is dead weight
here.

Queue disciplines (scheduler v2)
--------------------------------
``discipline`` selects the order ``drain`` pops entries in:

``"fifo"`` (default)
    Submission order — bit-identical to the original single-discipline
    queue (a plain deque; ``drain`` is ``popleft``).

``"priority"``
    Highest :attr:`QueueEntry.priority` first, with **starvation-bounded
    aging**: an entry's effective rank is ``priority - t_submit /
    aging_s``, so every second spent waiting is worth ``1 / aging_s``
    priority levels.  Two consequences, both deterministic because the
    rank is a static function of ``(priority, t_submit)``: entries of
    equal priority stay FIFO among themselves, and a default-priority
    entry outranks any higher-priority entry submitted more than
    ``aging_s * (priority gap)`` later — no entry can be starved for
    longer than that bound (plus one service round).

``"edf"``
    Earliest-deadline-first: smallest absolute :attr:`QueueEntry.t_deadline`
    first; entries without a deadline sort after every deadlined one, FIFO
    among themselves.  ``drain`` additionally **fast-fails expired
    entries**: anything already past its deadline is returned in the
    ``expired`` list instead of ``live``, so a dispatch slot is never spent
    computing an answer whose deadline has passed (the engine resolves
    those futures with :class:`DeadlineExceeded`).

Time comes from the injectable ``clock`` (default
``time.perf_counter``) — aging ranks and expiry checks are deterministic
under a fake clock, which is how the scheduler property tests drive this
layer.

Concurrency contract
--------------------
All methods are thread-safe; any number of producer threads may ``put``
concurrently.  The design assumes a SINGLE consumer (the engine's
scheduler): ``wait_nonempty``/``wait_atleast`` + ``drain`` are only
race-free in the sense that one consumer sees every entry exactly once —
two concurrent drainers would simply split the backlog between them.
Cancellation is cooperative: cancelling an entry's future while it is
queued guarantees it never reaches a dispatch (the next ``drain`` discards
it), but cancellation after a drain has returned the entry is the
dispatcher's problem (see ``PropagateEngine._dispatch``).
"""
from __future__ import annotations

import dataclasses
import heapq
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, Optional

__all__ = [
    "DISCIPLINES",
    "DeadlineExceeded",
    "QueueEntry",
    "QueueFull",
    "RequestQueue",
]

DISCIPLINES = ("fifo", "priority", "edf")

# rank gained per second of waiting under the "priority" discipline; see
# RequestQueue for the starvation bound it implies
DEFAULT_AGING_S = 0.5


class QueueFull(RuntimeError):
    """Raised by a non-blocking ``put`` when the queue is at capacity."""


class DeadlineExceeded(RuntimeError):
    """An EDF request expired before its dispatch started.

    Pinned API: futures of expired entries resolve with exactly this
    exception type, so clients can catch it and shed/retry — it never
    degrades into a generic ``RuntimeError`` or a silent late answer.
    """


@dataclasses.dataclass
class QueueEntry:
    """A submitted request riding through the scheduler."""

    seq: int  # submission order, for deterministic tie-breaks
    request: object  # PropagateRequest
    future: Future  # resolved by the dispatch that serves it
    t_submit: float  # clock() at accept, for latency metrics + aging
    priority: int = 0  # larger = more urgent ("priority" discipline)
    t_deadline: Optional[float] = None  # absolute clock() deadline ("edf")
    epoch: int = 0  # fitted-model epoch pinned at submit: the entry is
    #   dispatched against exactly this epoch's tree even if a streaming
    #   publish lands while it is queued (see PropagateEngine.publish)


class RequestQueue:
    """Bounded request queue with a pluggable pop-order discipline.

    ``drain`` atomically pops up to a microbatch in discipline order with
    cancel filtering (and, under ``"edf"``, expiry fast-fail); ``put``
    blocks or raises :class:`QueueFull` — the backpressure surface.
    """

    def __init__(
        self,
        maxsize: int,
        discipline: str = "fifo",
        *,
        aging_s: float = DEFAULT_AGING_S,
        clock: Callable[[], float] = time.perf_counter,
    ):
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        if discipline not in DISCIPLINES:
            raise ValueError(f"discipline must be one of {DISCIPLINES}, got {discipline!r}")
        if aging_s <= 0:
            raise ValueError(f"aging_s must be > 0, got {aging_s}")
        self.maxsize = maxsize
        self.discipline = discipline
        self.aging_s = float(aging_s)
        self._clock = clock
        # fifo keeps the original deque (bit-identical behavior); the other
        # disciplines keep a heap of (sort key, seq, entry) triples — both
        # ranks are static functions of the entry, so heap order is exact
        self._fifo: deque[QueueEntry] = deque()
        self._heap: list[tuple[float, int, QueueEntry]] = []
        # lifetime pops (live + cancelled + expired): lets a consumer bound
        # "drain what was queued at time T" without racing fresh producers
        # (PropagateEngine.flush snapshots this against len())
        self._popped = 0
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)

    def _key(self, entry: QueueEntry) -> float:
        """Heap sort key (smaller pops first) — static per entry."""
        if self.discipline == "priority":
            # effective rank priority - t_submit/aging_s, highest first:
            # waiting 1 * aging_s is worth one priority level, so the rank
            # gap between an old low-priority entry and newer high-priority
            # traffic closes at a fixed, clock-driven rate
            return -(entry.priority - entry.t_submit / self.aging_s)
        # edf: earliest absolute deadline first; deadline-less entries last
        return entry.t_deadline if entry.t_deadline is not None else float("inf")

    def __len__(self) -> int:
        with self._lock:
            return len(self._fifo) + len(self._heap)

    def _size_locked(self) -> int:
        return len(self._fifo) + len(self._heap)

    def put(self, entry: QueueEntry, block: bool = True, timeout: Optional[float] = None) -> None:
        """Append ``entry``; raise :class:`QueueFull` if no space appears.

        ``block=False`` fails fast at capacity; ``block=True`` waits until a
        drain frees space, up to ``timeout`` seconds (``None`` = forever).
        This is the engine's backpressure surface: a saturated engine makes
        producers either slow down (blocking) or shed load (QueueFull).
        """
        with self._not_full:
            if self._size_locked() >= self.maxsize:
                if not block:
                    raise QueueFull(f"queue at capacity ({self.maxsize}); retry or raise max_queue")
                has_room = lambda: self._size_locked() < self.maxsize  # noqa: E731
                if not self._not_full.wait_for(has_room, timeout=timeout):
                    raise QueueFull(f"queue still full after {timeout}s; engine saturated")
            if self.discipline == "fifo":
                self._fifo.append(entry)
            else:
                heapq.heappush(self._heap, (self._key(entry), entry.seq, entry))
            self._not_empty.notify()

    def wait_nonempty(self, timeout: Optional[float] = None) -> bool:
        """Block until at least one entry is queued (or timeout); True if so."""
        with self._not_empty:
            return self._not_empty.wait_for(lambda: self._size_locked() > 0, timeout=timeout)

    def wait_atleast(self, n: int, timeout: Optional[float] = None) -> bool:
        """Block until ``>= n`` entries are queued (or timeout); True if so.

        The scheduler's batching window: after the first request of an
        iteration lands, linger briefly for the batch to fill before
        dispatching a partial one.
        """
        with self._not_empty:
            return self._not_empty.wait_for(lambda: self._size_locked() >= n, timeout=timeout)

    def next_deadline(self) -> Optional[float]:
        """Smallest absolute deadline currently queued (``edf`` only).

        The engine's linger caps its batching window at this instant so
        waiting for a fuller batch can never itself expire the most urgent
        request.  ``None`` when no queued entry carries a deadline.
        """
        with self._lock:
            if self.discipline != "edf" or not self._heap:
                return None
            key = self._heap[0][0]
            return key if key != float("inf") else None

    def deadline_before(self, horizon: float) -> bool:
        """True iff some queued entry's deadline falls before ``horizon``.

        The peek-urgency predicate behind preemptible dispatch: between
        scan segments the engine asks "would anything queued expire before
        the in-flight work finishes?" — a cheap O(1) heap peek, never a
        pop.  Always ``False`` outside the ``edf`` discipline (no deadline
        order to consult).
        """
        nearest = self.next_deadline()
        return nearest is not None and nearest < horizon

    @property
    def popped(self) -> int:
        """Monotone count of entries ever popped (live, cancelled, expired)."""
        with self._lock:
            return self._popped

    def _pop_locked(self) -> QueueEntry:
        if self.discipline == "fifo":
            return self._fifo.popleft()
        return heapq.heappop(self._heap)[2]

    def drain(self, max_items: int) -> tuple[list[QueueEntry], list[QueueEntry], list[QueueEntry]]:
        """Atomically pop up to ``max_items`` live entries in discipline order.

        Returns ``(live, cancelled, expired)``: entries whose future was
        cancelled while queued never reach a dispatch, and — under the
        ``"edf"`` discipline — entries already past their deadline are
        fast-failed into ``expired`` instead of wasting a dispatch slot.
        Both still free queue capacity and don't count against
        ``max_items``.
        """
        live: list[QueueEntry] = []
        cancelled: list[QueueEntry] = []
        expired: list[QueueEntry] = []
        now = self._clock() if self.discipline == "edf" else 0.0
        with self._not_full:
            while self._size_locked() and len(live) < max_items:
                entry = self._pop_locked()
                if entry.future.cancelled():
                    cancelled.append(entry)
                    continue
                if (
                    self.discipline == "edf"
                    and entry.t_deadline is not None
                    and now > entry.t_deadline
                ):
                    expired.append(entry)
                    continue
                live.append(entry)
            self._popped += len(live) + len(cancelled) + len(expired)
            if live or cancelled or expired:
                self._not_full.notify_all()
        return live, cancelled, expired

    def drain_urgent(
        self, max_items: int, horizon: float
    ) -> tuple[list[QueueEntry], list[QueueEntry], list[QueueEntry]]:
        """Atomically pop only entries whose deadline falls before ``horizon``.

        The preemption drain: when a suspended scan yields at a segment
        boundary, the engine serves exactly the requests that could not
        have survived waiting for it — entries with ``t_deadline <
        horizon`` — and leaves everything else queued in discipline order
        for the normal scheduler pass.  The ``edf`` heap is deadline-
        ordered, so this is a prefix pop that stops at the first
        non-urgent entry.  Returns ``(live, cancelled, expired)`` exactly
        like :meth:`drain`; empty lists outside the ``edf`` discipline.
        """
        live: list[QueueEntry] = []
        cancelled: list[QueueEntry] = []
        expired: list[QueueEntry] = []
        if self.discipline != "edf":
            return live, cancelled, expired
        now = self._clock()
        with self._not_full:
            while self._heap and len(live) < max_items:
                key = self._heap[0][0]
                if key == float("inf") or key >= horizon:
                    break
                entry = heapq.heappop(self._heap)[2]
                if entry.future.cancelled():
                    cancelled.append(entry)
                    continue
                if entry.t_deadline is not None and now > entry.t_deadline:
                    expired.append(entry)
                    continue
                live.append(entry)
            self._popped += len(live) + len(cancelled) + len(expired)
            if live or cancelled or expired:
                self._not_full.notify_all()
        return live, cancelled, expired
