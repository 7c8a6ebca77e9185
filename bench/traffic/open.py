"""Open-loop arrivals at the mix's fixed ``rate`` (requests/s): independent
users, each request sent when it falls due whether or not earlier ones are
answered, and timed from when it was due.

A mix names ``rate``, the label ``widths`` and ``alphas``, ``n_iters``, the
``label_share`` of rows labelled in each column, and ``check_every``.  A
window of S seconds holds M = ceil(rate x S) requests, and every seed gets
the same set of them in another order: their gaps are the M quantiles of an
exponential of mean 1/rate (Poisson arrivals), the widths and alphas equal
shares of the mix's, and every ``check_every``-th is kept for the reference.
Label matrices are windows of one seeded pool at seeded offsets, so making
one costs a comparison, not a random draw, and no two requests repeat.
"""
from __future__ import annotations

import dataclasses
import math
import queue
import threading
import time
from concurrent.futures import Future, wait
from typing import Callable, Optional

import numpy as np

from bench.seeds import subseed

POOL = 1 << 24          # uint16 entries of the label pool (32 MiB)


@dataclasses.dataclass(frozen=True)
class Spec:
    index: int
    due: float            # seconds from the window's start
    width: int
    alpha: float
    offset: int
    check: bool


@dataclasses.dataclass
class Record:
    spec: Spec
    t_due: float
    t_send: float
    t_done: float = float("nan")
    error: Optional[str] = None
    answer: Optional[np.ndarray] = None   # a copy, for checked requests

    @property
    def ok(self) -> bool:
        return self.error is None and not math.isnan(self.t_done)


class Traffic:
    """The seeded requests of one mix over N points for an S-second window."""

    def __init__(self, mix: dict, n: int, seed: int, seconds: float):
        self.mix, self.n = mix, int(n)
        if self.n * max(mix["widths"]) > POOL:
            raise ValueError(f"N={n} x width {max(mix['widths'])} exceeds "
                             f"the label pool of {POOL}")
        rate = float(mix["rate"])
        m = math.ceil(rate * seconds)
        rng = np.random.Generator(np.random.PCG64(subseed(seed, "traffic")))
        gaps = rng.permutation(-np.log1p(-(np.arange(m) + 0.5) / m) / rate)
        due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
        widths = rng.permutation(np.resize(np.asarray(mix["widths"]), m))
        alphas = rng.permutation(np.resize(np.asarray(mix["alphas"]), m))
        check = rng.permutation(np.arange(m) % int(mix["check_every"]) == 0)
        self.specs = [Spec(index=j, due=float(due[j]), width=int(widths[j]),
                           alpha=float(alphas[j]),
                           offset=int(rng.integers(0, POOL - n * widths[j]
                                                   + 1)),
                           check=bool(check[j])) for j in range(m)]
        pool_rng = np.random.Generator(np.random.PCG64(subseed(seed,
                                                               "labels")))
        self.pool = np.frombuffer(pool_rng.bytes(2 * POOL), dtype=np.uint16)
        self.threshold = int(round(float(mix["label_share"]) * 65536))

    def labels(self, spec: Spec) -> np.ndarray:
        """The request's (N, width) seed labels: 1 where labelled, else 0."""
        window = self.pool[spec.offset: spec.offset + self.n * spec.width]
        return (window < self.threshold).reshape(self.n, spec.width) \
            .astype(np.float32)


def run(traffic: Traffic, submit: Callable[[np.ndarray, Spec], Future],
        wait_s: float, t_start: float, t_end: float) -> list[Record]:
    """Send every request due before ``t_end`` when it falls due (never
    after ``t_end``: a system behind its load leaves the rest unsent), then
    wait up to ``wait_s`` for the answers.  ``submit`` hands one request to
    the system (blocking while its queue is full) and returns the future
    of its answer.  Checked answers are copied off the system's thread.
    Returns every request sent, in order."""
    records: list[Record] = []
    futures: list[Future] = []
    copies: queue.Queue = queue.Queue()

    def copier() -> None:
        while (item := copies.get()) is not None:
            rec, answer = item
            rec.answer = np.array(answer, dtype=np.float32)

    def done(rec: Record, fut: Future) -> None:
        rec.t_done = time.perf_counter()
        exc = fut.exception()
        if exc is not None:
            rec.error = f"{type(exc).__name__}: {exc}"
        elif rec.spec.check:
            copies.put((rec, fut.result()))

    thread = threading.Thread(target=copier, daemon=True)
    thread.start()
    y0 = None
    for spec in traffic.specs:
        t_due = t_start + spec.due
        if t_due >= t_end:
            break
        y0 = traffic.labels(spec) if y0 is None else y0
        while (ahead := t_due - time.perf_counter()) > 0:
            time.sleep(ahead)
        t_send = time.perf_counter()
        if t_send >= t_end:
            break
        rec = Record(spec=spec, t_due=t_due, t_send=t_send)
        records.append(rec)
        try:
            fut = submit(y0, spec)
        except Exception as exc:   # a refused request is counted, not fatal
            rec.t_done = time.perf_counter()
            rec.error = f"{type(exc).__name__}: {exc}"
        else:
            futures.append(fut)
            fut.add_done_callback(lambda f, rec=rec: done(rec, f))
        y0 = None
    wait(futures, timeout=wait_s)
    copies.put(None)
    thread.join()
    return records
