"""``repro_torch/runtime/preemption.py`` ↔ ``repro/runtime/preemption.py``: a
verbatim copy (pure Python).

Preemption / failure handling for long-running training jobs.

* ``GracefulShutdown`` — converts SIGTERM/SIGINT into a flag the train loop
  polls each step; on preemption the loop writes a final checkpoint and
  exits cleanly (the scheduler restarts the job, which auto-resumes).
* ``Watchdog`` — a heartbeat thread that detects a stalled step (straggler
  or wedged collective) and invokes a callback (in production: report the
  slow host to the control plane and trigger elastic restart without it;
  here: log + optional exception for tests).
"""
from __future__ import annotations

import signal
import threading
import time
from typing import Callable, Optional

__all__ = ["GracefulShutdown", "Watchdog"]


class GracefulShutdown:
    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._stop = threading.Event()
        self._prev = {}
        for s in signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except ValueError:
                pass  # non-main thread (tests)

    def _handler(self, signum, frame):
        self._stop.set()

    @property
    def requested(self) -> bool:
        return self._stop.is_set()

    def request(self):
        """Programmatic preemption (tests)."""
        self._stop.set()


class Watchdog:
    """Fires ``on_stall`` if ``beat()`` is not called within ``timeout_s``."""

    def __init__(self, timeout_s: float,
                 on_stall: Optional[Callable[[float], None]] = None,
                 poll_s: float = 0.1):
        self.timeout_s = timeout_s
        self.on_stall = on_stall or (lambda dt: None)
        self._last = time.monotonic()
        self._stalled = threading.Event()
        self._stop = threading.Event()
        self._poll = poll_s
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def beat(self):
        self._last = time.monotonic()

    @property
    def stalled(self) -> bool:
        return self._stalled.is_set()

    def _run(self):
        while not self._stop.is_set():
            dt = time.monotonic() - self._last
            if dt > self.timeout_s and not self._stalled.is_set():
                self._stalled.set()
                self.on_stall(dt)
            time.sleep(self._poll)

    def stop(self):
        self._stop.set()
