"""Reads a ``torch.profiler`` trace of the measured window: device
operations (kernels, copies, fills) and what the host was doing while the
device sat idle."""
from __future__ import annotations

import collections
import dataclasses
import re

import numpy as np

WINDOW_SPAN = "bench.window"   # the harness's span around the traffic


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces' templates and
    arguments: ``void at::native::foo<float, 4>(...)`` -> ``at::native::foo``."""
    name = re.sub(r"^void ", "", name)
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip() or name


@dataclasses.dataclass
class Trace:
    t0_ns: int
    t1_ns: int
    dev_start: np.ndarray        # device operations in the window, by start
    dev_end: np.ndarray
    dev_name: list
    host_start: list             # host operations, by start
    host_end: list
    host_name: list

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def _busy_segments(self) -> list:
        segs = []
        for s, e in zip(self.dev_start, self.dev_end):
            if segs and s <= segs[-1][1]:
                segs[-1][1] = max(segs[-1][1], e)
            else:
                segs.append([s, e])
        return segs

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return sum(e - s for s, e in self._busy_segments()) / 1e9

    def select(self, pattern: str) -> list:
        """Indices of device operations whose name ``pattern`` matches."""
        rx = re.compile(pattern)
        hit = {n: bool(rx.search(n)) for n in set(self.dev_name)}
        return [i for i, n in enumerate(self.dev_name) if hit[n]]

    def kernels(self) -> list:
        """Indices of kernels and fills (every device operation but a copy)."""
        return self.select(r"^(?!Memcpy)")

    def seconds(self, idx) -> float:
        idx = np.asarray(idx, np.int64)
        return float((self.dev_end[idx] - self.dev_start[idx]).sum()) / 1e9

    def top_ops(self, k: int = 10) -> list:
        short = {n: short_name(n) for n in set(self.dev_name)}
        by = collections.Counter()
        for s, e, n in zip(self.dev_start.tolist(), self.dev_end.tolist(),
                           self.dev_name):
            by[short[n]] += (e - s) / 1e9
        return [[n, float(v)] for n, v in by.most_common(k)]

    def idle_gaps(self, k: int = 10) -> list:
        """Idle device seconds by the innermost host operation running at
        each gap's midpoint (``"no host op"`` where none was: Python)."""
        segs = self._busy_segments()
        edges = [self.t0_ns] + [x for s in segs for x in s] + [self.t1_ns]
        gaps = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
        by = collections.Counter()
        # one sweep: host operations enter a stack of open ones in start
        # order; at each gap's midpoint the newest still open is innermost
        stack, j = [], 0
        hs, he, hn = self.host_start, self.host_end, self.host_name
        for s, e in gaps:
            mid = (s + e) // 2
            while j < len(hs) and hs[j] <= mid:
                while stack and he[stack[-1]] < hs[j]:
                    stack.pop()
                stack.append(j)
                j += 1
            while stack and he[stack[-1]] < mid:
                stack.pop()
            by[hn[stack[-1]] if stack else "no host op"] += (e - s) / 1e9
        return [[n, float(v)] for n, v in by.most_common(k)]


def collect(prof) -> Trace:
    """The window's events from a stopped ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    dev, host = [], []
    t0 = t1 = None
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns()
        e = s + ev.duration_ns()
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            dev.append((s, e, name))
        else:
            if name == WINDOW_SPAN:
                t0, t1 = s, e
            host.append((s, e, name))
    if t0 is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} span")
    dev = sorted((max(s, t0), min(e, t1), n) for s, e, n in dev
                 if e > t0 and s < t1)
    host = sorted(h for h in host if h[1] > t0 and h[0] < t1
                  and h[2] != WINDOW_SPAN)
    return Trace(t0_ns=t0, t1_ns=t1,
                 dev_start=np.array([d[0] for d in dev], np.int64),
                 dev_end=np.array([d[1] for d in dev], np.int64),
                 dev_name=[d[2] for d in dev],
                 host_start=[h[0] for h in host],
                 host_end=[h[1] for h in host],
                 host_name=[h[2] for h in host])
