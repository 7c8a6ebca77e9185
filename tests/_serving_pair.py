"""Drive the reference serving engine and the port's side by side.

Both engines get the same seeded numpy requests and a fake clock each that
the test advances in step, so every scheduling decision can be compared:
the entries each dispatch drained (by submit sequence number), the shape,
recipe and alphas of every scan, the futures' outcomes, and every counter
of ``MetricsSnapshot``.  Helpers for ``tests/test_torch_engine.py``,
``test_torch_scheduler.py``, ``test_torch_fleet.py`` and
``test_torch_preempt.py``.
"""
import dataclasses
from concurrent.futures import CancelledError

import numpy as np
import torch

from repro import serving as r_serving
from repro_torch import serving as t_serving
from test_torch_fit import port_of

RTOL, ATOL = 1e-4, 1e-5
# MetricsSnapshot fields read off a clock, not counted
TIMING_FIELDS = {"latency_p50_ms", "latency_p95_ms", "latency_mean_ms",
                 "linger_window_ms"}


class FakeClock:
    """Deterministic time source (seconds)."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def recording(engine_cls):
    """``engine_cls`` with a log of every dispatch and scan it makes.

    ``log`` holds ``("dispatch", seqs, preemptible)``, ``("scan", backend,
    shape, n_iters, alphas, n_walkers)`` and ``("resume", backend, shape,
    n_iters, alphas)``; ``scans`` the port-side ``(stack, alphas, out)`` of
    every monolithic scan, copied, for bit-for-bit checks against a direct
    call.
    """

    class Recording(engine_cls):
        def __init__(self, *args, **kwargs):
            self.log, self.scans = [], []
            super().__init__(*args, **kwargs)

        def _dispatch(self, entries, preemptible=True):
            self.log.append(("dispatch", tuple(e.seq for e in entries),
                             preemptible))
            return super()._dispatch(entries, preemptible)

        def _scan(self, vdt, stack, alphas, n_iters, backend, *,
                  n_walkers=None):
            out = super()._scan(vdt, stack, alphas, n_iters, backend,
                                n_walkers=n_walkers)
            self.log.append(("scan", backend, tuple(stack.shape),
                             int(n_iters), tuple(_host(alphas).tolist()),
                             n_walkers))
            if isinstance(out, torch.Tensor):
                self.scans.append((stack.clone(), np.array(alphas),
                                   out.clone(), backend, int(n_iters),
                                   n_walkers))
            return out

        def _scan_resume(self, vdt, carry, y0, alphas, n_iters, backend):
            self.log.append(("resume", backend, tuple(y0.shape), int(n_iters),
                             tuple(_host(alphas).tolist())))
            return super()._scan_resume(vdt, carry, y0, alphas, n_iters,
                                        backend)

    Recording.__name__ = f"Recording{engine_cls.__name__}"
    return Recording


RefEngine = recording(r_serving.PropagateEngine)
PortEngine = recording(t_serving.PropagateEngine)


def make_requests(seed, n, count, widths=(1, 2, 3, 4), alphas=(0.01, 0.05, 0.2),
                  iters=(8,), **extra):
    """``count`` seeded request recipes: dicts of ``PropagateRequest`` fields."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(count):
        c = int(rng.choice(widths))
        out.append(dict(y0=(rng.rand(n, c) > 0.7).astype(np.float32),
                        alpha=float(rng.choice(alphas)),
                        n_iters=int(rng.choice(iters)), **extra))
    return out


def outcome(fut):
    """A future's outcome: its result (numpy), or the name of its failure."""
    if fut.cancelled():
        return "cancelled"
    try:
        return _host(fut.result(timeout=0))
    except CancelledError:
        return "cancelled"
    except Exception as exc:  # noqa: BLE001 - the outcome is the exception
        return type(exc).__name__


@dataclasses.dataclass
class Pair:
    """A reference engine and a port engine fed the same traffic."""

    ref: object
    port: object
    ref_clock: FakeClock
    port_clock: FakeClock

    @classmethod
    def build(cls, ref_vdt, port_vdt=None, **kwargs):
        rc, pc = FakeClock(), FakeClock()
        port_vdt = port_of(ref_vdt) if port_vdt is None else port_vdt
        return cls(ref=RefEngine(ref_vdt, start=False, clock=rc, **kwargs),
                   port=PortEngine(port_vdt, start=False, clock=pc, **kwargs),
                   ref_clock=rc, port_clock=pc)

    def advance(self, dt: float) -> None:
        self.ref_clock.advance(dt)
        self.port_clock.advance(dt)

    def submit(self, **fields):
        """Submit one request to both; returns (ref future, port future)."""
        return (self.ref.submit(r_serving.PropagateRequest(**fields)),
                self.port.submit(t_serving.PropagateRequest(**fields)))

    def call(self, name, *args, **kwargs):
        return (getattr(self.ref, name)(*args, **kwargs),
                getattr(self.port, name)(*args, **kwargs))


def assert_same_decisions(pair: Pair) -> None:
    """Both engines made the same dispatches and scans, in the same order."""
    assert pair.port.log == pair.ref.log


def assert_metrics_equal(ref_m, port_m) -> None:
    """Every field of two ``MetricsSnapshot``s but the timing ones is equal."""
    for f in dataclasses.fields(ref_m):
        if f.name in TIMING_FIELDS:
            continue
        assert getattr(port_m, f.name) == getattr(ref_m, f.name), f.name


def assert_outcomes_close(ref_futs, port_futs) -> None:
    """Same outcome for each pair of futures; results within the LP
    tolerance."""
    assert len(ref_futs) == len(port_futs)
    for i, (rf, pf) in enumerate(zip(ref_futs, port_futs)):
        r, p = outcome(rf), outcome(pf)
        if isinstance(r, str) or isinstance(p, str):
            assert r == p, (i, r, p)
            continue
        assert p.shape == r.shape, i
        np.testing.assert_allclose(p, r, rtol=RTOL, atol=ATOL, err_msg=str(i))


def assert_scans_equal_direct_calls(engine) -> None:
    """Every monolithic scan the port engine made equals a direct batched
    ``label_propagate`` on the same padded stack, bit for bit."""
    assert engine.scans
    vdt = engine.vdt
    for stack, alphas, out, backend, n_iters, n_walkers in engine.scans:
        kw = {}
        if backend == "grf":
            kw = dict(n_walkers=n_walkers or engine.n_walkers,
                      seed=engine.grf_seed)
        direct = vdt.label_propagate(stack, alpha=alphas, n_iters=n_iters,
                                     batched=True, backend=backend, **kw)
        torch.testing.assert_close(out, direct, rtol=0, atol=0)
