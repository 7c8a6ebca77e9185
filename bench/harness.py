"""One run of one cell: set-up, the measured window, the cell's metrics,
and the comparison of the served answers with the plain reference."""
from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Optional

import numpy as np
import torch

from bench import compare, devtrace
from bench.layout import Cell, Layout
from bench.reference import bregman
from bench.seeds import subseed

JAX_NAMES = ("jax", "jaxlib", "flax", "repro")
ANSWER_WAIT_S = 120.0      # an answer may come this long after it was sent


@dataclasses.dataclass
class Run:
    """What the metric readers (``metrics/<name>.py``) read."""

    cell: Cell
    seconds: float             # the measured window
    t_end: float               # its close (host clock)
    setup_s: float
    fit_s: float
    fit_stats: object          # the program's VdtStats
    n: int
    d: int
    n_blocks: int              # active blocks of the fitted model
    integer_points: bool       # int8-exact squared distances (small integers)
    records: list
    before: object             # engine MetricsSnapshot at the window's start
    after: object              # ... once every answer of the window is in
    trace: Optional[devtrace.Trace] = None


def foreign_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in JAX_NAMES)


def points(layout: Layout, config: dict, seed: int, device) -> torch.Tensor:
    """The configuration's one data set (drawn from its own ``seed``, as a
    real data set is one), its rows in an order drawn from the run's seed.
    Raises ``ValueError`` if the references cannot check the configuration's
    divergence on it (``reference/bregman.py::require``)."""
    data = dict(config["data"])
    make = layout.module("data", data.pop("generator")).make
    base = torch.Generator(device=device).manual_seed(int(data.pop("seed")))
    x = make(base, device, **data)
    bregman.require(config, x)
    order = torch.Generator(device=device).manual_seed(subseed(seed, "rows"))
    return x[torch.randperm(x.shape[0], generator=order, device=device)]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fit_model(config: dict, x: torch.Tensor, device: torch.device):
    """The program's ``VariationalDualTree`` fitted to ``x`` as the
    configuration states; returns it and the fit's seconds (host clock,
    the device synchronised on both sides)."""
    from torch.profiler import record_function

    from repro_torch.core.vdt import VariationalDualTree

    fit = config["fit"]
    _sync(device)
    t0 = time.perf_counter()
    with record_function("bench.fit"):
        vdt = VariationalDualTree.fit(
            x.clone(), max_blocks=int(fit["blocks_per_point"]) * x.shape[0],
            refine_batch=int(fit["refine_batch"]),
            sigma_iters=int(fit["sigma_iters"]),
            divergence=fit["divergence"], device=str(device))
    _sync(device)
    return vdt, time.perf_counter() - t0


def followed(vdt, device: torch.device) -> dict:
    """The fit's choices the reference follows (``reference/vdt.py``)."""
    bp = vdt.bp
    live = np.asarray(bp.active[: bp.n], bool)
    ids = lambda arr: torch.as_tensor(np.asarray(arr[: bp.n])[live],
                                      dtype=torch.int64, device=device)
    return {"leaf_of": vdt.tree.leaf_of.to(device, torch.int64).clone(),
            "a": ids(bp.a), "b": ids(bp.b), "sigma": float(vdt.sigma),
            "n_active": int(live.sum()), "L": int(vdt.tree.L)}


def _check(layout: Layout, cell: Cell, x: torch.Tensor, fitted: dict,
           traffic, records: list, control: bool = False) -> dict:
    """Every number compared: the reference's fit checks, the served
    answers' largest error, and requests that failed or never came.  With
    ``control``, also ``control``: the answers' and sigma's errors of the
    reference in its control precision put in the program's place."""
    mix, cfg = cell.mix, cell.config
    ref = layout.module("reference", mix["backend"])
    out = dict(ref.checks(x, fitted, cfg))
    if control:
        out["control"] = {"sigma_err": ref.control_sigma_err(x, fitted, cfg)}
    samples = [r for r in records if r.ok and r.answer is not None]
    out["failed"] = float(sum(not r.ok for r in records))
    if not samples:
        out["answer_err"] = float("inf")
        return out
    dev = x.device
    y0 = torch.cat([torch.as_tensor(traffic.labels(r.spec)) for r in samples],
                   1).to(dev, torch.float64)
    alpha = torch.tensor([r.spec.alpha for r in samples
                          for _ in range(r.spec.width)], dtype=torch.float64,
                         device=dev)
    want = ref.answers(x, fitted, cfg, y0, alpha, int(mix["n_iters"]))
    lows = (ref.answers(x, fitted, cfg, y0, alpha, int(mix["n_iters"]),
                        precision=ref.CONTROL) if control else None)
    worst = low = 0.0
    lo = 0
    for r in samples:
        cols = slice(lo, lo + r.spec.width)
        lo += r.spec.width
        served = torch.as_tensor(r.answer).to(dev)
        worst = max(worst, compare.answer_err(served, want[:, cols],
                                              y0[:, cols]))
        if lows is not None:
            low = max(low, compare.answer_err(lows[:, cols], want[:, cols],
                                              y0[:, cols]))
    out["answer_err"] = worst
    if lows is not None:
        out["control"]["answer_err"] = low
    return out


def run_cell(layout: Layout, workload: str, seed: int, seconds: float,
             trace: bool, device, t_proc: Optional[float] = None,
             control: bool = False):
    """Run ``workload`` once; returns ``(result, checks)``: the result's
    JSON object (``checks`` last) and ``{name: (value, limit)}``.  With
    ``control`` (``bench/control.py``, never the benchmark's own runs) the
    result also holds ``control``: the control's reading."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.serving import PropagateEngine, PropagateRequest

    t_proc = time.perf_counter() if t_proc is None else t_proc
    device = torch.device(device)
    cell = layout.cell(workload)
    cfg, mix = cell.config, cell.mix
    x = points(layout, cfg, seed, device)
    n, d = x.shape
    # int8 prices a distance only where its cross term is a product of the
    # small integers themselves: a Bregman cross term takes log x or 1 / x
    integer_points = bool(cfg["fit"]["divergence"] == "sqeuclidean"
                          and torch.equal(x, x.round())
                          and float(x.abs().max()) <= 127)

    vdt, fit_s = fit_model(cfg, x, device)

    backend, n_iters = mix["backend"], int(mix["n_iters"])
    engine = PropagateEngine(vdt, backend=backend, **mix["engine"])
    t_warm = time.perf_counter()
    engine.warmup(widths=mix["widths"], n_iters=(n_iters,),
                  backends=(backend,))
    warm_s = time.perf_counter() - t_warm
    loop = layout.module("traffic", mix["loop"])
    traffic = loop.Traffic(mix, n, seed, seconds)

    def submit(y0, spec):
        return engine.submit(PropagateRequest(
            y0, alpha=spec.alpha, n_iters=n_iters, backend=backend))

    prof = None
    if trace:
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
    span = record_function(devtrace.WINDOW_SPAN)
    span.__enter__()
    _sync(device)
    before = engine.metrics()
    t_start = time.perf_counter()
    setup_s = t_start - t_proc
    records = loop.run(traffic, submit, ANSWER_WAIT_S, t_start,
                       t_start + seconds)
    _sync(device)
    after = engine.metrics()
    span.__exit__(None, None, None)
    if prof is not None:
        prof.stop()
    engine.shutdown(wait=True)

    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else device.type),
                "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                    device)) if device.type == "cuda" else 0}
    run = Run(cell=cell, seconds=float(seconds), t_end=t_start + seconds,
              setup_s=setup_s, fit_s=fit_s,
              fit_stats=vdt.stats, n=n, d=d, n_blocks=int(vdt.bp.n_active),
              integer_points=integer_points, records=records, before=before,
              after=after)
    breakdown = None
    if prof is not None:
        run.trace = devtrace.collect(prof)
        del prof
        dev_info["busy_s"] = run.trace.busy_s
        dev_info["window_s"] = run.trace.window_s
        breakdown = {"device_ops": run.trace.top_ops(),
                     "idle_gaps": run.trace.idle_gaps()}

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = layout.module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    fitted = followed(vdt, device)
    del engine, vdt, run
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    values = _check(layout, cell, x, fitted, traffic, records, control)
    _sync(device)
    late = [r.t_send - r.t_due for r in records]
    print(f"bench: {workload} seed {seed}: set-up {setup_s:.2f} s (fit "
          f"{fit_s:.2f}, warm-up {warm_s:.2f}), window {seconds:g} s, "
          f"{len(records)} requests sent, sent late by "
          f"{1e3 * float(np.percentile(late, 95)) if late else 0.0:.1f} ms "
          f"at the 95th percentile, reference "
          f"{time.perf_counter() - t_ref:.2f} s", file=sys.stderr)
    control_reading = values.pop("control", None)
    if set(values) != set(cell.limits):
        raise KeyError(f"checks {sorted(values)} against limits "
                       f"{sorted(cell.limits)}")
    checks = {k: (values[k], float(cell.limits[k])) for k in sorted(values)}
    result = {"correct": all(v <= lim for v, lim in checks.values()),
              "attempted": len(records),
              "failed": sum(not r.ok for r in records),
              "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    if control_reading is not None:
        result["control"] = control_reading
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result, checks
