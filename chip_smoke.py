#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. device and build: the card's name and power limit, and K1 (the fused
   exact label-propagation step, ``csrc/folded_lp.cu``) built with ``nvcc``
   for ``sm_90a`` from the checkout's sources, with ``-Xptxas -v`` lines;
2. K1 against its plain-torch version on the card at small shapes: one
   step, a 5-step scan, a ``row_base`` stripe, and resume-from-carry equal to
   the monolithic scan bit for bit;
3. the main path, at the scale of the paper's SecStr benchmark
   (``secstr_like(83_679, 315, seed=3)``, ``|B| = 4N``): ``fit`` on the card,
   VDT label propagation (one request and a batch of 8 with per-request
   alpha), and the exact backend through K1 for 10 iterations each;
4. checks after the main path: VDT results against the same calls on a CPU
   copy of the fitted model, the exact backend's first 2 iterations against
   the plain version on the card, and K1's time per launch beside its bound.

Prints the card (``nvidia-smi``), one JSON line with the kernel table, and
as its last line ``{"ok": true, "device": {...}}``.  Tolerance everywhere:
``rtol=1e-4, atol=1e-5``, the reference package's own LP tolerance.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
RTOL, ATOL = 1e-4, 1e-5
# NVIDIA H100 SXM data sheet, at the 700 W power limit
PEAK_FP32_FLOPS = 67e12      # float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12
N_SECSTR, D_SECSTR = 83_679, 315
VDT_ITERS, EXACT_ITERS, BATCH = 50, 10, 8


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def close(got, want, what: str) -> tuple[float, float]:
    """Hold ``got`` to ``want`` at RTOL/ATOL; returns (max abs, max rel) error."""
    import torch

    got, want = got.double().cpu(), want.double().cpu()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    err = (got - want).abs()
    rel = float((err / want.abs().clamp_min(1e-30)).max())
    ok = bool((err <= ATOL + RTOL * want.abs()).all())
    print(f"  {what}: max_abs_err={float(err.max()):.3e} max_rel_err={rel:.3e}"
          f" {'ok' if ok else 'MISMATCH'}")
    check(ok, f"{what}: outside rtol={RTOL}, atol={ATOL}")
    return float(err.max()), rel


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` in ms over ``reps`` runs, after a warm-up."""
    import torch

    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_build():
    from repro_torch.kernels.fused_lp import kernel_library

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    t0 = time.perf_counter()
    built = kernel_library()
    print(f"[build] K1 {built.path.name}: nvcc {built.build_seconds:.2f} s, "
          f"load {time.perf_counter() - t0:.2f} s")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip())


def phase_kernel_small():
    import torch
    from repro_torch.kernels.fused_lp import (alpha_row, folded_step,
                                              folded_step_plain,
                                              fused_lp_scan_batched_ref,
                                              fused_lp_scan_folded,
                                              fused_lp_scan_folded_resume)

    print("[K1 vs plain, small shapes]")
    g = torch.Generator().manual_seed(0)
    for n, d, k, per_col in ((1_000, 315, 2, False), (4_099, 64, 16, True),
                             (257, 8, 300, True)):
        x = torch.randn(n, d, generator=g).cuda()
        y0 = torch.rand(n, k, generator=g).cuda()
        alpha = (torch.rand(k, generator=g) if per_col else 0.3)
        al = alpha_row(alpha, k, "cuda")
        sigma = d ** 0.5
        inv = 1.0 / (2.0 * sigma * sigma)
        close(folded_step(x, x, y0, y0, al, inv),
              folded_step_plain(x, x, y0, y0, al, inv),
              f"step  N={n} d={d} K={k}")
        want = y0
        for _ in range(5):
            want = folded_step_plain(x, x, want, y0, al, inv)
        scan = fused_lp_scan_folded(x, y0, sigma, al, 5)
        close(scan, want, f"scan5 N={n} d={d} K={k}")
        if n <= 1_000:  # the dense eq.-3 oracle, P materialized
            dense = fused_lp_scan_batched_ref(x, y0[None], sigma,
                                              al.reshape(1, 1, k), 5)[0]
            close(scan, dense,
                  f"scan5 vs dense oracle N={n} K={k}")
        resumed = fused_lp_scan_folded_resume(
            x, fused_lp_scan_folded(x, y0, sigma, al, 2), y0, sigma, al, 3)
        check(torch.equal(resumed, scan), "resume-from-carry != monolithic scan")
        print(f"  resume(2+3) == scan(5) bit for bit, N={n} K={k}")
    x = torch.randn(300, 16, generator=g).cuda()
    y = torch.rand(300, 5, generator=g).cuda()
    al = alpha_row(torch.rand(5, generator=g), 5, "cuda")
    rows, y0 = x[37:181].contiguous(), y[37:181].contiguous()
    close(folded_step(rows, x, y, y0, al, 0.05, row_base=37),
          folded_step_plain(rows, x, y, y0, al, 0.05, row_base=37),
          "step  row_base=37 M=144 N=300 K=5")


def phase_main(data):
    """The port's main path; returns what the later checks need."""
    import torch
    from repro_torch import VariationalDualTree, ccr, one_hot_labels
    from repro_torch.kernels.fused_lp import folded_step

    x, labels = data.x, data.labels
    n = x.shape[0]
    rng = np.random.RandomState(11)
    masks = [rng.rand(n) < 0.10 for _ in range(BATCH)]
    y0 = one_hot_labels(labels, masks[0], data.n_classes)
    y0s = torch.stack([one_hot_labels(labels, m, data.n_classes) for m in masks])
    alphas = torch.linspace(0.005, 0.05, BATCH)
    out = dict(masks=masks, y0=y0, y0s=y0s, alphas=alphas)

    print(f"[fit] secstr_like N={n} d={x.shape[1]} |B|=4N on the card")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    vdt = VariationalDualTree.fit(x, max_blocks=4 * n, refine_batch=512,
                                  sigma_iters=3)
    torch.cuda.synchronize()
    s = vdt.stats
    print(f"  total {time.perf_counter() - t0:.2f} s: build_tree {s.build_tree_s:.2f} s,"
          f" sigma+q {s.init_qopt_s:.2f} s ({s.sigma_iters} sigma iters),"
          f" refine {s.refine_s:.2f} s; n_blocks={vdt.n_blocks} sigma={s.sigma:.6f}"
          f" bound={s.bound:.6e}; max_memory_allocated="
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(vdt.device.type == "cuda", "fit did not run on the card")
    check(np.isfinite(s.bound) and vdt.n_blocks >= 4 * n, "fit: bad state")
    out["vdt"] = vdt

    print(f"[vdt LP] alpha=0.01, {VDT_ITERS} iterations, 10% labeled")
    for name, seed, alpha in (("single", y0, 0.01), ("batch8", y0s, alphas)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = vdt.label_propagate(seed, alpha=alpha, n_iters=VDT_ITERS)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        check(bool(torch.isfinite(res).all()), f"vdt {name}: non-finite")
        check(tuple(res.shape) == tuple(seed.shape), f"vdt {name}: bad shape")
        out[f"vdt_{name}"] = res
        first = res if res.ndim == 2 else res[0]
        print(f"  {name}: {ms:.1f} ms per call, CCR on unlabeled rows "
              f"{ccr(first, labels, ~masks[0]):.4f}")

    print(f"[exact LP through K1] {EXACT_ITERS} iterations at N={n}")
    for name, seed, alpha in (("single", y0, 0.01), ("batch8", y0s, alphas)):
        before = folded_step.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = vdt.label_propagate(seed, alpha=alpha, n_iters=EXACT_ITERS,
                                  backend="exact")
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        runs = folded_step.launches - before
        check(runs == EXACT_ITERS, f"exact {name}: {runs} K1 launches for "
                                   f"{EXACT_ITERS} iterations")
        check(bool(torch.isfinite(res).all()), f"exact {name}: non-finite")
        out[f"exact_{name}"] = res
        flops = 2.0 * n * n * x.shape[1]
        agree = float((res.argmax(-1) == out[f"vdt_{name}"].argmax(-1))
                      .float().mean())
        first = res if res.ndim == 2 else res[0]
        print(f"  {name} (K={seed.shape[-1] * (BATCH if seed.ndim == 3 else 1)}):"
              f" {sec / EXACT_ITERS * 1e3:.1f} ms per iteration, K1 launches"
              f" {runs}, {flops / (sec / EXACT_ITERS) / 1e12:.2f} TFLOP/s of the"
              f" 2*N^2*d distance work, argmax agreement with vdt {agree:.4f},"
              f" CCR {ccr(first, labels, ~masks[0]):.4f}")
    return out


def phase_after(data, out) -> dict:
    import torch
    from repro_torch.kernels.fused_lp import (alpha_row, folded_step,
                                              folded_step_plain)

    vdt = out["vdt"]
    print("[vdt LP on the card vs a CPU copy of the fitted model]")
    cpu = vdt.to("cpu")
    close(out["vdt_single"], cpu.label_propagate(out["y0"].cpu(), alpha=0.01,
                                                 n_iters=VDT_ITERS), "single")
    close(out["vdt_batch8"], cpu.label_propagate(out["y0s"].cpu(),
                                                 alpha=out["alphas"],
                                                 n_iters=VDT_ITERS), "batch8")

    print("[exact LP: first 2 iterations, K1 vs plain on the card]")
    x = vdt.x_rows
    sigma = float(vdt.sigma)
    inv = float(1.0 / (2.0 * sigma * sigma))
    errs, shapes = [], {}
    for name, seed, alpha in (("single", out["y0"], 0.01),
                              ("batch8", out["y0s"], out["alphas"])):
        k_seed = seed if seed.ndim == 2 else seed.movedim(0, 1).reshape(
            seed.shape[1], -1).contiguous()
        al = alpha if seed.ndim == 2 else torch.as_tensor(alpha).repeat_interleave(
            seed.shape[-1])
        al = alpha_row(al, k_seed.shape[1], "cuda")
        got = vdt.label_propagate(seed, alpha=alpha, n_iters=2, backend="exact")
        got = got if got.ndim == 2 else got.movedim(0, 1).reshape(k_seed.shape)
        want = k_seed
        for _ in range(2):
            want = folded_step_plain(x, x, want, k_seed, al, inv)
        errs.append(close(got, want, f"{name} K={k_seed.shape[1]}")[0])
        shapes[name] = (k_seed, al)

    print("[K1 timing at the main path's shapes]")
    n, d = x.shape
    rows = []
    for name in ("single", "batch8"):
        k_seed, al = shapes[name]
        k = k_seed.shape[1]
        ms = cuda_ms(lambda: folded_step(x, x, k_seed, k_seed, al, inv), 3)
        plain_ms = cuda_ms(lambda: folded_step_plain(x, x, k_seed, k_seed, al, inv), 1)
        flops = 2.0 * n * n * d + 2.0 * n * n * k
        nbytes = 4.0 * (n * d + 3 * n * k + k)   # x, y, y0, alpha in; out
        bound_ms = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
        by = "operations" if flops / PEAK_FP32_FLOPS >= nbytes / PEAK_HBM_BYTES \
            else "bytes"
        print(f"  K={k}: K1 {ms:.2f} ms per launch, plain {plain_ms:.2f} ms, "
              f"bound {bound_ms:.2f} ms ({by}), {bound_ms / ms:.3f} of the bound")
        rows.append(dict(k=k, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, by=by))
    return dict(max_abs_err=max(errs), rows=rows)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one card",
              file=sys.stderr)
        return 2
    if not (REPO / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {REPO / 'src' / 'repro_torch'} is missing; run from "
              "a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.data.synthetic import secstr_like
    from repro_torch.kernels.fused_lp import folded_step

    t_start = time.perf_counter()
    phase_build()
    phase_kernel_small()
    data = secstr_like(N_SECSTR, D_SECSTR, seed=3)

    folded_step.launches = 0
    out = phase_main(data)
    launches = folded_step.launches
    check(launches == 2 * EXACT_ITERS,
          f"main path launched K1 {launches} times, expected {2 * EXACT_ITERS}")
    after = phase_after(data, out)

    single = after["rows"][0]
    kernels = [dict(
        name="K1 folded fused LP step", route="cuda",
        source="src/repro_torch/kernels/fused_lp/csrc/folded_lp.cu",
        replaces="src/repro/kernels/fused_lp/batched.py:231",
        launches=launches, max_abs_err=after["max_abs_err"],
        ms=single["ms"], plain_ms=single["plain_ms"],
        bound_ms=single["bound_ms"], bound_by=single["by"], library_ms=None,
        shape=f"N={N_SECSTR} d={D_SECSTR} K={single['k']}",
        batch8_ms=after["rows"][1]["ms"])]
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
