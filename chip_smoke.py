#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. device and build: the card's name and power limit, and the three kernel
   sources built at once with ``nvcc`` for ``sm_90a`` from the checkout
   (``fused_lp/csrc/folded_lp.cu``: K1 the folded exact LP step, K2 ``P @ Y``,
   K3 the per-batch-recompute step; ``pairwise/csrc/pairwise.cu``: K4;
   ``grf/csrc/grf_feature.cu``: K5 the GRF walker-mean feature product),
   with their ``-Xptxas -v`` lines;
2. K1 against its plain-torch version on the card at small shapes: one
   step, a 5-step scan, a ``row_base`` stripe, and resume-from-carry equal to
   the monolithic scan bit for bit; K5 likewise, and a K = 16 column's bits
   equal to a K = 2 call's;
3. the main path, at the scale of the paper's SecStr benchmark
   (``secstr_like(83_679, 315, seed=3)``, ``|B| = 4N``): ``fit`` on the card,
   VDT label propagation (one request and a batch of 8 with per-request
   alpha), and the exact backend through K1 for 10 iterations each;
4. checks after the main path: VDT results against the same calls on a CPU
   copy of the fitted model, the exact backend's first 2 iterations against
   the plain version on the card, and K1's time per launch beside its bound;
5. the GRF path at the same scale: the paper's k = 4 kNN graph
   (``core.baselines.build_knn_graph``) built on the card and walked by
   ``grf_label_propagate`` for 50 iterations with 64 and 400 walkers a point
   (5.36 M and 33.5 M walkers), one request and a batch of 8, every step
   through K5; held to the deterministic kNN walk, batched == solo and
   repeat == first bit for bit; then K5's time at those shapes;
6. the VDT entry point ``label_propagate(backend="grf")`` at validation size
   (``secstr_like(4_096, 315)``, dense ``grf_graph`` bridge) against
   ``backend="exact"``;
7. the reference's remaining op entry points, each at its shape: K2
   (``fused_lp_matvec``, N = 83,679), K3 (``fused_lp_step_batched(
   reuse=False)``, B = 8, N = 16,384), K4 (``pairwise_sq_dists``, one kNN
   block 2,048 x 83,679), against their plain versions and timed; and one
   point (N = 1, every column masked) through K1, K2 and K3.

Each path runs with every launch counter set to 0 just before and read just
after.  Prints the card (``nvidia-smi``), one JSON line with the kernel
table, and as its last line ``{"ok": true, "device": {...}}``.  Tolerance:
``rtol=1e-4, atol=1e-5``, the reference package's own LP tolerance, for
K1-K4 (``5e-2`` for K4 on bfloat16, as the reference's test); ``rtol=1e-5,
atol=1e-6`` for K5, as the reference's ``test_feature_kernel_matches_ref``.
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
K5_RTOL, K5_ATOL = 1e-5, 1e-6
KNN_K = 4                       # |B| / N = 4: the paper's kNN equivalent
GRF_ITERS, GRF_SEED = 50, 0
N_VALIDATE, VDT_GRF_ITERS, VDT_GRF_WALKERS = 4_096, 20, 128
K3_BATCH, K3_N, K4_ROWS = 8, 16_384, 2_048


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def close(got, want, what: str, rtol: float = RTOL,
          atol: float = ATOL) -> tuple[float, float]:
    """Hold ``got`` to ``want`` at rtol/atol; returns (max abs, max rel) error."""
    import torch

    got, want = got.double().cpu(), want.double().cpu()
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} != "
                                   f"{tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    err = (got - want).abs()
    rel = float((err / want.abs().clamp_min(1e-30)).max())
    ok = bool((err <= atol + rtol * want.abs()).all())
    print(f"  {what}: max_abs_err={float(err.max()):.3e} max_rel_err={rel:.3e}"
          f" {'ok' if ok else 'MISMATCH'}")
    check(ok, f"{what}: outside rtol={rtol}, atol={atol}")
    return float(err.max()), rel


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """Least time on the card in ms, and what sets it (H100 SXM peaks)."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes \
        else "bytes"


def counters():
    """The launch counters of every kernel wrapper, by kernel."""
    from repro_torch.kernels.fused_lp import folded_step, matvec_step, \
        perbatch_step
    from repro_torch.kernels.grf import grf_feature_matvec
    from repro_torch.kernels.pairwise import pairwise_sq_dists

    return {"K1": folded_step, "K2": matvec_step, "K3": perbatch_step,
            "K4": pairwise_sq_dists, "K5": grf_feature_matvec}


def reset_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {k: fn.launches for k, fn in counters().items()}


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


def graph_ms(fn, reps: int) -> float:
    """Device time of ``fn()`` in ms: ``reps`` calls captured in one CUDA graph,
    replayed once as a warm-up and once timed, so no host launch cost is in
    it.  For calls shorter than their Python launch path."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.fused_lp import kernel_library as lib_k123
    from repro_torch.kernels.grf.ops import kernel_library as lib_k5
    from repro_torch.kernels.pairwise.ops import kernel_library as lib_k4

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    t0 = time.perf_counter()
    names = ("K1-K3", "K4", "K5")
    # one nvcc per source, all started together
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(lambda f: f(), (lib_k123, lib_k4, lib_k5)))
    print(f"[build] {time.perf_counter() - t0:.2f} s for all sources")
    for name, lib in zip(names, built):
        print(f"  {name} {lib.path.name}: nvcc {lib.build_seconds:.2f} s")
        for line in lib.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("    " + line.strip())


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


def phase_k5_small():
    import torch
    from repro_torch.kernels.grf import (grf_feature_matvec,
                                         grf_feature_matvec_ref,
                                         grf_feature_plain)

    print("[K5 vs plain, small shapes]")
    g = torch.Generator().manual_seed(1)
    for s, m, n, k in ((24, 16, 24, 2), (1_000, 64, 1_000, 16),
                       (4_099, 7, 3_000, 300), (300, 400, 500, 3)):
        pos = torch.randint(0, n, (s, m), generator=g,
                            dtype=torch.int32).cuda()
        load = torch.rand(s, m, generator=g).cuda()
        y = torch.randn(n, k, generator=g).cuda()
        got = grf_feature_matvec(pos, load, y)
        close(got, grf_feature_plain(pos, load, y), f"S={s} m={m} N={n} K={k}",
              K5_RTOL, K5_ATOL)
        close(got, grf_feature_matvec_ref(pos, load, y),
              f"S={s} m={m} N={n} K={k} vs gather oracle", K5_RTOL, K5_ATOL)
        if k == 16:
            two = grf_feature_matvec(pos, load, y[:, 3:5].contiguous())
            check(torch.equal(got[:, 3:5], two),
                  "K5: a K=16 column differs from the K=2 call's")
            print("  K=16 columns 3:5 == K=2 call bit for bit")


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


def phase_knn(data, sigma: float):
    """The paper's k = 4 kNN graph of the SecStr-scale points, as a CSR graph."""
    import torch
    from repro_torch.core.baselines import build_knn_graph
    from repro_torch.core.grf import CSRGraph
    from repro_torch.core.label_prop import route_backend

    x = torch.as_tensor(data.x, device="cuda")
    n = x.shape[0]
    print(f"[knn graph] k={KNN_K} sigma={sigma:.6f} N={n}: "
          f"{-(-n // 2048)} blocks of 2048 x {n} distances")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    knn = build_knn_graph(x, KNN_K, sigma)
    torch.cuda.synchronize()
    t_knn = time.perf_counter() - t0
    check(bool(torch.isfinite(knn.weights).all()), "knn: non-finite weights")
    check(not bool((knn.indices == torch.arange(n, device="cuda")[:, None])
                   .any()), "knn: a self edge")
    t0 = time.perf_counter()
    graph = CSRGraph.from_csr(np.arange(n + 1) * KNN_K,
                              knn.indices.reshape(-1),
                              knn.weights.reshape(-1), device="cuda")
    t_csr = time.perf_counter() - t0
    routed = route_backend("auto", n=n, density=graph.density, rtol=0.05)
    print(f"  build_knn_graph {t_knn:.2f} s ({2.0 * n * n * x.shape[1] / 1e12:.2f}"
          f" TFLOP of f32 product), CSRGraph.from_csr {t_csr:.2f} s: "
          f"{graph.nnz} edges, density {graph.density:.3e}; auto routes to "
          f"{routed!r}")
    check(graph.nnz == KNN_K * n and graph.device.type == "cuda", "bad graph")
    check(routed == "grf", f"auto routed the kNN graph to {routed!r}")
    return knn, graph


def phase_grf(out, knn, graph) -> None:
    """GRF label propagation over the kNN graph at full N; K5 every step."""
    import torch
    from repro_torch.core.baselines import knn_matvec
    from repro_torch.core.grf import (DEFAULT_N_WALKERS, grf_label_propagate,
                                      walkers_for_rtol)
    from repro_torch.core.label_prop import label_propagate
    from repro_torch.kernels.grf import grf_feature_matvec

    n = graph.n
    y0, y0s, alphas = out["y0"], out["y0s"], out["alphas"]
    truth = {a: label_propagate(lambda y: knn_matvec(knn, y), y0, a,
                                GRF_ITERS) for a in (0.01, 0.5)}

    def run(seed_labels, alpha, m):
        before = grf_feature_matvec.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = grf_label_propagate(graph, seed_labels, alpha=alpha,
                                  n_iters=GRF_ITERS, n_walkers=m,
                                  seed=GRF_SEED)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        runs = grf_feature_matvec.launches - before
        check(runs == GRF_ITERS, f"grf: {runs} K5 launches for {GRF_ITERS} "
                                 f"iterations")
        check(tuple(res.shape) == tuple(seed_labels.shape)
              and bool(torch.isfinite(res).all()), "grf: bad output")
        return res, ms

    rms = {}
    for m in (DEFAULT_N_WALKERS, walkers_for_rtol(0.05)):
        print(f"[grf LP] kNN graph, {GRF_ITERS} iterations, n_walkers={m} "
              f"({n * m} walkers), 10% labeled")
        torch.cuda.reset_peak_memory_stats()
        single, ms = run(y0, 0.01, m)
        again, _ = run(y0, 0.01, m)
        check(torch.equal(single, again), "grf: a repeated call differs")
        batch, ms_b = run(y0s, alphas, m)
        for b in range(BATCH):
            solo, _ = run(y0s[b], float(alphas[b]), m)
            check(torch.equal(batch[b], solo),
                  f"grf: batched[{b}] differs from its solo call")
        half, ms_h = run(y0, 0.5, m)
        print(f"  single {ms:.1f} ms per call, batch8 {ms_b:.1f} ms, "
              f"alpha=0.5 {ms_h:.1f} ms; repeat == first and batched[b] == "
              f"solo b bit for bit; max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        for a, est in ((0.01, single), (0.5, half)):
            err = (est - truth[a]).double()
            r = float(err.pow(2).mean().sqrt())
            agree = float((est.argmax(-1) == truth[a].argmax(-1)).float()
                          .mean())
            print(f"  alpha={a}: vs the kNN eq.-15 walk rms_err={r:.3e} "
                  f"max_err={float(err.abs().max()):.3e} argmax agreement "
                  f"{agree:.4f}")
            rms[(m, a)] = r
    ratio = rms[(64, 0.5)] / rms[(400, 0.5)]
    print(f"  rms error ratio 64 / 400 walkers at alpha=0.5: {ratio:.3f} "
          f"(CLT: sqrt(400/64) = 2.5)")
    check(ratio >= 2.0, f"grf error did not shrink with walkers: {ratio:.3f}")


def phase_k5_timing(graph, out) -> dict:
    """K5 at the GRF path's shapes, against its plain version and a library call."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.matvec import fold_batch
    from repro_torch.kernels.grf import (default_draw, grf_feature_matvec,
                                         grf_feature_plain, walk_step)
    from repro_torch.kernels.grf.walkers import start_state

    print("[K5 at the GRF path's shapes: walkers after 3 steps]")
    n, rows = graph.n, []
    for m in (64, 400):
        pos, load, alive = start_state(n, m, graph.device)
        draw = default_draw(7, n * m, graph.device)
        for t in range(1, 4):
            pos, load, alive = walk_step(graph.nbr, graph.prob, graph.deg, pos,
                                         load, alive, draw(t))
        pos, load = pos.view(n, m), load.view(n, m)
        for y in (out["y0"], fold_batch(out["y0s"]).contiguous()):
            k = y.shape[1]
            got = grf_feature_matvec(pos, load, y)
            err = close(got, grf_feature_plain(pos, load, y),
                        f"S={n} m={m} K={k}", K5_RTOL, K5_ATOL)[0]
            call_ms = cuda_ms(lambda: grf_feature_matvec(pos, load, y), 20)
            ms = graph_ms(lambda: grf_feature_matvec(pos, load, y), 20)
            plain_ms = graph_ms(lambda: grf_feature_plain(pos, load, y), 3)
            lib_ms = graph_ms(lambda: F.embedding_bag(
                pos, y, per_sample_weights=load, mode="sum"), 20)
            bound_ms, by = bound(2.0 * n * m * k,
                                 n * m * 8.0 + n * k * 4.0 + n * k * 4.0)
            print(f"  m={m} K={k}: K5 {ms:.4f} ms on the device ({call_ms:.4f}"
                  f" ms per call with its host launch path), plain "
                  f"{plain_ms:.3f} ms, embedding_bag {lib_ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({by}), {bound_ms / ms:.3f} of the bound")
            rows.append(dict(m=m, k=k, ms=ms, call_ms=call_ms,
                             plain_ms=plain_ms, lib_ms=lib_ms,
                             bound_ms=bound_ms, by=by, err=err))
    return dict(rows=rows, max_abs_err=max(r["err"] for r in rows))


def phase_vdt_grf() -> None:
    """``label_propagate(backend="grf")`` through the VDT entry point."""
    import torch
    from repro_torch import VariationalDualTree, one_hot_labels
    from repro_torch.data.synthetic import secstr_like

    data = secstr_like(N_VALIDATE, D_SECSTR, seed=3)
    n = N_VALIDATE
    vdt = VariationalDualTree.fit(data.x, max_blocks=4 * n, refine_batch=512,
                                  sigma_iters=3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph = vdt.grf_graph()
    print(f"[vdt grf] secstr_like N={n}: fit on the card, sigma="
          f"{float(vdt.sigma):.6f}; grf_graph (dense eq.-3 bridge) "
          f"{time.perf_counter() - t0:.2f} s, {graph.nnz} edges, max degree "
          f"{graph.max_deg}")
    check(vdt.grf_graph() is graph and graph.device.type == "cuda",
          "grf_graph is not cached on the card")
    mask = np.random.RandomState(5).rand(n) < 0.10
    y0 = one_hot_labels(data.labels, mask, data.n_classes)
    alpha = 0.5
    exact = vdt.label_propagate(y0, alpha=alpha, n_iters=VDT_GRF_ITERS,
                                backend="exact")
    ests = []
    for seed in range(4):
        c = read_counts()
        est = vdt.label_propagate(y0, alpha=alpha, n_iters=VDT_GRF_ITERS,
                                  backend="grf", n_walkers=VDT_GRF_WALKERS,
                                  seed=seed)
        runs = read_counts()["K5"] - c["K5"]
        check(runs == VDT_GRF_ITERS, f"vdt grf: {runs} K5 launches")
        check(tuple(est.shape) == tuple(y0.shape)
              and bool(torch.isfinite(est).all()), "vdt grf: bad output")
        ests.append(est)
        err = (est - exact).abs()
        agree = float((est.argmax(-1) == exact.argmax(-1)).float().mean())
        print(f"  seed {seed}: vs exact (K1) max_err={float(err.max()):.3e} "
              f"mean_err={float(err.mean()):.3e} argmax agreement {agree:.4f}")
    mean = torch.stack(ests).mean(0)
    print(f"  mean of 4 seeds: max_err={float((mean - exact).abs().max()):.3e}"
          f" mean_err={float((mean - exact).abs().mean()):.3e}")


def phase_ops(out) -> dict:
    """K2, K3, K4 through the reference's op entry points, counted, then checked."""
    import torch
    from repro_torch.kernels.fused_lp import (fused_lp_matvec,
                                              fused_lp_step_batched,
                                              matvec_plain,
                                              step_batched_perbatch_plain)
    from repro_torch.kernels.pairwise import (pairwise_sq_dists,
                                              pairwise_sq_dists_plain)

    vdt = out["vdt"]
    x, sigma = vdt.x_rows, float(vdt.sigma)
    inv = float(1.0 / (2.0 * sigma * sigma))
    n, d = x.shape
    y = out["y0"]
    xs = x[:K3_N].contiguous()
    ys = out["y0s"][:, :K3_N].contiguous()
    xb = x[:K4_ROWS].contiguous()
    print(f"[ops] K2 fused_lp_matvec N={n} C=2; K3 fused_lp_step_batched("
          f"reuse=False) B={K3_BATCH} N={K3_N}; K4 pairwise_sq_dists "
          f"{K4_ROWS} x {n}, d={d}")
    reset_counts()
    k2 = fused_lp_matvec(x, y, sigma)
    k3 = fused_lp_step_batched(xs, ys, ys, sigma, 0.01, reuse=False)
    k4 = pairwise_sq_dists(xb, x)
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"  launches {counts}")
    for k in ("K2", "K3", "K4"):
        check(counts[k] == 1, f"{k} launched {counts[k]} times, expected 1")

    rows = {}
    err = close(k2, matvec_plain(x, y, inv), "K2 vs plain")[0]
    rows["K2"] = dict(
        err=err, ms=cuda_ms(lambda: fused_lp_matvec(x, y, sigma), 2),
        plain_ms=cuda_ms(lambda: matvec_plain(x, y, inv), 1),
        bound=bound(2.0 * n * n * (d + 2), 4.0 * (n * d + 2 * n * 2)),
        shape=f"N={n} d={d} C=2")
    err = close(k3, step_batched_perbatch_plain(xs, ys, ys, 0.01, inv),
                "K3 vs plain")[0]
    rows["K3"] = dict(
        err=err, ms=cuda_ms(lambda: fused_lp_step_batched(
            xs, ys, ys, sigma, 0.01, reuse=False), 2),
        plain_ms=cuda_ms(lambda: step_batched_perbatch_plain(
            xs, ys, ys, 0.01, inv), 1),
        bound=bound(K3_BATCH * 2.0 * K3_N * K3_N * (d + 2),
                    4.0 * (K3_N * d + 3 * K3_BATCH * K3_N * 2)),
        shape=f"B={K3_BATCH} N={K3_N} d={d} C=2")
    err = close(k4, pairwise_sq_dists_plain(xb, x), "K4 vs plain (f32)")[0]
    close(pairwise_sq_dists(xb.bfloat16(), x.bfloat16()),
          pairwise_sq_dists_plain(xb.bfloat16(), x.bfloat16()),
          "K4 vs plain (bf16)", 5e-2, 5e-2)
    rows["K4"] = dict(
        err=err, ms=cuda_ms(lambda: pairwise_sq_dists(xb, x), 10),
        plain_ms=cuda_ms(lambda: pairwise_sq_dists_plain(xb, x), 5),
        bound=bound(2.0 * K4_ROWS * n * d,
                    4.0 * (K4_ROWS * d + n * d + K4_ROWS * n)),
        shape=f"M={K4_ROWS} N={n} d={d} f32")
    for k, r in rows.items():
        print(f"  {k} {r['shape']}: {r['ms']:.3f} ms per launch, plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound'][0]:.3f} ms "
              f"({r['bound'][1]}), {r['bound'][0] / r['ms']:.3f} of the bound")
    return dict(rows=rows, counts=counts)


def phase_single_point() -> None:
    """N = 1: every column is masked; the reference divides by 256."""
    import torch
    from repro_torch.kernels.fused_lp import (alpha_row, folded_step,
                                              folded_step_plain, matvec_plain,
                                              matvec_step, perbatch_step,
                                              step_batched_perbatch_plain)

    print("[N = 1 through K1, K2, K3]")
    x = torch.tensor([[0.3, 0.5]], device="cuda")
    y = torch.tensor([[2.0, 3.0]], device="cuda")
    y0 = torch.tensor([[1.0, 5.0]], device="cuda")
    al = alpha_row(0.3, 2, "cuda")
    want = 0.3 * y / 256 + 0.7 * y0
    for name, got, plain in (
            ("K1", folded_step(x, x, y, y0, al, 0.5),
             folded_step_plain(x, x, y, y0, al, 0.5)),
            ("K2", matvec_step(x, y, 0.5), matvec_plain(x, y, 0.5)),
            ("K3", perbatch_step(x, y[None], y0[None], 0.3, 0.5)[0],
             step_batched_perbatch_plain(x, y[None], y0[None], 0.3, 0.5)[0])):
        close(got, plain, f"{name} vs plain")
        close(got, y / 256 if name == "K2" else want,
              f"{name} vs the reference's value")


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

    t_start = time.perf_counter()
    phase_build()
    phase_kernel_small()
    phase_k5_small()
    data = secstr_like(N_SECSTR, D_SECSTR, seed=3)

    reset_counts()
    out = phase_main(data)
    main_counts = read_counts()
    check(main_counts["K1"] == 2 * EXACT_ITERS,
          f"main path launched K1 {main_counts['K1']} times, expected "
          f"{2 * EXACT_ITERS}")
    after = phase_after(data, out)

    knn, graph = phase_knn(data, float(out["vdt"].sigma))
    reset_counts()
    phase_grf(out, knn, graph)
    grf_counts = read_counts()
    check(grf_counts["K5"] > 0 and grf_counts["K5"] % GRF_ITERS == 0,
          f"grf path launched K5 {grf_counts['K5']} times")
    print(f"  grf path launches {grf_counts}")
    k5 = phase_k5_timing(graph, out)
    del knn, graph

    reset_counts()
    phase_vdt_grf()
    vdt_counts = read_counts()
    print(f"  vdt grf path launches {vdt_counts}")
    check(vdt_counts["K1"] > 0 and vdt_counts["K5"] > 0,
          "vdt grf path: K1 or K5 not launched")
    ops = phase_ops(out)
    phase_single_point()

    single = after["rows"][0]
    kernels = [dict(
        name="K1 folded fused LP step", route="cuda",
        source="src/repro_torch/kernels/fused_lp/csrc/folded_lp.cu",
        replaces="src/repro/kernels/fused_lp/batched.py:231",
        launches=main_counts["K1"], max_abs_err=after["max_abs_err"],
        ms=single["ms"], plain_ms=single["plain_ms"],
        bound_ms=single["bound_ms"], bound_by=single["by"], library_ms=None,
        shape=f"N={N_SECSTR} d={D_SECSTR} K={single['k']}",
        batch8_ms=after["rows"][1]["ms"])]
    for k, name, source, replaces in (
            ("K2", "K2 fused LP matvec",
             "src/repro_torch/kernels/fused_lp/csrc/folded_lp.cu",
             "src/repro/kernels/fused_lp/fused_lp.py:168"),
            ("K3", "K3 per-batch-recompute LP step",
             "src/repro_torch/kernels/fused_lp/csrc/folded_lp.cu",
             "src/repro/kernels/fused_lp/batched.py:138"),
            ("K4", "K4 pairwise squared distances",
             "src/repro_torch/kernels/pairwise/csrc/pairwise.cu",
             "src/repro/kernels/pairwise/pairwise.py:50")):
        r = ops["rows"][k]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=ops["counts"][k], max_abs_err=r["err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
            bound_by=r["bound"][1], library_ms=None, shape=r["shape"]))
    r400 = next(r for r in k5["rows"] if r["m"] == 400 and r["k"] == 2)
    kernels.append(dict(
        name="K5 GRF walker-mean feature product", route="cuda",
        source="src/repro_torch/kernels/grf/csrc/grf_feature.cu",
        replaces="src/repro/kernels/grf/grf.py:72",
        launches=grf_counts["K5"], max_abs_err=k5["max_abs_err"],
        ms=r400["ms"], plain_ms=r400["plain_ms"], bound_ms=r400["bound_ms"],
        bound_by=r400["by"], library_ms=r400["lib_ms"],
        shape=f"S={N_SECSTR} m=400 K=2",
        call_ms=r400["call_ms"],
        by_shape={f"m={r['m']} K={r['k']}": dict(
            ms=r["ms"], call_ms=r["call_ms"], plain_ms=r["plain_ms"],
            library_ms=r["lib_ms"], bound_ms=r["bound_ms"])
            for r in k5["rows"]}))
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
