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
   point (N = 1, every column masked) through K1, K2 and K3;
8. K6 (``flash_attention/csrc/flash_attention.cu``, flash attention)
   against its plain version at small shapes: head widths 64, 128 and 256,
   float32 and bfloat16, GQA groups 1, 3 and 4, causal with and without a
   window, ragged S and bidirectional; two launches equal bit for bit;
9. the dense LM serving path at the full width of smollm-360m
   (``repro/configs/smollm_360m.py``: 32 layers, d_model 960, 15/5 heads of
   64, d_ff 2,560, vocab 49,152, bfloat16; seeded random weights): 4
   requests of 2,048 prompt tokens through ``prefill`` (K6 in every layer),
   then 16 greedy ``decode_step``s; decode logits held to ``lm_forward`` on
   S + 1 tokens at position S (``0.15``, the reference's own tolerance);
10. the same model in float32, one prefill through K6 and one through K6's
   plain version, last-position logits at ``rtol=atol=2e-3``;
11. K6 timed at smollm's attention shape (B = 4, 15/5 heads, S = 2,048,
   D = 64, causal, bfloat16) and at gemma3-1b's local layer (4/1 heads,
   D = 256, window 1,024), beside its plain version, its bound and
   ``scaled_dot_product_attention`` as the library yardstick.

Each path runs with every launch counter set to 0 just before and read just
after.  Prints the card (``nvidia-smi``), one JSON line with the kernel
table, and as its last line ``{"ok": true, "device": {...}}``.  Tolerance:
``rtol=1e-4, atol=1e-5``, the reference package's own LP tolerance, for
K1-K4 (``5e-2`` for K4 on bfloat16, as the reference's test); ``rtol=1e-5,
atol=1e-6`` for K5, as the reference's ``test_feature_kernel_matches_ref``;
``2e-4`` (float32) and ``5e-2`` (bfloat16) for K6, as the reference's
flash-attention tests.
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
PEAK_BF16_FLOPS = 989e12     # bf16 on the tensor cores, dense
LM_ARCH, LM_BATCH, LM_PROMPT, LM_SEED = "smollm-360m", 4, 2_048, 0
LM_TOL, LM_F32_TOL = 0.15, 2e-3
K6_TOL = {"float32": 2e-4, "bfloat16": 5e-2}


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


def bound(flops: float, nbytes: float,
          peak: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    """Least time on the card in ms, and what sets it (H100 SXM peaks)."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes \
        else "bytes"


def counters():
    """The launch counters of every kernel wrapper, by kernel."""
    from repro_torch.kernels.fused_lp import folded_step, matvec_step, \
        perbatch_step
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.grf import grf_feature_matvec
    from repro_torch.kernels.pairwise import pairwise_sq_dists

    return {"K1": folded_step, "K2": matvec_step, "K3": perbatch_step,
            "K4": pairwise_sq_dists, "K5": grf_feature_matvec,
            "K6": flash_attention}


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

    from repro_torch.kernels.flash_attention.ops import \
        kernel_library as lib_k6
    from repro_torch.kernels.fused_lp import kernel_library as lib_k123
    from repro_torch.kernels.grf.ops import kernel_library as lib_k5
    from repro_torch.kernels.pairwise.ops import kernel_library as lib_k4

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    t0 = time.perf_counter()
    names = ("K1-K3", "K4", "K5", "K6")
    # one nvcc per source, all started together
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(lambda f: f(),
                              (lib_k123, lib_k4, lib_k5, lib_k6)))
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


def attention_work(b: int, hq: int, hkv: int, s: int, d: int, window: int,
                   itemsize: int) -> tuple[float, float]:
    """Operations and bytes of causal attention over the unmasked pairs: two
    products of 2 B Hq D flops per pair; q, k, v read and out written once."""
    pairs = sum(min(i + 1, window) if window else i + 1 for i in range(s))
    flops = 4.0 * b * hq * d * pairs
    nbytes = itemsize * (2.0 * b * hq * s * d + 2.0 * b * hkv * s * d)
    return flops, nbytes


def phase_k6_small() -> float:
    """K6 against its plain version at small shapes; returns the max error."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)

    print("[K6 vs plain, small shapes]")
    g = torch.Generator().manual_seed(6)
    errs = []
    for b, hq, hkv, s, d, causal, window in (
            (2, 3, 3, 64, 64, True, 0), (2, 3, 1, 65, 64, True, 16),
            (1, 15, 5, 130, 64, True, 0), (2, 4, 1, 97, 128, True, 0),
            (1, 8, 2, 200, 128, True, 16), (1, 4, 1, 129, 256, True, 16),
            (2, 4, 4, 70, 256, True, 0), (2, 3, 1, 65, 64, False, 0),
            (1, 4, 1, 100, 128, False, 16), (1, 4, 4, 33, 256, False, 0)):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(b, h, s, d, generator=g).to("cuda", dtype)
                       for h in (hq, hkv, hkv))
            got = flash_attention(q, k, v, causal=causal, window=window)
            tol = K6_TOL[str(dtype).split(".")[1]]
            errs.append(close(
                got, flash_attention_plain(q, k, v, causal, window),
                f"B={b} Hq={hq} Hkv={hkv} S={s} D={d} causal={causal} "
                f"window={window} {str(dtype).split('.')[1]}", tol, tol)[0])
            check(torch.equal(got, flash_attention(q, k, v, causal=causal,
                                                   window=window)),
                  "K6: two launches differ")
    print("  every shape: a second launch == the first bit for bit")
    return max(errs)


def lm_tokens(cfg, n: int) -> np.ndarray:
    return np.random.RandomState(LM_SEED + 1).randint(
        0, cfg.vocab_size, (LM_BATCH, n)).astype(np.int64)


def phase_lm_serve() -> dict:
    """smollm-360m at full width: prefill 4 x 2,048 tokens, 16 greedy decode
    steps; K6 in every layer of the prefill."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import init_lm, lm_forward
    from repro_torch.serving.decode import DECODE_SLACK, decode_step, prefill

    cfg = get_config(LM_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_lm(cfg, LM_SEED, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[lm serve] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.head_dim_}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.dtype}; {n_params / 1e6:.1f} M params (f32) seeded on the "
          f"card in {time.perf_counter() - t0:.2f} s")
    tokens = torch.as_tensor(lm_tokens(cfg, LM_PROMPT), device="cuda")
    # a cold call first (module loading, cuBLAS handles), outside the count
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = prefill(params, tokens.flip(1), cfg)
    decode_step(params, logits.argmax(-1)[:, None], state, cfg)
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    del logits, state
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = prefill(params, tokens, cfg)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_counts = read_counts()
    check(prefill_counts["K6"] == cfg.n_layers,
          f"prefill launched K6 {prefill_counts['K6']} times, expected "
          f"{cfg.n_layers}")
    check(tuple(logits.shape) == (LM_BATCH, cfg.padded_vocab)
          and bool(torch.isfinite(logits.float()).all()), "prefill: bad logits")
    check(tuple(state.kv.k.shape) == (cfg.n_layers, LM_BATCH,
                                      LM_PROMPT + DECODE_SLACK,
                                      cfg.n_kv_heads, cfg.head_dim_),
          f"prefill: cache shape {tuple(state.kv.k.shape)}")
    tok = logits.argmax(-1)[:, None]
    generated, step_logits = [tok], []
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(DECODE_SLACK + 1)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    marks[0].record()
    for i in range(DECODE_SLACK):
        logits, state = decode_step(params, tok, state, cfg)
        step_logits.append(logits)
        tok = logits.argmax(-1)[:, None]
        generated.append(tok)
        marks[i + 1].record()
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / DECODE_SLACK
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(all(bool(torch.isfinite(x.float()).all()) for x in step_logits),
          "decode: non-finite logits")
    check(int(state.kv.pos[0]) == LM_PROMPT + DECODE_SLACK, "decode: bad pos")
    print(f"  cold prefill + 1 decode step (not counted): {cold_ms:.1f} ms")
    print(f"  prefill {LM_BATCH} x {LM_PROMPT} tokens: {prefill_ms:.1f} ms "
          f"({LM_BATCH * LM_PROMPT / prefill_ms * 1e3:.0f} tokens/s), K6 "
          f"launches {prefill_counts['K6']}; decode {DECODE_SLACK} greedy "
          f"steps: {decode_ms:.2f} ms per step ({LM_BATCH / decode_ms * 1e3:.0f}"
          f" tokens/s; steps between device events: min {min(step_ms):.2f}, "
          f"max {max(step_ms):.2f} ms); max_memory_allocated {peak:.2f} GiB;"
          f" launches {counts}")
    print(f"  request 0 generated {torch.cat(generated, 1)[0].tolist()}")
    # the reference's consistency check: decode at position S vs the forward
    full_tokens = torch.cat([tokens, generated[0]], dim=1)
    full, _ = lm_forward(params, full_tokens, cfg)
    close(step_logits[0], full[:, LM_PROMPT], "decode logits vs lm_forward at "
          f"position S={LM_PROMPT}", LM_TOL, LM_TOL)
    del full
    phase_lm_profile(params, cfg, tokens, prefill_ms, decode_ms)
    return dict(params=params, counts=counts, prefill_ms=prefill_ms,
                decode_ms=decode_ms, peak_gib=peak)


def phase_lm_profile(params, cfg, tokens, prefill_ms: float,
                     decode_ms: float) -> None:
    """Device time by kernel of one prefill and one decode step (torch
    profiler), and the device's busy share of the unprofiled times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.decode import decode_step, prefill

    def groups(prof):
        out, kernels = {}, []
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            name = e.key
            kind = ("K6" if "flash_attention_kernel" in name else
                    "matmul" if any(w in name.lower() for w in (
                        "gemm", "gemv", "cutlass", "xmma", "nvjet"))
                    else "other")
            us = getattr(e, "self_device_time_total", None)
            us = e.self_cuda_time_total if us is None else us
            out[kind] = out.get(kind, 0.0) + us / 1e3
            kernels.append((us / 1e3, e.count, name))
        return out, sorted(kernels, reverse=True)[:6]

    logits, state = prefill(params, tokens, cfg)
    tok = logits.argmax(-1)[:, None]
    for name, fn, wall_ms in (
            ("prefill", lambda: prefill(params, tokens, cfg), prefill_ms),
            ("decode step", lambda: decode_step(params, tok, state, cfg),
             decode_ms)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        by, top = groups(prof)
        total = sum(by.values())
        if total == 0.0:
            print(f"  [profile] {name}: the profiler saw no device time "
                  "(busy share not measured)")
            continue
        parts = ", ".join(f"{k} {v:.2f} ms ({v / total:.3f})"
                          for k, v in sorted(by.items(),
                                             key=lambda kv: -kv[1]))
        print(f"  [profile] {name}: device time {total:.2f} ms: {parts}; "
              f"busy share of the unprofiled {wall_ms:.2f} ms: "
              f"{min(total / wall_ms, 1.0):.3f}")
        for ms, count, kname in top:
            print(f"    {ms:8.3f} ms in {count:5d} launches  {kname[:90]}")


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def phase_lm_f32(params) -> float:
    """The same model in float32: one prefill through K6, one through K6's
    plain version (swapped into the attention module for that call)."""
    import dataclasses

    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.models import attention
    from repro_torch.serving.decode import prefill

    cfg = dataclasses.replace(get_config(LM_ARCH), dtype="float32")
    tokens = torch.as_tensor(lm_tokens(cfg, LM_PROMPT), device="cuda")
    print(f"[lm serve, f32] {cfg.name} in float32: prefill through K6 vs "
          "through its plain version")
    before = flash_attention.launches
    t0 = time.perf_counter()
    got, _ = prefill(params, tokens, cfg)
    torch.cuda.synchronize()
    k6_s = time.perf_counter() - t0
    check(flash_attention.launches - before == cfg.n_layers,
          "f32 prefill did not launch K6 once per layer")
    attention.flash_attention = flash_attention_plain
    try:
        t0 = time.perf_counter()
        want, _ = prefill(params, tokens, cfg)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    finally:
        attention.flash_attention = flash_attention
    check(flash_attention.launches - before == cfg.n_layers,
          "the plain prefill launched K6")
    print(f"  prefill through K6 {k6_s * 1e3:.1f} ms, through the plain "
          f"version {plain_s * 1e3:.1f} ms")
    return close(got, want, "last-position logits, K6 vs plain", LM_F32_TOL,
                 LM_F32_TOL)[0]


def phase_k6_timing() -> list:
    """K6 at the LM path's attention shapes, against its plain version, its
    bound and ``scaled_dot_product_attention`` (yardstick only)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)

    print("[K6 timing, bfloat16]")
    g = torch.Generator().manual_seed(7)
    rows = []
    for name, b, hq, hkv, s, d, window in (
            ("smollm-360m", 4, 15, 5, 2_048, 64, 0),
            ("gemma3-1b local", 4, 4, 1, 2_048, 256, 1_024)):
        q, k, v = (torch.randn(b, h, s, d, generator=g).to("cuda",
                                                         torch.bfloat16)
                   for h in (hq, hkv, hkv))
        got = flash_attention(q, k, v, window=window)
        err = close(got, flash_attention_plain(q, k, v, True, window),
                    f"{name}: K6 vs plain", K6_TOL["bfloat16"],
                    K6_TOL["bfloat16"])[0]
        i = torch.arange(s, device="cuda")
        mask = dict(attn_mask=(i[None, :] <= i[:, None])
                    & (i[:, None] - i[None, :] < window)) if window else \
            dict(is_causal=True)

        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, enable_gqa=True,
                                                  **mask)

        close(sdpa(), got, f"{name}: SDPA vs K6", K6_TOL["bfloat16"],
              K6_TOL["bfloat16"])
        ms = cuda_ms(lambda: flash_attention(q, k, v, window=window), 10)
        plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, True,
                                                         window), 3)
        lib_ms = cuda_ms(sdpa, 10)
        flops, nbytes = attention_work(b, hq, hkv, s, d, window, 2)
        bound_ms, by = bound(flops, nbytes, PEAK_BF16_FLOPS)
        print(f"  {name} B={b} Hq={hq} Hkv={hkv} S={s} D={d} window="
              f"{window}: K6 {ms:.3f} ms per launch ({flops / ms / 1e9:.2f} "
              f"TFLOP/s), plain {plain_ms:.3f} ms, SDPA {lib_ms:.3f} ms, "
              f"bound {bound_ms:.4f} ms ({by}), {bound_ms / ms:.4f} of the "
              f"bound, SDPA / K6 {lib_ms / ms:.4f}")
        rows.append(dict(name=name, shape=f"B={b} Hq={hq} Hkv={hkv} S={s} "
                         f"D={d} window={window} bf16", ms=ms,
                         plain_ms=plain_ms, lib_ms=lib_ms, bound_ms=bound_ms,
                         by=by, err=err))
    return rows


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
    del out, data

    k6_small_err = phase_k6_small()
    lm = phase_lm_serve()
    lm_counts = lm["counts"]
    lm_f32_err = phase_lm_f32(lm.pop("params"))
    k6 = phase_k6_timing()

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
    k6_path = k6[0]
    kernels.append(dict(
        name="K6 flash attention", route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:98",
        launches=lm_counts["K6"], max_abs_err=k6_path["err"],
        ms=k6_path["ms"], plain_ms=k6_path["plain_ms"],
        bound_ms=k6_path["bound_ms"], bound_by=k6_path["by"],
        library_ms=k6_path["lib_ms"], shape=k6_path["shape"],
        small_shapes_max_abs_err=k6_small_err,
        lm_f32_logits_max_abs_err=lm_f32_err,
        prefill_ms=lm["prefill_ms"], decode_ms_per_step=lm["decode_ms"],
        by_shape={r["name"]: dict(ms=r["ms"], plain_ms=r["plain_ms"],
                                  library_ms=r["lib_ms"],
                                  bound_ms=r["bound_ms"], shape=r["shape"])
                  for r in k6}))
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
