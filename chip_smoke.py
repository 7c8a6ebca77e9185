#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. device and build: the card's name and power limit, and the five kernel
   sources and K5's L2 probe built at once with ``nvcc`` for ``sm_90a`` from the checkout, with
   the shared headers of ``kernels/csrc`` (``fused_lp/csrc/folded_lp.cu``:
   K1 the folded exact LP step, K2 ``P @ Y``, K3 the per-batch-recompute
   step; ``pairwise/csrc/pairwise.cu``: K4; the four on Hopper's tensor
   cores as 3xTF32, ``kernels/csrc/tf32x3.cuh``;
   ``grf/csrc/grf_feature.cu``: K5 the GRF walker-mean feature product;
   ``flash_attention/csrc/flash_attention_tf32x3.cu``: K6's float32 route,
   3xTF32 on the tensor cores; ``flash_attention/csrc/flash_attention_sm90.cu``:
   K6's bfloat16 route on the tensor cores; and ``tools/l2_gather_probe.cu``,
   K5's L2 yardstick, no kernel of the port), with their ``-Xptxas -v``
   lines;
2. K1 against its plain-torch version on the card at small shapes: one
   step, a 5-step scan, a ``row_base`` stripe, and resume-from-carry equal to
   the monolithic scan bit for bit; K5 likewise, and a K = 16 column's bits
   equal to a K = 2 call's;
2b. the precision gate, which tells 3xTF32 from one TF32 product: on dense
   Gaussian points (numpy seed, d = 315) K4 at its timing shape, 2,048 x
   83,679, and K1 at N = 16,384 with K = 2 and K = 16 (logits spanning
   about 37 units across a row) against a float64 run of the same function
   (for K1 the plain recurrence in float64): the kernel's max and RMS errors
   must each be at most 2 x the plain float32 version's on the same inputs.
   The SecStr-like data of the main path has 0/1 features, so its distances
   are integers, exact in any order and in one TF32 product: the checks on it
   cannot see a precision loss;
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
   repeat == first bit for bit; then K5's time at those shapes, beside its
   plain version and ``embedding_bag`` in turns, and the rate at which it
   moves y's 32-byte sectors from L2 beside the L2's own rate for random
   sectors (``tools/l2_gather_probe.cu`` on arrays of y's sizes, the
   ``[L2 yardstick]`` line);
6. the VDT entry point ``label_propagate(backend="grf")`` at validation size
   (``secstr_like(4_096, 315)``, dense ``grf_graph`` bridge) against
   ``backend="exact"``;
7. the reference's remaining op entry points, each at its shape: K2
   (``fused_lp_matvec``, N = 83,679), K3 (``fused_lp_step_batched(
   reuse=False)``, B = 8, N = 16,384), K4 (``pairwise_sq_dists``, one kNN
   block 2,048 x 83,679), against their plain versions and timed, K4 beside
   ``torch.cdist`` (yardstick only); and one point (N = 1, every column
   masked) through K1, K2 and K3;
8. K6 (flash attention) against its plain version at small shapes, both
   routes (float32: the 3xTF32 kernel, route ``sm90_tf32x3``; bfloat16: the
   bf16 kernel, ``sm90_bf16``), each launch counted on its route: head widths
   64, 128 and 256, GQA groups 1, 3 and 4, causal with and without a window,
   ragged S and bidirectional; two launches equal bit for bit;
9. the dense LM serving path at the full width of smollm-360m
   (``repro/configs/smollm_360m.py``: 32 layers, d_model 960, 15/5 heads of
   64, d_ff 2,560, vocab 49,152, bfloat16; seeded random weights): 4
   requests of 2,048 prompt tokens through ``prefill`` (K6's bfloat16
   route in every layer, no float32 launch), then 16 greedy
   ``decode_step``s;
   decode logits held to ``lm_forward`` on S + 1 tokens at position S
   (``0.15``, the reference's own tolerance); K6's share of the prefill's
   device time;
10. the same model in float32, one prefill through K6 (its 3xTF32 route in
   every layer) and one through K6's plain version, last-position logits at
   ``rtol=atol=2e-3``;
11. K6 timed at smollm's attention shape (B = 4, 15/5 heads, S = 2,048,
   D = 64, causal) and at gemma3-1b's local layer (4/1 heads, D = 256,
   window 1,024), each route at its type, beside its plain version, its
   bound and ``scaled_dot_product_attention`` as the library yardstick, in
   turns;
12. K6's precision gate, which tells its float32 route's 3xTF32 from one
   TF32 product: Gaussian q, k, v (numpy seed) at both timed shapes, the
   kernel's max and RMS errors against the plain recurrence in float64 at
   most 2 x the plain float32 version's.

Each path runs with every launch counter set to 0 just before and read just
after; K1-K4 count their launches by route too, and every one of them must
be on ``tf32x3``, the tensor-core route; every float32 K6 launch must be on
``sm90_tf32x3``.  Prints the card (``nvidia-smi``),
one JSON line with the kernel table, and as its last line ``{"ok": true,
"device": {...}}``.  Tolerance:
``rtol=1e-4, atol=1e-5``, the reference package's own LP tolerance, for
K1-K4 (``5e-2`` for K4 on bfloat16, as the reference's test); ``rtol=1e-5,
atol=1e-6`` for K5, as the reference's ``test_feature_kernel_matches_ref``;
``2e-4`` (float32) for K6, as the reference's flash-attention tests (its
plain version repeats the kernel's tiles and recurrence, in float32).  K6's
bfloat16 route is held to its plain version, which repeats its recurrence
and rounds p to bfloat16 as it does, at ``rtol=atol=1e-2`` and, per block of
64 query rows of one (b, h), an error of at most ``1e-2`` of the block's
output in RMS: the two differ by roundings of single bfloat16 values (the
output's, or a p's on a short row; the largest reading is 3.9e-3, one
bfloat16 step of an output in [0.5, 1)), while a dropped key tile or a wrong
rescale moves a whole block.  SDPA is held to K6 at the reference's bfloat16 tolerance,
``5e-2``.
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
PEAK_TF32_FLOPS = 495e12     # TF32 on the tensor cores, dense
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
K6_TOL = {"float32": 2e-4, "bfloat16": 5e-2}   # K6 vs the reference, SDPA
# K6's bfloat16 route vs its plain version: elementwise rtol=atol, and the
# RMS error of each 64-row block over the RMS of its output (both routes)
K6_BF16_PLAIN_TOL, K6_BLOCK_RMS = 1e-2, 1e-2
# the precision gate: kernel error vs float64 at most GATE_RATIO x the plain
# float32 version's, max and RMS; K1's 1 / (2 sigma^2) on Gaussian d = 315
GATE_SEED, GATE_N_K1, GATE_RATIO, GATE_INV_TSS = 15, 16_384, 2.0, 0.1
TC_ROUTE = "tf32x3"          # K1-K4's tensor-core route
K6_F32_ROUTE = "sm90_tf32x3"  # K6's float32 route: 3xTF32 on the tensor cores
K6_ROUTES = {"float32": K6_F32_ROUTE, "bfloat16": "sm90_bf16"}
K6_GATE_SEED = 16
# K6's timed shapes: smollm-360m's attention and gemma3-1b's local layer
K6_SHAPES = (("smollm-360m", 4, 15, 5, 2_048, 64, 0),
             ("gemma3-1b local", 4, 4, 1, 2_048, 256, 1_024))


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
        for route in getattr(fn, "launches_by_route", {}):
            fn.launches_by_route[route] = 0


def read_counts() -> dict:
    """Launches by kernel, and by route where a kernel has routes
    (``K1 tf32x3``, ``K4 tf32x1_bf16``, ``K6 sm90_bf16``, ``K6 sm90_tf32x3``,
    ...)."""
    counts = {}
    for k, fn in counters().items():
        counts[k] = fn.launches
        for route, n in getattr(fn, "launches_by_route", {}).items():
            counts[f"{k} {route}"] = n
    return counts


def check_tc_route(counts: dict, kernels=("K1", "K2", "K3", "K4")) -> None:
    """Every launch of K1-K4 in ``counts`` went through the tensor-core route:
    its entry point reported three TF32 products a k step."""
    for k in kernels:
        check(counts[f"{k} {TC_ROUTE}"] == counts[k],
              f"{k}: {counts[k]} launches, {counts[f'{k} {TC_ROUTE}']} on "
              f"{TC_ROUTE}")


def tc_bound(m: int, n: int, d: int, k: int, nbytes: float) -> tuple:
    """K1-K4's least time in ms on the tensor-core route, what sets it, and
    the float32 CUDA-core bound of the same function: the cross term as
    three TF32 products (3 x 2 m n d) at the TF32 peak, plus p @ Y (2 m n k)
    at the float32 peak; or the bytes at the memory rate."""
    t_ops = (3 * 2.0 * m * n * d / PEAK_TF32_FLOPS
             + 2.0 * m * n * k / PEAK_FP32_FLOPS)
    t_bytes = nbytes / PEAK_HBM_BYTES
    f32_ms = max(2.0 * m * n * (d + k) / PEAK_FP32_FLOPS, t_bytes) * 1e3
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", f32_ms)


def k6_route_only(counts: dict, route: str, n: int) -> bool:
    """``counts`` put ``n`` K6 launches on ``route`` and none on another."""
    others = sum(v for k, v in counts.items()
                 if k.startswith("K6 ") and k != f"K6 {route}")
    return counts["K6"] == n and counts[f"K6 {route}"] == n and others == 0


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
        sm90_library as lib_k6_sm90
    from repro_torch.kernels.flash_attention.ops import \
        tf32x3_library as lib_k6
    from repro_torch.kernels.fused_lp import kernel_library as lib_k123
    from repro_torch.kernels.grf.ops import kernel_library as lib_k5
    from repro_torch.kernels.pairwise.ops import kernel_library as lib_k4

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    t0 = time.perf_counter()
    names = ("K1-K3", "K4", "K5", f"K6 {K6_F32_ROUTE}", "K6 sm90_bf16",
             "L2 yardstick")
    # one nvcc per source, all started together
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(lambda f: f(), (lib_k123, lib_k4, lib_k5,
                                               lib_k6, lib_k6_sm90,
                                               l2_probe_library)))
    print(f"[build] {time.perf_counter() - t0:.2f} s for all sources")
    for name, lib in zip(names, built):
        print(f"  {name} {lib.path.name}: nvcc {lib.build_seconds:.2f} s")
        for line in lib.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("    " + line.strip())


def l2_probe_library():
    """Build (at first use) and load ``tools/l2_gather_probe.cu``."""
    import ctypes

    from repro_torch.kernels._build import load_library

    built = load_library(REPO / "tools" / "l2_gather_probe.cu")
    fn = built.lib.l2_gather_probe
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return built


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


def gate_check(what: str, got, plain, ref) -> dict:
    """Measure ``got`` against the float64 ``ref`` beside the plain float32
    version ``plain``; ``ok`` when its max and RMS errors are each at most
    ``GATE_RATIO`` x the plain version's."""
    import torch

    def errors(t):
        check(t.shape == ref.shape and bool(torch.isfinite(t).all()),
              f"{what}: bad output")
        err = (t.double() - ref).abs()
        return float(err.max()), float(err.square().mean().sqrt())

    (k_max, k_rms), (p_max, p_rms) = errors(got), errors(plain)
    ok = k_max <= GATE_RATIO * p_max and k_rms <= GATE_RATIO * p_rms
    print(f"  {what}: kernel max {k_max:.4e} rms {k_rms:.4e}; plain f32 max "
          f"{p_max:.4e} rms {p_rms:.4e}; kernel / plain {k_max / p_max:.3f} "
          f"(max), {k_rms / p_rms:.3f} (rms) {'ok' if ok else 'FAIL'}")
    return dict(max=k_max, rms=k_rms, plain_max=p_max, plain_rms=p_rms, ok=ok)


def phase_gate() -> dict:
    """The precision gate: K4 and K1 against float64 on dense Gaussian points,
    where a dropped low product shows; the counts are not a path's."""
    import torch
    from repro_torch.kernels.fused_lp import folded_step, folded_step_plain
    from repro_torch.kernels.pairwise import (pairwise_sq_dists,
                                              pairwise_sq_dists_plain)

    print(f"[precision gate] Gaussian d={D_SECSTR}, seed {GATE_SEED}: kernel "
          f"vs float64 within {GATE_RATIO} x the plain float32 version's error")
    rng = np.random.RandomState(GATE_SEED)
    out = {}
    x = torch.as_tensor(rng.randn(K4_ROWS, D_SECSTR).astype(np.float32),
                        device="cuda")
    y = torch.as_tensor(rng.randn(N_SECSTR, D_SECSTR).astype(np.float32),
                        device="cuda")
    xd, yd = x.double(), y.double()
    ref = ((xd * xd).sum(1)[:, None] + (yd * yd).sum(1)[None, :]
           - 2.0 * (xd @ yd.T)).clamp_min(0.0)
    out["K4"] = gate_check(f"K4 {K4_ROWS} x {N_SECSTR}", pairwise_sq_dists(x, y),
                           pairwise_sq_dists_plain(x, y), ref)
    del x, y, xd, yd, ref
    x = torch.as_tensor(rng.randn(GATE_N_K1, D_SECSTR).astype(np.float32),
                        device="cuda")
    xd = x.double()
    head = xd[:256]
    d2 = ((head * head).sum(1)[:, None] + (xd * xd).sum(1)[None, :]
          - 2.0 * (head @ xd.T)) * GATE_INV_TSS
    d2.fill_diagonal_(float("nan"))
    span = float((d2.nan_to_num(-1.0).amax(1) - d2.nan_to_num(1e30).amin(1))
                 .mean())
    print(f"  K1 logits at 1/(2 sigma^2) = {GATE_INV_TSS}: a row spans "
          f"{span:.1f} units on average (first 256 rows)")
    for k in (2, 16):
        y = torch.as_tensor(rng.rand(GATE_N_K1, k).astype(np.float32),
                            device="cuda")
        al = torch.as_tensor(rng.rand(k).astype(np.float32), device="cuda")
        ref = folded_step_plain(xd, xd, y.double(), y.double(), al.double(),
                                GATE_INV_TSS)
        out[f"K1 K={k}"] = gate_check(
            f"K1 N={GATE_N_K1} K={k}", folded_step(x, x, y, y, al,
                                                   GATE_INV_TSS),
            folded_step_plain(x, x, y, y, al, GATE_INV_TSS), ref)
    failed = [k for k, v in out.items() if not v["ok"]]
    check(not failed, f"precision gate failed for {failed}: error over "
                      f"{GATE_RATIO} x the plain float32 version's")
    out["K1 logit span"] = span
    return out


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
        ms2 = cuda_ms(lambda: folded_step(x, x, k_seed, k_seed, al, inv), 3)
        plain_ms = cuda_ms(lambda: folded_step_plain(x, x, k_seed, k_seed, al, inv), 1)
        # x, y, y0, alpha in; out
        bound_ms, by, f32_ms = tc_bound(n, n, d, k, 4.0 * (n * d + 3 * n * k + k))
        print(f"  K={k}: K1 {ms:.2f} / {ms2:.2f} ms per launch, plain "
              f"{plain_ms:.2f} ms, bound {bound_ms:.2f} ms ({by}; 3xTF32 on "
              f"the tensor cores), {bound_ms / ms:.3f} of it; float32 CUDA-core"
              f" bound {f32_ms:.2f} ms, {f32_ms / ms:.3f} of it")
        rows.append(dict(k=k, ms=ms, ms2=ms2, plain_ms=plain_ms,
                         bound_ms=bound_ms, by=by))
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


def l2_yardstick(n: int) -> list:
    """The rate at which the card moves random 32- and 64-byte rows of an
    L2-resident array, of y's sizes at K = 2 and 16, to the SMs
    (``tools/l2_gather_probe.cu``): through L2 alone (``cg``) and through L1
    and L2 as K5's loads go (``nc``); GB/s of 32-byte sectors, by case."""
    import torch
    from repro_torch.kernels._build import launch

    built = l2_probe_library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = 8 * sms, 256
    sink = torch.empty(blocks * 256, device="cuda")
    rows = []
    for k, row_floats, l1 in ((2, 8, 0), (2, 8, 1), (16, 16, 0), (16, 16, 1),
                              (16, 8, 0)):
        y = torch.rand(n * k, device="cuda")       # y's bytes at this K
        n_rows = y.numel() // row_floats

        def probe():
            launch(built, "l2_gather_probe", y.device, y.data_ptr(), n_rows,
                   row_floats, l1, iters, sink.data_ptr(), blocks)

        ms = cuda_ms(probe, 20)
        sectors = blocks * 256.0 / (row_floats // 4) * iters \
            * row_floats * 4 / 32
        rate = sectors * 32 / ms / 1e6          # GB/s
        path = "nc" if l1 else "cg"
        print(f"[L2 yardstick] random {row_floats * 4}-byte rows of a "
              f"{y.numel() * 4 / 1e6:.2f} MB array (y at K={k}), ld.global."
              f"{path}: {ms:.4f} ms for {sectors / 1e6:.1f} M sectors, "
              f"{rate:.0f} GB/s, {sectors / ms / 1e6:.2f} G sectors/s")
        rows.append(dict(k=k, row_bytes=row_floats * 4, load=path,
                         array_mb=y.numel() * 4 / 1e6, ms=ms,
                         gb_per_s=rate))
    return rows


def phase_k5_timing(graph, out) -> dict:
    """K5 at the GRF path's shapes, against its plain version and a library
    call (in turns), with the L2 sector rate it reaches beside the L2's own
    rate for random sectors."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.matvec import fold_batch
    from repro_torch.kernels.grf import (default_draw, grf_feature_matvec,
                                         grf_feature_plain, walk_step)
    from repro_torch.kernels.grf.walkers import start_state

    print("[K5 at the GRF path's shapes: walkers after 3 steps]")
    n, rows = graph.n, []
    yard = l2_yardstick(n)
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
            check(torch.equal(got, grf_feature_matvec(pos, load, y)),
                  f"K5 S={n} m={m} K={k}: two launches differ")
            call_ms = cuda_ms(lambda: grf_feature_matvec(pos, load, y), 20)

            def kernel():
                return graph_ms(lambda: grf_feature_matvec(pos, load, y), 20)

            def library():
                return graph_ms(lambda: F.embedding_bag(
                    pos, y, per_sample_weights=load, mode="sum"), 20)

            # kernel, library, kernel, library: compared only in one run
            ms, lib_ms, ms2, lib_ms2 = kernel(), library(), kernel(), library()
            plain_ms = graph_ms(lambda: grf_feature_plain(pos, load, y), 3)
            bound_ms, by = bound(2.0 * n * m * k,
                                 n * m * 8.0 + n * k * 4.0 + n * k * 4.0)
            # y's 32-byte sectors a walker's row spans, moved from L2
            l2_bytes = n * m * (-(-4 * k // 32)) * 32.0
            l2_rate = l2_bytes / ms / 1e6      # GB/s
            print(f"  m={m} K={k}: K5 {ms:.4f} / {ms2:.4f} ms on the device "
                  f"({call_ms:.4f} ms per call with its host launch path), "
                  f"plain {plain_ms:.3f} ms, embedding_bag {lib_ms:.4f} / "
                  f"{lib_ms2:.4f} ms, bound {bound_ms:.4f} ms ({by}), "
                  f"{bound_ms / ms:.3f} of the bound; L2 sectors "
                  f"{l2_bytes / 1e9:.3f} GB, {l2_rate:.0f} GB/s")
            rows.append(dict(m=m, k=k, ms=ms, ms2=ms2, call_ms=call_ms,
                             plain_ms=plain_ms, lib_ms=lib_ms,
                             lib_ms2=lib_ms2, bound_ms=bound_ms, by=by,
                             err=err, l2_gb=l2_bytes / 1e9,
                             l2_gb_per_s=l2_rate))
    return dict(rows=rows, max_abs_err=max(r["err"] for r in rows),
                l2_yardstick=yard)


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
    check_tc_route(counts, ("K2", "K3", "K4"))

    rows = {}
    err = close(k2, matvec_plain(x, y, inv), "K2 vs plain")[0]
    rows["K2"] = dict(
        err=err, ms=cuda_ms(lambda: fused_lp_matvec(x, y, sigma), 2),
        plain_ms=cuda_ms(lambda: matvec_plain(x, y, inv), 1),
        bound=tc_bound(n, n, d, 2, 4.0 * (n * d + 2 * n * 2)),
        shape=f"N={n} d={d} C=2")
    err = close(k3, step_batched_perbatch_plain(xs, ys, ys, 0.01, inv),
                "K3 vs plain")[0]
    rows["K3"] = dict(
        err=err, ms=cuda_ms(lambda: fused_lp_step_batched(
            xs, ys, ys, sigma, 0.01, reuse=False), 2),
        plain_ms=cuda_ms(lambda: step_batched_perbatch_plain(
            xs, ys, ys, 0.01, inv), 1),
        bound=tc_bound(K3_BATCH * K3_N, K3_N, d, 2,
                       4.0 * (K3_N * d + 3 * K3_BATCH * K3_N * 2)),
        shape=f"B={K3_BATCH} N={K3_N} d={d} C=2")
    err = close(k4, pairwise_sq_dists_plain(xb, x), "K4 vs plain (f32)")[0]
    close(pairwise_sq_dists(xb.bfloat16(), x.bfloat16()),
          pairwise_sq_dists_plain(xb.bfloat16(), x.bfloat16()),
          "K4 vs plain (bf16)", 5e-2, 5e-2)
    # the library yardstick: cdist returns the square root of K4's output
    dist = torch.cdist(xb, x, compute_mode="use_mm_for_euclid_dist")
    print(f"  torch.cdist(use_mm)^2 vs K4: max_abs_diff="
          f"{float((dist.square() - k4).abs().max()):.3e} (not a check)")
    del dist
    # kernel, cdist, kernel, cdist: the two are compared only in one run
    def k4_run():
        return pairwise_sq_dists(xb, x)

    def cdist():
        return torch.cdist(xb, x, compute_mode="use_mm_for_euclid_dist")

    ms, lib_ms, ms2, lib_ms2 = (cuda_ms(fn, 10) for fn in (k4_run, cdist,
                                                            k4_run, cdist))
    rows["K4"] = dict(
        err=err, ms=ms, ms2=ms2, lib_ms=lib_ms, lib_ms2=lib_ms2,
        plain_ms=cuda_ms(lambda: pairwise_sq_dists_plain(xb, x), 5),
        bound=tc_bound(K4_ROWS, n, d, 0,
                       4.0 * (K4_ROWS * d + n * d + K4_ROWS * n)),
        shape=f"M={K4_ROWS} N={n} d={d} f32")
    for k, r in rows.items():
        lib = (f", torch.cdist {r['lib_ms']:.4f} / {r['lib_ms2']:.4f} ms "
               f"(K4 / cdist {r['ms'] / r['lib_ms']:.3f})"
               if "lib_ms" in r else "")
        again = f" / {r['ms2']:.4f}" if "ms2" in r else ""
        b_ms, by, f32_ms = r["bound"]
        print(f"  {k} {r['shape']}: {r['ms']:.4f}{again} ms per launch, plain "
              f"{r['plain_ms']:.3f} ms{lib}, bound {b_ms:.4f} ms ({by}; 3xTF32"
              f" on the tensor cores), {b_ms / r['ms']:.3f} of it; float32 "
              f"CUDA-core bound {f32_ms:.4f} ms, {f32_ms / r['ms']:.3f} of it")
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


def close_k6(got, want, what: str) -> tuple[float, float]:
    """Hold K6 to its plain version: elementwise (``2e-4`` for float32,
    ``K6_BF16_PLAIN_TOL`` for bfloat16), then each block of 64 query rows of
    one (b, h) to ``K6_BLOCK_RMS`` in RMS error over RMS output.  Returns the
    max abs error and the largest block ratio."""
    import torch

    tol = K6_TOL["float32"] if want.dtype == torch.float32 else \
        K6_BF16_PLAIN_TOL
    err = close(got, want, what, tol, tol)[0]
    b, h, s, d = want.shape
    pad = (0, 0, 0, -s % 64)   # zero rows past S leave both norms as they are
    blocks = [torch.nn.functional.pad(t.double().cpu(), pad)
              .reshape(b, h, -1, 64 * d) for t in (got - want, want)]
    ratio = float((blocks[0].norm(dim=-1)
                   / blocks[1].norm(dim=-1).clamp_min(1e-30)).max())
    print(f"    per 64-row block: max RMS error / RMS output = {ratio:.3e}")
    check(ratio <= K6_BLOCK_RMS, f"{what}: a 64-row block's RMS error is "
                                 f"{ratio:.3e} of its output, over "
                                 f"{K6_BLOCK_RMS}")
    return err, ratio


def attention_work(b: int, hq: int, hkv: int, s: int, d: int, window: int,
                   itemsize: int) -> tuple[float, float]:
    """Operations and bytes of causal attention over the unmasked pairs: two
    products of 2 B Hq D flops per pair; q, k, v read and out written once."""
    pairs = sum(min(i + 1, window) if window else i + 1 for i in range(s))
    flops = 4.0 * b * hq * d * pairs
    nbytes = itemsize * (2.0 * b * hq * s * d + 2.0 * b * hkv * s * d)
    return flops, nbytes


def phase_k6_small() -> dict:
    """K6 against its plain version at small shapes, both routes; returns the
    max error by route."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)

    print(f"[K6 vs plain, small shapes: float32 -> {K6_F32_ROUTE}, bfloat16 ->"
          " sm90_bf16]")
    g = torch.Generator().manual_seed(6)
    errs = {route: [] for route in K6_ROUTES.values()}
    ratios = {route: [] for route in K6_ROUTES.values()}
    for b, hq, hkv, s, d, causal, window in (
            (2, 3, 3, 64, 64, True, 0), (2, 3, 1, 65, 64, True, 16),
            (1, 15, 5, 130, 64, True, 0), (2, 4, 1, 97, 128, True, 0),
            (1, 8, 2, 200, 128, True, 16), (1, 4, 1, 129, 256, True, 16),
            (2, 4, 4, 70, 256, True, 0), (2, 3, 1, 65, 64, False, 0),
            (1, 4, 1, 100, 128, False, 16), (1, 4, 4, 33, 256, False, 0)):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(b, h, s, d, generator=g).to("cuda", dtype)
                       for h in (hq, hkv, hkv))
            route = K6_ROUTES[str(dtype).split(".")[1]]
            before = dict(flash_attention.launches_by_route)
            got = flash_attention(q, k, v, causal=causal, window=window)
            after = flash_attention.launches_by_route
            check(after.get(route, 0) == before.get(route, 0) + 1
                  and sum(after.values())
                  == sum(before.values()) + 1,
                  f"K6 {dtype}: launched {after} after {before}, expected one "
                  f"launch on {route}")
            err, ratio = close_k6(
                got, flash_attention_plain(q, k, v, causal, window),
                f"B={b} Hq={hq} Hkv={hkv} S={s} D={d} causal={causal} "
                f"window={window} {str(dtype).split('.')[1]}")
            errs[route].append(err)
            ratios[route].append(ratio)
            check(torch.equal(got, flash_attention(q, k, v, causal=causal,
                                                   window=window)),
                  "K6: two launches differ")
    print("  every shape: a second launch == the first bit for bit; each "
          "launch on its route")
    return {route: (max(errs[route]), max(ratios[route])) for route in errs}


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
    check(k6_route_only(prefill_counts, "sm90_bf16", cfg.n_layers),
          f"prefill launched K6 {prefill_counts}, expected {cfg.n_layers} "
          "times on the bfloat16 route and never on another")
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
          f"launches {prefill_counts['K6']} (sm90_bf16 "
          f"{prefill_counts['K6 sm90_bf16']}, {K6_F32_ROUTE} "
          f"{prefill_counts[f'K6 {K6_F32_ROUTE}']})"
          f"; decode {DECODE_SLACK} greedy "
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
    profile = phase_lm_profile(params, cfg, tokens, prefill_ms, decode_ms)
    return dict(params=params, counts=prefill_counts, prefill_ms=prefill_ms,
                decode_ms=decode_ms, peak_gib=peak, profile=profile)


def phase_lm_profile(params, cfg, tokens, prefill_ms: float,
                     decode_ms: float) -> dict:
    """Device time by kernel of one prefill and one decode step (torch
    profiler), and the device's busy share of the unprofiled times; returns
    the device ms by group of each."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.decode import decode_step, prefill

    def groups(prof):
        out, kernels = {}, []
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            name = e.key
            # K6's kernels: flash_attention_tf32x3_kernel and its
            # prepare_kv_kernel (float32), flash_attention_sm90_kernel
            kind = ("K6" if "flash_attention" in name
                    or "prepare_kv" in name else
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
    result = {}
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
        result[name] = dict(by, total=total)
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
    return result


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def phase_lm_f32(params) -> tuple[float, dict]:
    """The same model in float32: one prefill through K6 (its 3xTF32 route,
    counted from 0), one through K6's plain version (swapped into the
    attention module for that call); returns the logits' max error and the
    K6 prefill's launch counts."""
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
    reset_counts()
    t0 = time.perf_counter()
    got, _ = prefill(params, tokens, cfg)
    torch.cuda.synchronize()
    k6_s = time.perf_counter() - t0
    counts = read_counts()
    before = flash_attention.launches
    check(k6_route_only(counts, K6_F32_ROUTE, cfg.n_layers),
          f"f32 prefill launched K6 {counts}, expected once per layer on "
          f"{K6_F32_ROUTE} and never on another route")
    attention.flash_attention = flash_attention_plain
    try:
        t0 = time.perf_counter()
        want, _ = prefill(params, tokens, cfg)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    finally:
        attention.flash_attention = flash_attention
    check(flash_attention.launches == before,
          "the plain prefill launched K6")
    print(f"  prefill through K6 {k6_s * 1e3:.1f} ms (launches {counts}), "
          f"through the plain version {plain_s * 1e3:.1f} ms")
    return close(got, want, "last-position logits, K6 vs plain", LM_F32_TOL,
                 LM_F32_TOL)[0], counts


def phase_k6_timing() -> list:
    """K6 at the LM path's attention shapes, each route at its type (bfloat16:
    the bf16 tensor-core kernel; float32: the 3xTF32 one), against its plain
    version, its bound and ``scaled_dot_product_attention`` (yardstick only),
    kernel and SDPA in turns."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)

    print("[K6 timing]")
    g = torch.Generator().manual_seed(7)
    rows = []
    for (name, b, hq, hkv, s, d, window), dtype in (
            (shape, dtype) for dtype in (torch.bfloat16, torch.float32)
            for shape in K6_SHAPES):
        tname = str(dtype).split(".")[1]
        route, tol = K6_ROUTES[tname], K6_TOL[tname]
        q, k, v = (torch.randn(b, h, s, d, generator=g).to("cuda", dtype)
                   for h in (hq, hkv, hkv))
        before = flash_attention.launches_by_route.get(route, 0)
        got = flash_attention(q, k, v, window=window)
        check(flash_attention.launches_by_route.get(route, 0) == before + 1,
              f"K6 {tname} did not launch on {route}")
        err, ratio = close_k6(got, flash_attention_plain(q, k, v, True,
                                                         window),
                              f"{name} {tname}: K6 ({route}) vs plain")
        check(torch.equal(got, flash_attention(q, k, v, window=window)),
              f"{name} {tname}: two launches differ")
        i = torch.arange(s, device="cuda")
        mask = dict(attn_mask=(i[None, :] <= i[:, None])
                    & (i[:, None] - i[None, :] < window)) if window else \
            dict(is_causal=True)

        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, enable_gqa=True,
                                                  **mask)

        close(sdpa(), got, f"{name} {tname}: SDPA vs K6", tol, tol)
        # kernel, SDPA, kernel, SDPA: the two are compared only in one run
        ms = cuda_ms(lambda: flash_attention(q, k, v, window=window), 10)
        lib_ms = cuda_ms(sdpa, 10)
        ms2 = cuda_ms(lambda: flash_attention(q, k, v, window=window), 10)
        lib_ms2 = cuda_ms(sdpa, 10)
        plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, True,
                                                         window), 3)
        flops, nbytes = attention_work(b, hq, hkv, s, d, window,
                                       q.element_size())
        # bfloat16: one product on the tensor cores; float32: three TF32
        # products on the tensor cores, with the CUDA cores' bound beside
        if dtype == torch.bfloat16:
            bound_ms, by = bound(flops, nbytes, PEAK_BF16_FLOPS)
            f32_ms = None
            extra = ""
        else:
            bound_ms, by = bound(3.0 * flops, nbytes, PEAK_TF32_FLOPS)
            f32_ms = bound(flops, nbytes, PEAK_FP32_FLOPS)[0]
            extra = (f"; float32 CUDA-core bound {f32_ms:.4f} ms, "
                     f"{f32_ms / ms:.4f} of it")
        print(f"  {name} {tname} B={b} Hq={hq} Hkv={hkv} S={s} D={d} "
              f"window={window}: K6 ({route}) {ms:.4f} / {ms2:.4f} ms per "
              f"launch ({flops / ms / 1e9:.2f} TFLOP/s), plain "
              f"{plain_ms:.3f} ms, SDPA {lib_ms:.4f} / {lib_ms2:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({by}), {bound_ms / ms:.4f} of the "
              f"bound{extra}, K6 / SDPA {ms / lib_ms:.3f}")
        rows.append(dict(name=name, route=route, shape=f"B={b} Hq={hq} "
                         f"Hkv={hkv} S={s} D={d} window={window} {tname}",
                         ms=ms, ms2=ms2, plain_ms=plain_ms, lib_ms=lib_ms,
                         lib_ms2=lib_ms2, bound_ms=bound_ms, by=by,
                         f32_bound_ms=f32_ms, err=err, block_rms=ratio))
    return rows


def phase_k6_gate() -> dict:
    """K6's float32 route against the plain recurrence in float64 on Gaussian
    q, k, v at both timed shapes, beside the plain float32 version: the gate
    that tells 3xTF32 from one TF32 product."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)

    check(not torch.backends.cuda.matmul.allow_tf32,
          "the plain float32 version needs float32 matrix products")
    print(f"[K6 precision gate] Gaussian q, k, v, seed {K6_GATE_SEED}: float32"
          f" kernel vs float64 within {GATE_RATIO} x the plain float32 "
          "version's error")
    rng = np.random.RandomState(K6_GATE_SEED)
    out = {}
    for name, b, hq, hkv, s, d, window in K6_SHAPES:
        q, k, v = (torch.as_tensor(rng.randn(b, h, s, d).astype(np.float32),
                                   device="cuda") for h in (hq, hkv, hkv))
        ref = flash_attention_plain(q.double(), k.double(), v.double(), True,
                                    window)
        out[name] = gate_check(f"K6 f32 {name}", flash_attention(
            q, k, v, window=window), flash_attention_plain(q, k, v, True,
                                                           window), ref)
    failed = [k for k, v in out.items() if not v["ok"]]
    check(not failed, f"K6 precision gate failed for {failed}: error over "
                      f"{GATE_RATIO} x the plain float32 version's")
    return out


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
    gate = phase_gate()
    data = secstr_like(N_SECSTR, D_SECSTR, seed=3)

    reset_counts()
    out = phase_main(data)
    main_counts = read_counts()
    check(main_counts["K1"] == 2 * EXACT_ITERS,
          f"main path launched K1 {main_counts['K1']} times, expected "
          f"{2 * EXACT_ITERS}")
    check_tc_route(main_counts, ("K1",))
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
    check_tc_route(vdt_counts, ("K1",))
    ops = phase_ops(out)
    phase_single_point()
    del out, data

    k6_small_err = phase_k6_small()
    lm = phase_lm_serve()
    lm_counts = lm["counts"]
    lm_f32_err, f32_counts = phase_lm_f32(lm.pop("params"))
    k6 = phase_k6_timing()
    k6_gate = phase_k6_gate()

    single, batch8 = after["rows"]
    tc = dict(tensor_core_route=TC_ROUTE,
              headers=["src/repro_torch/kernels/csrc/tf32x3.cuh",
                       "src/repro_torch/kernels/csrc/sm90.cuh"])
    kernels = [dict(
        name="K1 folded fused LP step", route="cuda",
        source="src/repro_torch/kernels/fused_lp/csrc/folded_lp.cu",
        replaces="src/repro/kernels/fused_lp/batched.py:231",
        launches=main_counts["K1"], max_abs_err=after["max_abs_err"],
        ms=single["ms"], plain_ms=single["plain_ms"],
        bound_ms=single["bound_ms"], bound_by=single["by"], library_ms=None,
        shape=f"N={N_SECSTR} d={D_SECSTR} K={single['k']}",
        ms2=single["ms2"],
        launches_tf32x3=main_counts[f"K1 {TC_ROUTE}"],
        batch8=dict(k=batch8["k"], ms=batch8["ms"], ms2=batch8["ms2"],
                    plain_ms=batch8["plain_ms"], bound_ms=batch8["bound_ms"]),
        gate={k: v for k, v in gate.items() if k.startswith("K1")}, **tc)]
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
            bound_by=r["bound"][1], library_ms=r.get("lib_ms"),
            shape=r["shape"],
            launches_tf32x3=ops["counts"][f"{k} {TC_ROUTE}"], **tc,
            **(dict(ms2=r["ms2"], library_ms2=r["lib_ms2"], gate=gate["K4"])
               if k == "K4" else {})))
    r400 = next(r for r in k5["rows"] if r["m"] == 400 and r["k"] == 2)
    kernels.append(dict(
        name="K5 GRF walker-mean feature product", route="cuda",
        source="src/repro_torch/kernels/grf/csrc/grf_feature.cu",
        replaces="src/repro/kernels/grf/grf.py:72",
        launches=grf_counts["K5"], max_abs_err=k5["max_abs_err"],
        ms=r400["ms"], plain_ms=r400["plain_ms"], bound_ms=r400["bound_ms"],
        bound_by=r400["by"], library_ms=r400["lib_ms"],
        shape=f"S={N_SECSTR} m=400 K=2",
        call_ms=r400["call_ms"], ms2=r400["ms2"],
        l2_gb_per_s=r400["l2_gb_per_s"],
        l2_yardstick=k5["l2_yardstick"],
        by_shape={f"m={r['m']} K={r['k']}": dict(
            ms=r["ms"], ms2=r["ms2"], call_ms=r["call_ms"],
            plain_ms=r["plain_ms"], library_ms=r["lib_ms"],
            library_ms2=r["lib_ms2"], bound_ms=r["bound_ms"],
            l2_gb=r["l2_gb"], l2_gb_per_s=r["l2_gb_per_s"])
            for r in k5["rows"]}))
    # K6: one entry per route, each timed at smollm-360m's shape in its type;
    # launches are the bf16 prefill's and the f32 twin's
    k6_dir = "src/repro_torch/kernels/flash_attention/csrc/"
    k6_sources = {"sm90_bf16": k6_dir + "flash_attention_sm90.cu",
                  K6_F32_ROUTE: k6_dir + "flash_attention_tf32x3.cu"}
    prefill_share = lm["profile"].get("prefill", {})
    for route, name, launches in (
            ("sm90_bf16", "K6 flash attention, bfloat16 (tensor cores)",
             lm_counts["K6 sm90_bf16"]),
            (K6_F32_ROUTE, "K6 flash attention, float32 (3xTF32 tensor "
             "cores)", f32_counts[f"K6 {K6_F32_ROUTE}"])):
        rows = [r for r in k6 if r["route"] == route]
        kernels.append(dict(
            name=name, route="cuda", source=k6_sources[route],
            replaces="src/repro/kernels/flash_attention/flash_attention.py:98",
            launches=launches, max_abs_err=rows[0]["err"], ms=rows[0]["ms"],
            plain_ms=rows[0]["plain_ms"], bound_ms=rows[0]["bound_ms"],
            bound_by=rows[0]["by"], library_ms=rows[0]["lib_ms"],
            shape=rows[0]["shape"], k6_route=route, k6_sources=k6_sources,
            small_shapes_max_abs_err=k6_small_err[route][0],
            small_shapes_max_block_rms=k6_small_err[route][1],
            by_shape={r["name"]: dict(ms=r["ms"], ms2=r["ms2"],
                                      plain_ms=r["plain_ms"],
                                      library_ms=r["lib_ms"],
                                      library_ms2=r["lib_ms2"],
                                      bound_ms=r["bound_ms"],
                                      f32_bound_ms=r["f32_bound_ms"],
                                      max_abs_err=r["err"],
                                      max_block_rms=r["block_rms"],
                                      shape=r["shape"]) for r in rows},
            **(dict(prefill_ms=lm["prefill_ms"],
                    decode_ms_per_step=lm["decode_ms"],
                    prefill_device_ms=prefill_share.get("total"),
                    prefill_k6_device_ms=prefill_share.get("K6"))
               if route == "sm90_bf16" else
               dict(lm_f32_logits_max_abs_err=lm_f32_err, gate=k6_gate,
                    tensor_core_route=K6_F32_ROUTE,
                    headers=tc["headers"]))))
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
