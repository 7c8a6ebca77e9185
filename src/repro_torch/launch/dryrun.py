"""``repro_torch/launch/dryrun.py`` ↔ ``repro/launch/dryrun.py``.

The dry run of every (architecture x shape x mesh) cell and of the paper's
own cell, at production size, on any host:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

The reference lowers and compiles each cell for a 16 x 16 (or 2 x 16 x 16)
TPU mesh on 512 forced XLA host devices and reads FLOPs and bytes from
``compiled.cost_analysis()``.  PyTorch eager has no compiled program, so the
port *counts* the step's work by running it once on ``meta`` tensors at the
cell's full shape and depth (:func:`count_work`): no storage, no values, and
K6 one operator with its FLOP formula.  The counts are global; the roofline
divides them over the mesh's chips at the H100's constants
(``launch/roofline.py``).  Each device's share of the step's arguments is
planned on ``launch/mesh.py::make_production_mesh`` through the reference's
sharding rules (``distributed/sharding.py::param_shardings``).

Bytes are eager and unfused: every operator's tensor inputs read once and
its outputs written once (views count 0).  That is an upper bound on the
traffic a fused program moves, not XLA's "bytes accessed".  Not carried
over (``README.md``): the compile proof, HLO collective bytes, XLA's fused
byte count, the L = 2 / 4 marginal extrapolation and ``memory_analysis``'s
temporary bytes.

Records go to ``artifacts/dryrun_torch/{cell}.json``.
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch._tree import flatten
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, cell_is_applicable, input_specs
from repro_torch.distributed.sharding import (ShardCtx, param_shardings,
                                              use_ctx)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import roofline_terms
from repro_torch.models.transformer import init_lm
from repro_torch.models.whisper import init_encdec
from repro_torch.serving.decode import decode_step, prefill
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import init_train_state, make_train_step

ART = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"


# hillclimb knobs set per-variant by perf_iter.py (default = baseline)
CTX_KW: dict = {}
TRAIN_KW: dict = {}

# operators that move no bytes: views of their input, and allocations that
# write nothing
_NO_TRAFFIC = {torch.ops.aten._unsafe_view.default,
               torch.ops.aten.empty.memory_format,
               torch.ops.aten.empty_strided.default,
               torch.ops.aten.empty_like.default,
               torch.ops.aten.new_empty.default,
               torch.ops.aten.new_empty_strided.default}


def _is_view(func) -> bool:
    """The operator returns an alias of an input that it does not write."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _tensors(tree) -> list:
    """The tensors of ``tree`` in JAX's leaf order."""
    return [x for x in flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


class _ByteCounter(TorchDispatchMode):
    """Adds up every operator's tensor inputs (read once) and outputs
    (written once); views and empty allocations count 0."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func not in _NO_TRAFFIC and not _is_view(func):
            self.bytes += _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        return out


def count_work(fn, *args) -> tuple[int, int]:
    """``(flops, bytes)`` of ``fn(*args)``: FLOPs by
    ``FlopCounterMode`` (K6 by its registered formula, the unmasked pairs),
    bytes by :class:`_ByteCounter`.  The same on ``meta``, CPU and CUDA
    tensors of the same shapes."""
    counter = _ByteCounter()
    with FlopCounterMode(display=False) as flops, counter:
        fn(*args)
    return flops.get_total_flops(), counter.bytes


def _ctx_for(mesh, cfg, shape) -> ShardCtx:
    dp = ("pod", "data") if "pod" in mesh.axis_names else ("data",)
    seq_shard = shape.seq_len >= 32_768 and shape.kind != "decode"
    return ShardCtx(mesh=mesh, dp=dp, tp="model", seq_shard=seq_shard,
                    **CTX_KW)


def _axis_size(ctx, ax) -> int:
    if isinstance(ax, tuple):
        return math.prod(ctx.mesh.shape[a] for a in ax)
    return ctx.mesh.shape[ax]


def _batch_spec(x, ctx) -> tuple:
    """Batch over dp when it divides, else replicated."""
    parts = [None] * x.dim()
    if x.shape[0] % _axis_size(ctx, ctx.dp_spec) == 0:
        parts[0] = ctx.dp_spec
    return tuple(parts)


def _decode_state_spec(x, ctx) -> tuple:
    """Caches: batch over dp when divisible; kv-heads over tp when divisible,
    else cache-seq over tp (few-kv-head archs; uneven shards are padded)."""
    tp_size = _axis_size(ctx, ctx.tp)
    dp_size = _axis_size(ctx, ctx.dp_spec)
    nd = x.dim()
    parts = [None] * nd
    if nd >= 2 and x.shape[1] % dp_size == 0:
        parts[1] = ctx.dp_spec          # (L, B, ...) batch
    if nd == 5:                          # (L, B, W, H, D) kv cache
        if x.shape[3] % tp_size == 0:
            parts[3] = ctx.tp
        else:
            parts[2] = ctx.tp
    elif nd == 4:                        # (L, B, H*, ...) ssm state/conv
        if x.shape[2] % tp_size == 0:
            parts[2] = ctx.tp
        elif x.shape[3] % tp_size == 0:
            parts[3] = ctx.tp
    return tuple(parts)


def _shard_bytes(x: torch.Tensor, spec: tuple, ctx) -> int:
    """Bytes of one device's shard of ``x`` under ``spec`` (padded)."""
    n = 1
    for dim, ax in zip(x.shape, spec):
        n *= dim if ax is None else -(-dim // _axis_size(ctx, ax))
    return n * x.element_size()


def _param_bytes(params, specs, ctx) -> int:
    """One device's bytes of a parameter tree under its
    ``param_shardings`` tree."""
    if isinstance(params, dict):
        return sum(_param_bytes(params[k], specs[k], ctx) for k in params)
    return _shard_bytes(params, specs, ctx)


def _init_fn(cfg):
    return init_encdec if cfg.family == "audio" else init_lm


def _fill(x: torch.Tensor, vocab: int, gen: torch.Generator) -> None:
    """Seeded values for a stand-in on a real device: token ids in
    ``[0, vocab)``, standard normals for embeddings; caches stay zero."""
    if x.dtype == torch.int32:
        x.copy_(torch.randint(0, vocab, x.shape, generator=gen))
    else:
        x.copy_(torch.randn(x.shape, generator=gen))


def build_cell(arch: str, shape_name: str, multi_pod: bool,
               cfg_override=None, batch_override=None, device="meta"):
    """Returns ``(fn, args, arg_bytes_per_device, cfg, shape, meta, mesh,
    ctx)`` for one (arch x shape x mesh): ``fn(*args)`` runs the cell's
    step.  On ``meta`` (the default) the arguments are shapes only; on a
    real ``device`` the parameters are ``init_lm``'s from seed 0 and the
    inputs seeded (a decode cell's cache is the empty ``init_state``)."""
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    ctx = _ctx_for(mesh, cfg, shape)
    kwargs, meta = input_specs(cfg, shape, batch_override, device=device)
    if torch.device(device).type != "meta":
        gen = torch.Generator().manual_seed(1)
        for x in _tensors({k: v for k, v in kwargs.items() if k != "state"}):
            _fill(x, cfg.vocab_size, gen)
    params = _init_fn(cfg)(cfg, 0, device=device)
    pspec = param_shardings(params, ctx, expert_parallel=cfg.expert_parallel)
    pbytes = _param_bytes(params, pspec, ctx)

    if shape.kind == "train":
        opt_cfg = AdamWConfig()
        state = init_train_state(params, opt_cfg)
        step = make_train_step(cfg, opt_cfg, **TRAIN_KW)
        batch = kwargs["batch"]
        # params, mu and nu alike; the step counters replicated
        arg_bytes = (pbytes + 2 * _param_bytes(state.opt.mu, pspec, ctx)
                     + state.opt.step.element_size()
                     + state.step.element_size()
                     + sum(_shard_bytes(x, _batch_spec(x, ctx), ctx)
                           for x in _tensors(batch)))

        def fn(state, batch):
            with use_ctx(ctx):
                return step(state, batch)

        return fn, (state, batch), arg_bytes, cfg, shape, meta, mesh, ctx

    if shape.kind == "prefill":
        tokens = kwargs["tokens"]
        extras = {k: v for k, v in kwargs.items() if k != "tokens"}
        arg_bytes = pbytes + sum(_shard_bytes(x, _batch_spec(x, ctx), ctx)
                                 for x in _tensors(kwargs))

        def fn(params, tokens, extras):
            with use_ctx(ctx):
                return prefill(params, tokens, cfg, **extras)

        return (fn, (params, tokens, extras), arg_bytes, cfg, shape, meta,
                mesh, ctx)

    # decode
    state, token = kwargs["state"], kwargs["token"]
    arg_bytes = (pbytes + _shard_bytes(token, _batch_spec(token, ctx), ctx)
                 + sum(_shard_bytes(x, _decode_state_spec(x, ctx), ctx)
                       for x in _tensors(state)))

    def fn(params, token, state):
        with use_ctx(ctx):
            return decode_step(params, token, state, cfg)

    return fn, (params, token, state), arg_bytes, cfg, shape, meta, mesh, ctx


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             force: bool = False, cfg_override=None,
             variant: str = "") -> dict:
    mesh_name = "multi_pod" if multi_pod else "single_pod"
    cell_id = f"{arch}__{shape_name}__{mesh_name}"
    if variant:
        cell_id += f"__{variant}"
    out_path = ART / f"{cell_id}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = cell_is_applicable(cfg, shape)
    rec = {"cell": cell_id, "arch": arch, "shape": shape_name,
           "mesh": mesh_name}
    if not ok:
        rec.update(status="skipped", reason=why)
        _write(out_path, rec)
        return rec

    t0 = time.time()
    try:
        fn, args, arg_bytes, cfg, shape, meta, mesh, _ = build_cell(
            arch, shape_name, multi_pod, cfg_override=cfg_override)
        flops, nbytes = count_work(fn, *args)
        n_chips = len(mesh.devices)
        mult = 6 if shape.kind == "train" else 2
        model_flops = mult * cfg.active_param_count() * meta["tokens_per_step"]
        rl = roofline_terms({"flops": flops, "bytes accessed": nbytes}, {},
                            n_chips, model_flops=model_flops,
                            tokens_per_step=meta["tokens_per_step"])
        rec.update(status="ok", counted="meta", n_chips=n_chips,
                   flops=flops, bytes=nbytes, model_flops=model_flops,
                   argument_bytes_per_device=arg_bytes,
                   roofline=rl.as_dict(), params=cfg.param_count(),
                   active_params=cfg.active_param_count())
    except Exception as e:   # one cell's failure is recorded, the grid goes on
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-4000:])
    rec["wall_s"] = round(time.time() - t0, 2)
    _write(out_path, rec)
    return rec


def _write(path: Path, rec: dict):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rec, indent=1, default=str))


def vdt_step_fn(variant: str = ""):
    """The paper cell's step ``fn(y_leaf, y0_leaf, a, b, q)`` (one
    ``lp_step_leaforder``), with the reference's variant options."""
    from repro_torch.configs import paper_vdt
    from repro_torch.core.distributed import lp_step_leaforder

    step_kw = {}
    if "sorted" in variant:
        step_kw["sorted_blocks"] = True
    if "bf16" in variant:
        step_kw["carrier_dtype"] = torch.bfloat16
    L = paper_vdt.input_specs()[1]["L"]

    def fn(y_leaf, y0_leaf, a, b, q):
        return lp_step_leaforder(y_leaf, y0_leaf, a, b, q, paper_vdt.ALPHA,
                                 L, **step_kw)

    return fn


def vdt_model_flops() -> int:
    """The matvec's useful work: 2 flops per (block x class)."""
    from repro_torch.configs import paper_vdt

    return (2 * paper_vdt.BLOCKS_PER_POINT * paper_vdt.N_POINTS
            * paper_vdt.N_CLASSES)


def run_vdt_cell(multi_pod: bool, force: bool = False,
                 variant: str = "") -> dict:
    """The paper-representative cell: one distributed VDT LP step
    (N = 2^18 points, though the reference's id says 1M)."""
    from repro_torch.configs import paper_vdt

    mesh_name = "multi_pod" if multi_pod else "single_pod"
    cell_id = f"paper-vdt__lp_1m__{mesh_name}"
    if variant:
        cell_id += f"__{variant}"
    out_path = ART / f"{cell_id}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    rec = {"cell": cell_id, "arch": "paper-vdt", "shape": "lp_1m",
           "mesh": mesh_name}
    t0 = time.time()
    try:
        specs, meta = paper_vdt.input_specs()
        mesh = make_production_mesh(multi_pod=multi_pod)
        n_chips = len(mesh.devices)
        # every device is a data shard: rows over all axes when they divide
        arg_bytes = sum(
            x.numel() * x.element_size()
            // (n_chips if x.shape[0] % n_chips == 0 else 1)
            for x in specs.values())
        flops, nbytes = count_work(vdt_step_fn(variant), *specs.values())
        model_flops = vdt_model_flops()
        rl = roofline_terms({"flops": flops, "bytes accessed": nbytes}, {},
                            n_chips, model_flops=model_flops,
                            tokens_per_step=meta["tokens_per_step"])
        rec.update(status="ok", counted="meta", n_chips=n_chips,
                   flops=flops, bytes=nbytes, model_flops=model_flops,
                   argument_bytes_per_device=arg_bytes,
                   roofline=rl.as_dict())
    except Exception as e:   # recorded, as in run_cell
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-4000:])
    rec["wall_s"] = round(time.time() - t0, 2)
    _write(out_path, rec)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS) + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    t0 = time.time()
    results = []
    if args.all or args.arch is None:
        for mp in meshes:
            rec = run_vdt_cell(mp, force=args.force)
            print(f"[{rec['status']:7s}] {rec['cell']}", flush=True)
            results.append(rec)
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_cell(arch, shape, mp, force=args.force)
                status = rec["status"]
                extra = ""
                if status == "ok":
                    rl = rec["roofline"]
                    extra = (f" counted={rec['counted']}"
                             f" wall={rec['wall_s']}s"
                             f" bottleneck={rl['bottleneck']}"
                             f" step={rl['step_time_s']:.4f}s"
                             f" mfu={rl['mfu_at_roofline']:.2%}")
                elif status == "error":
                    extra = " " + rec["error"][:120]
                print(f"[{status:7s}] {rec['cell']}{extra}", flush=True)
                results.append(rec)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"done: {n_ok} ok, {n_skip} skipped-by-design, {n_err} errors "
          f"in {time.time() - t0:.1f} s")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
