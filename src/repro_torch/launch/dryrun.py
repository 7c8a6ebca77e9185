"""``repro_torch/launch/dryrun.py`` ↔ ``repro/launch/dryrun.py``.

The dry run of every (architecture x shape x mesh) cell and of the paper's
own cell, at production size, on any host:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

The reference lowers and compiles each cell for a 16 x 16 (or 2 x 16 x 16)
TPU mesh on 512 forced XLA host devices and reads FLOPs and bytes from
``compiled.cost_analysis()``.  PyTorch eager has no compiled program, so the
port *counts* the step's work by running it once on ``meta`` tensors at the
cell's full shape and depth: no storage, no values, and K6 one operator
with its FLOP formula; the roofline prices the counts at the H100's
constants (``launch/roofline.py``).  Each device's share of the step's arguments is
planned on ``launch/mesh.py::make_production_mesh`` through the reference's
sharding rules (``distributed/sharding.py::param_shardings``).

Bytes are eager and unfused: every operator's tensor inputs read once and
its outputs written once (views count 0).  That is an upper bound on the
traffic a fused program moves, not XLA's "bytes accessed".

Every family's cells (``SHARDED_FAMILIES``: dense, MoE, SSM, hybrid,
vlm, audio) are counted as the sharded program, per device, as the
reference compiles them (``seq_shard`` at S >= 32,768 outside decode, as
the reference's ``_ctx_for`` sets it: the residual stream sequence-sharded,
``distributed/sharding.py``): the step runs with its parameters as DTensors
over the production mesh (``launch/mesh.py::production_device_mesh``, a
fake process group of 256 or 512 ranks that this one process drives as
rank 0, device type ``cuda``) and its inputs (tokens, patch and frame
embeddings) sharded by batch, a decode cell's every cache leaf by the
reference's decode-state rule (:func:`build_sharded_cell`), and
:func:`count_sharded` counts rank 0's local work *below* DTensor: each
shard is a :class:`Counting` tensor, whose ``__torch_dispatch__`` adds up
every local operator's FLOPs (``torch.utils.flop_counter``'s formulas,
K6's included: a query stripe of ``attn_seq_shard`` counted as the busiest
stripe of its width, so that rank 0's count is the slowest rank's) and
bytes, and records every ``_c10d_functional``
collective with its result's bytes; a dispatch mode adds the plain
tensors' operators (positions, masks).  A mode above DTensor would count
global work, not one device's.  The paper cell (:func:`run_vdt_cell`) is
the row-sharded LP step of ``core/distributed.py`` counted so, its inputs'
rows over the whole mesh.  The roofline then globalises as the reference
does: FLOPs and bytes times the chips, collective bytes once
(``launch/roofline.py::collective_bytes``); every record reads
``sharded: true``.  :func:`build_cell` and :func:`count_work` (the step
unsharded, on one device) are what ``chip_smoke.py`` runs on the card at a
reduced batch.  Not carried over (``README.md``): the compile proof,
XLA's fused byte count, the L = 2 / 4 marginal extrapolation and
``memory_analysis``'s temporary bytes.

Records go to ``artifacts/dryrun_torch/{cell}.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch._device import is_dtensor
from repro_torch._tree import flatten, map_leaves
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, cell_is_applicable, input_specs
from repro_torch.distributed.sharding import (ShardCtx, decode_state_spec,
                                              param_shardings, placements,
                                              shard_params, use_ctx)
from repro_torch.launch.mesh import (axis_sizes, fake_process_group,
                                     mesh_axis_names,
                                     make_production_mesh,
                                     production_device_mesh)
from repro_torch.launch.roofline import collective_bytes, roofline_terms
from repro_torch.models.transformer import init_lm
from repro_torch.models.whisper import init_encdec
from repro_torch.serving.decode import decode_step, prefill
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import init_train_state, make_train_step

ART = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"


# hillclimb knobs set per-variant by perf_iter.py (default = baseline)
CTX_KW: dict = {}
TRAIN_KW: dict = {}

# operators that move no bytes: views of their input, allocations that
# write nothing, and a Python scalar made a 0-dim tensor (on the host for a
# CPU or CUDA operand, on the device for a meta one: counted alike as 0)
_NO_TRAFFIC = {torch.ops.aten._unsafe_view.default,
               torch.ops.aten.empty.memory_format,
               torch.ops.aten.empty_strided.default,
               torch.ops.aten.empty_like.default,
               torch.ops.aten.new_empty.default,
               torch.ops.aten.new_empty_strided.default,
               torch.ops.aten.lift_fresh.default,
               torch.ops.aten.scalar_tensor.default}


def _is_view(func) -> bool:
    """The operator returns an alias of an input that it does not write."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _tensors(tree) -> list:
    """The tensors of ``tree`` in JAX's leaf order."""
    return [x for x in flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _tensor_bytes(tree) -> int:
    """Bytes of the tensors in ``tree`` (nested tuples, lists and dicts)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (tuple, list)):
        return sum(_tensor_bytes(x) for x in tree)
    if isinstance(tree, dict):
        return sum(_tensor_bytes(x) for x in tree.values())
    return 0


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


# the families whose cells are counted as the sharded program
SHARDED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")

# collectives (``_c10d_functional``'s, and DTensor's all-to-all between two
# shardings of one mesh dimension) by the reference's HLO kind; the ops that
# only wait for or wrap a collective's result move nothing
_COLLECTIVES = {
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_reduce_": "all-reduce",
    "_c10d_functional::all_reduce_coalesced": "all-reduce",
    "_c10d_functional::all_reduce_coalesced_": "all-reduce",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional::all_to_all_single": "all-to-all",
    "_dtensor::shard_dim_alltoall": "all-to-all"}
_COLLECTIVE_WAITS = {"_c10d_functional::wait_tensor",
                     "_c10d_functional::_wrap_tensor_autograd"}


class DeviceWork:
    """One device's counted work: FLOPs (``k6_flops`` of them K6's), bytes,
    and its collectives as ``(kind, result bytes)`` records."""

    def __init__(self):
        self.flops = 0
        self.k6_flops = 0
        self.bytes = 0
        self.collectives: list = []

    def add(self, func, args, kwargs, out) -> None:
        """One operator on plain (unwrapped) tensors."""
        name = func._overloadpacket._qualified_op_name
        if name in _COLLECTIVES:
            self.collectives.append((_COLLECTIVES[name], _tensor_bytes(out)))
            return
        if name in _COLLECTIVE_WAITS:
            return
        if func.namespace == "_c10d_functional":
            raise NotImplementedError(f"no HLO kind for collective {func}")
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            flops = int(formula(*args, **kwargs, out_val=out))
            self.flops += flops
            if name == "repro_torch::flash_attention_fwd":
                self.k6_flops += flops
        if func not in _NO_TRAFFIC and not _is_view(func):
            self.bytes += _tensor_bytes((args, kwargs)) + _tensor_bytes(out)


class Counting(torch.Tensor):
    """A shard (a DTensor's local tensor) that adds every operator run on it
    to a :class:`DeviceWork`, then runs it on the tensor it wraps."""

    @staticmethod
    def __new__(cls, elem: torch.Tensor, work: DeviceWork):
        t = torch.Tensor._make_wrapper_subclass(
            cls, elem.shape, strides=elem.stride(),
            storage_offset=elem.storage_offset(), dtype=elem.dtype,
            device=elem.device, requires_grad=elem.requires_grad)
        t.elem, t.work = elem, work
        return t

    def __repr__(self):
        return f"Counting({self.elem!r})"

    def __tensor_flatten__(self):
        return ["elem"], self.work

    @staticmethod
    def __tensor_unflatten__(inner, work, outer_size, outer_stride):
        return Counting(inner["elem"], work)

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        if any(not issubclass(t, Counting) for t in types):
            return NotImplemented   # a DTensor among the arguments goes first
        found: list = []
        args = _unwrap(args, found)
        kwargs = _unwrap(kwargs or {}, found)
        out = func(*args, **kwargs)
        found[0].add(func, args, kwargs, out)
        return _wrap(out, found[0])


def _unwrap(x, found: list):
    """``x`` (nested tuples, lists, dicts) with each shard's wrapped tensor
    in its place; the shards' ``DeviceWork`` appended to ``found``."""
    if isinstance(x, Counting):
        found.append(x.work)
        return x.elem
    if type(x) in (tuple, list):
        return type(x)(_unwrap(y, found) for y in x)
    if type(x) is dict:
        return {k: _unwrap(v, found) for k, v in x.items()}
    return x


def _wrap(x, work: DeviceWork):
    if isinstance(x, torch.Tensor):
        return Counting(x, work)
    if type(x) in (tuple, list):
        return type(x)(_wrap(y, work) for y in x)
    return x


def _any_sharded(x) -> bool:
    """``x`` (nested tuples, lists, dicts) holds a shard or a DTensor."""
    if isinstance(x, torch.Tensor):
        return isinstance(x, Counting) or is_dtensor(x)
    if type(x) in (tuple, list):
        return any(_any_sharded(y) for y in x)
    if type(x) is dict:
        return any(_any_sharded(y) for y in x.values())
    return False


class _PlainOps(TorchDispatchMode):
    """Adds the operators whose tensors are all plain (neither DTensors nor
    shards: the positions, masks and rotary tables every rank makes); the
    rest it passes on, to DTensor and then to the shards."""

    def __init__(self, work: DeviceWork):
        super().__init__()
        self.work = work

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not (_any_sharded(args) or _any_sharded(kwargs)):
            self.work.add(func, args, kwargs, out)
        return out


def _counting(tree, work: DeviceWork):
    """``tree`` with every DTensor's shard and every plain tensor wrapped in
    :class:`Counting`."""
    from torch.distributed.tensor import DTensor

    def wrap(x):
        if not isinstance(x, torch.Tensor):
            return x
        if is_dtensor(x):
            return DTensor.from_local(
                Counting(x.to_local(), work), x.device_mesh, x.placements,
                run_check=False, shape=x.shape, stride=x.stride())
        return Counting(x, work)

    return map_leaves(wrap, tree)


def count_sharded(fn, *args) -> DeviceWork:
    """One device's (rank 0's) work in ``fn(*args)``, its arguments'
    DTensors sharded over a mesh of a (fake) process group: counted on
    their shards, below DTensor.  The same on ``meta`` and CUDA shards."""
    work = DeviceWork()
    args = _counting(args, work)
    with _PlainOps(work):
        fn(*args)
    return work


def _ctx_for(mesh, cfg, shape) -> ShardCtx:
    dp = ("pod", "data") if "pod" in mesh_axis_names(mesh) else ("data",)
    seq_shard = shape.seq_len >= 32_768 and shape.kind != "decode"
    return ShardCtx(mesh=mesh, dp=dp, tp="model", seq_shard=seq_shard,
                    **CTX_KW)


def _axis_size(ctx, ax) -> int:
    sizes = axis_sizes(ctx.mesh)
    if isinstance(ax, tuple):
        return math.prod(sizes[a] for a in ax)
    return sizes[ax]


def _batch_spec(x, ctx) -> tuple:
    """Batch over dp when it divides, else replicated."""
    parts = [None] * x.dim()
    if x.shape[0] % _axis_size(ctx, ctx.dp_spec) == 0:
        parts[0] = ctx.dp_spec
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


def _step_fn(cfg, shape, ctx):
    """The cell's step, run under ``use_ctx(ctx)``: a train step over
    ``(state, batch)``, a prefill over ``(params, tokens, extras)`` or a
    decode step over ``(params, token, state)``."""
    if shape.kind == "train":
        step = make_train_step(cfg, AdamWConfig(), **TRAIN_KW)

        def fn(state, batch):
            with use_ctx(ctx):
                return step(state, batch)
    elif shape.kind == "prefill":
        def fn(params, tokens, extras):
            with use_ctx(ctx):
                return prefill(params, tokens, cfg, **extras)
    else:
        def fn(params, token, state):
            with use_ctx(ctx):
                return decode_step(params, token, state, cfg)
    return fn


def _cell_inputs(arch, shape_name, cfg_override, batch_override, device):
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    shape = SHAPES[shape_name]
    kwargs, meta = input_specs(cfg, shape, batch_override, device=device)
    if torch.device(device).type != "meta":
        gen = torch.Generator().manual_seed(1)
        for x in _tensors({k: v for k, v in kwargs.items() if k != "state"}):
            _fill(x, cfg.vocab_size, gen)
    params = _init_fn(cfg)(cfg, 0, device=device)
    return cfg, shape, kwargs, meta, params


def build_cell(arch: str, shape_name: str, multi_pod: bool,
               cfg_override=None, batch_override=None, device="meta"):
    """Returns ``(fn, args, arg_bytes_per_device, cfg, shape, meta, mesh,
    ctx)`` for one (arch x shape x mesh): ``fn(*args)`` runs the cell's
    step on one device, unsharded.  On ``meta`` (the default) the arguments
    are shapes only; on a real ``device`` the parameters are ``init_lm``'s
    from seed 0 and the inputs seeded (a decode cell's cache is the empty
    ``init_state``).  ``arg_bytes_per_device`` is each device's share of
    the arguments under the reference's shardings on the production
    mesh."""
    cfg, shape, kwargs, meta, params = _cell_inputs(
        arch, shape_name, cfg_override, batch_override, device)
    mesh = make_production_mesh(multi_pod=multi_pod)
    ctx = _ctx_for(mesh, cfg, shape)
    pspec = param_shardings(params, ctx, expert_parallel=cfg.expert_parallel)
    pbytes = _param_bytes(params, pspec, ctx)
    fn = _step_fn(cfg, shape, ctx)

    if shape.kind == "train":
        state = init_train_state(params, AdamWConfig())
        batch = kwargs["batch"]
        # params, mu and nu alike; the step counters replicated
        arg_bytes = (pbytes + 2 * _param_bytes(state.opt.mu, pspec, ctx)
                     + state.opt.step.element_size()
                     + state.step.element_size()
                     + sum(_shard_bytes(x, _batch_spec(x, ctx), ctx)
                           for x in _tensors(batch)))
        return fn, (state, batch), arg_bytes, cfg, shape, meta, mesh, ctx

    if shape.kind == "prefill":
        tokens = kwargs["tokens"]
        extras = {k: v for k, v in kwargs.items() if k != "tokens"}
        arg_bytes = pbytes + sum(_shard_bytes(x, _batch_spec(x, ctx), ctx)
                                 for x in _tensors(kwargs))
        return (fn, (params, tokens, extras), arg_bytes, cfg, shape, meta,
                mesh, ctx)

    # decode
    state, token = kwargs["state"], kwargs["token"]
    arg_bytes = (pbytes + _shard_bytes(token, _batch_spec(token, ctx), ctx)
                 + sum(_shard_bytes(x, decode_state_spec(x.shape, ctx), ctx)
                       for x in _tensors(state)))
    return fn, (params, token, state), arg_bytes, cfg, shape, meta, mesh, ctx


def build_sharded_cell(arch: str, shape_name: str, multi_pod: bool,
                       cfg_override=None, batch_override=None,
                       device="meta", mesh=None):
    """:func:`build_cell`'s step as the SPMD program: the parameters (and a
    train cell's moments) DTensors under ``param_shardings``, the inputs
    sharded by batch over the data axes, a decode cell's cache by
    ``decode_state_spec``, on ``mesh`` (default: the production mesh as
    a ``DeviceMesh`` of device type ``cuda``; a default process group of
    its size must be set up).  Returns ``(fn, args, arg_bytes_per_device,
    cfg, shape, meta, mesh, ctx)``."""
    from torch.distributed.tensor import distribute_tensor

    cfg, shape, kwargs, meta, params = _cell_inputs(
        arch, shape_name, cfg_override, batch_override, device)
    if mesh is None:
        mesh = production_device_mesh(multi_pod=multi_pod)
    ctx = _ctx_for(mesh, cfg, shape)
    pspec = param_shardings(params, ctx, expert_parallel=cfg.expert_parallel)
    pbytes = _param_bytes(params, pspec, ctx)
    fn = _step_fn(cfg, shape, ctx)

    def dist(x, spec):
        return distribute_tensor(x, mesh, placements(spec, mesh),
                                 src_data_rank=None)

    sharded = shard_params(params, ctx,
                           expert_parallel=cfg.expert_parallel)
    if shape.kind == "train":
        state = init_train_state(sharded, AdamWConfig())
        batch = {k: dist(x, _batch_spec(x, ctx))
                 for k, x in kwargs["batch"].items()}
        arg_bytes = (3 * pbytes + state.opt.step.element_size()
                     + state.step.element_size()
                     + sum(_shard_bytes(x, _batch_spec(x, ctx), ctx)
                           for x in _tensors(kwargs["batch"])))
        return fn, (state, batch), arg_bytes, cfg, shape, meta, mesh, ctx
    if shape.kind == "prefill":
        tokens = kwargs["tokens"]
        extras = {k: dist(v, _batch_spec(v, ctx)) for k, v in kwargs.items()
                  if k != "tokens"}
        arg_bytes = pbytes + sum(_shard_bytes(x, _batch_spec(x, ctx), ctx)
                                 for x in _tensors(kwargs))
        return (fn, (sharded, dist(tokens, _batch_spec(tokens, ctx)),
                     extras), arg_bytes, cfg, shape, meta, mesh, ctx)
    state, token = kwargs["state"], kwargs["token"]
    arg_bytes = (pbytes + _shard_bytes(token, _batch_spec(token, ctx), ctx)
                 + sum(_shard_bytes(x, decode_state_spec(x.shape, ctx), ctx)
                       for x in _tensors(state)))
    # every cache leaf by the reference's rule; the positions (L,) stay
    # plain, as prefill makes them
    state = map_leaves(
        lambda x: dist(x, decode_state_spec(x.shape, ctx))
        if isinstance(x, torch.Tensor) and x.dim() > 1 else x, state)
    return (fn, (sharded, dist(token, _batch_spec(token, ctx)), state),
            arg_bytes, cfg, shape, meta, mesh, ctx)


@contextlib.contextmanager
def production_group(multi_pod: bool):
    """A fake default process group of the production mesh's size for the
    block, unless one of that size is already set up (``main`` sets one up
    around each mesh's part of the grid)."""
    n = math.prod(make_production_mesh(multi_pod=multi_pod).sizes)
    if torch.distributed.is_initialized() and \
            torch.distributed.get_world_size() == n:
        yield
        return
    with fake_process_group(n):
        yield


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
        if cfg.family not in SHARDED_FAMILIES:
            raise NotImplementedError(f"no sharded program for the "
                                      f"{cfg.family!r} family")
        n_chips = len(make_production_mesh(multi_pod=multi_pod).devices)
        with production_group(multi_pod):
            fn, args, arg_bytes, cfg, shape, meta, _, ctx = \
                build_sharded_cell(arch, shape_name, multi_pod,
                                   cfg_override=cfg_override)
            work = count_sharded(fn, *args)
        # per device: globalised as the reference does, collectives once
        flops, nbytes = work.flops * n_chips, work.bytes * n_chips
        coll = collective_bytes(work.collectives)
        mult = 6 if shape.kind == "train" else 2
        model_flops = mult * cfg.active_param_count() * meta["tokens_per_step"]
        rl = roofline_terms({"flops": flops, "bytes accessed": nbytes},
                            coll, n_chips, model_flops=model_flops,
                            tokens_per_step=meta["tokens_per_step"])
        rec.update(status="ok", counted="meta", sharded=True,
                   n_chips=n_chips, flops=flops, bytes=nbytes,
                   model_flops=model_flops, collectives=coll,
                   argument_bytes_per_device=arg_bytes,
                   roofline=rl.as_dict(), params=cfg.param_count(),
                   active_params=cfg.active_param_count(),
                   flops_per_device=work.flops, bytes_per_device=work.bytes,
                   k6_flops_per_device=work.k6_flops, seq_shard=ctx.seq_shard,
                   attn_seq_shard=ctx.attn_seq_shard)
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


def vdt_sharded_inputs(mesh, device="meta") -> tuple:
    """The paper cell's inputs as the reference lays them out: every one
    split by rows over all of ``mesh``'s dimensions (``shard_rows``), on
    ``device`` (``meta``: shapes only; else seeded, as on the card)."""
    from repro_torch.configs import paper_vdt
    from repro_torch.core.distributed import shard_rows

    specs = (paper_vdt.input_specs()[0] if torch.device(device).type ==
             "meta" else vdt_seeded_inputs(device=device))
    return tuple(shard_rows(x, mesh) for x in specs.values())


def vdt_seeded_inputs(seed: int = 23, device="cpu") -> dict:
    """The paper cell's inputs at full size with seeded values: ``a`` and
    ``b`` over the tree's node ids and ``q`` and the labels in [0, 1) (not
    a fitted tree), drawn on the CPU and moved to ``device``."""
    from repro_torch.configs import paper_vdt

    specs, meta = paper_vdt.input_specs()
    n_nodes = (1 << (meta["L"] + 1)) - 1
    g = torch.Generator().manual_seed(seed)
    return {k: (torch.randint(0, n_nodes, x.shape, generator=g,
                              dtype=x.dtype) if k in ("a", "b")
                else torch.rand(x.shape, generator=g)).to(device)
            for k, x in specs.items()}


def run_vdt_cell(multi_pod: bool, force: bool = False,
                 variant: str = "") -> dict:
    """The paper-representative cell: one distributed VDT LP step
    (N = 2^18 points, though the reference's id says 1M), counted per
    device as the row-sharded SPMD program over the production mesh
    (``core/distributed.py``), as the reference compiles it with every
    input's rows over all mesh axes."""
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
        n_chips = len(make_production_mesh(multi_pod=multi_pod).devices)
        # every device is a data shard: rows over all axes when they divide
        arg_bytes = sum(
            x.numel() * x.element_size()
            // (n_chips if x.shape[0] % n_chips == 0 else 1)
            for x in specs.values())
        with production_group(multi_pod):
            mesh = production_device_mesh(multi_pod=multi_pod)
            work = count_sharded(vdt_step_fn(variant),
                                 *vdt_sharded_inputs(mesh))
        flops, nbytes = work.flops * n_chips, work.bytes * n_chips
        coll = collective_bytes(work.collectives)
        model_flops = vdt_model_flops()
        rl = roofline_terms({"flops": flops, "bytes accessed": nbytes}, coll,
                            n_chips, model_flops=model_flops,
                            tokens_per_step=meta["tokens_per_step"])
        rec.update(status="ok", counted="meta", sharded=True,
                   n_chips=n_chips, flops=flops, bytes=nbytes,
                   model_flops=model_flops, collectives=coll,
                   argument_bytes_per_device=arg_bytes,
                   roofline=rl.as_dict(), flops_per_device=work.flops,
                   bytes_per_device=work.bytes)
    except Exception as e:   # recorded, as in run_cell
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-4000:])
    rec["wall_s"] = round(time.time() - t0, 2)
    _write(out_path, rec)
    return rec


def _describe(rec: dict) -> str:
    if rec["status"] == "ok":
        rl = rec["roofline"]
        return (f" counted={rec['counted']} sharded={rec['sharded']}"
                f" wall={rec['wall_s']}s bottleneck={rl['bottleneck']}"
                f" step={rl['step_time_s']:.4f}s"
                f" mfu={rl['mfu_at_roofline']:.2%}")
    if rec["status"] == "error":
        return " " + rec["error"][:120]
    return ""


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
            print(f"[{rec['status']:7s}] {rec['cell']}{_describe(rec)}",
                  flush=True)
            results.append(rec)
    for mp in meshes:
        # the fake process group the sharded cells are counted over, set up
        # once around this mesh's part of the grid
        with production_group(mp):
            for arch in archs:
                for shape in shapes:
                    rec = run_cell(arch, shape, mp, force=args.force)
                    print(f"[{rec['status']:7s}] {rec['cell']}"
                          f"{_describe(rec)}", flush=True)
                    results.append(rec)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"done: {n_ok} ok, {n_skip} skipped-by-design, {n_err} errors "
          f"in {time.time() - t0:.1f} s")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
