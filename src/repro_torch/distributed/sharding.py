"""``repro_torch/distributed/sharding.py`` ↔ ``repro/distributed/sharding.py``
(its leaf-order part, ``LEAF_AXIS``, ``leaf_mesh`` and ``leaf_sharding``).

The sharded serving engine (``serving/_sharded.py``) partitions LEAF-ORDER
arrays — label stacks ``(n_leaves, K)``, the leaf mask — row-wise over a 1-D
mesh of shards.  A complete perfect-binary-tree level always has a
power-of-two row count, so a power-of-two shard count divides it evenly and
every shard owns one aligned subtree of the partition tree.

The reference's mesh is a ``jax.sharding.Mesh`` driven by one process: its
collectives are parts of one ``shard_map`` program.  The port keeps that
single-controller design: a :class:`LeafMesh` is an ordered tuple of torch
devices that one process drives, a shard's body runs on its own device, and
an all-gather is a concatenation of the shards' tensors moved to each
shard's device.  A device may hold more than one shard, which plays the part
of the reference's forced host device count: the CPU tests run 2, 4 and 8
shards on ``["cpu"] * D``, the card runs them on ``cuda:0``.

The LM half (the reference's GSPMD sharding, as ``torch.distributed.tensor``
DTensors): :class:`ShardCtx` over a mesh, ``current_ctx`` / ``use_ctx``
(thread-local), ``shard_act``, ``shard_attn_logits``, ``param_shardings``,
``placements`` and ``shard_params``.  ``param_shardings`` gives, per
parameter, the reference's ``PartitionSpec`` as a tuple of axis names (or
tuples of them) and ``None``, one entry a dimension: the same path-name
rules, stacked-layer leading ``None`` and divisibility guard.  Over a
``DeviceMesh`` (``launch/mesh.py::device_mesh``), ``shard_params`` makes
every parameter a DTensor with those placements, and the model code's
``shard_act(x, kind)`` redistributes a DTensor activation to the spec of
``kind``, where the reference's ``with_sharding_constraint`` pins it: the
collectives that DTensor then inserts (an all-reduce of a row-parallel
product's ``Partial`` sum, an all-gather of FSDP weights) are the SPMD
program's.  A plain tensor, a ``launch.mesh.LocalMesh`` context (one
controller: nothing to constrain) or no context leaves ``x`` as it is; an
unknown ``kind`` raises ``KeyError`` whenever a context is active.
``decode_state_spec`` / ``shard_state`` lay a decode cache out by the
reference's rule (KV and SSM caches alike), and ``shard_like`` lines an
operand up with another before an operator runs on the shards.

Sequence parallelism (the reference's ``seq_shard``, which its dry run sets
for every cell of S >= 32,768 that is not a decode): ``"btd"`` is
``(dp, model, None)``, the residual stream's sequence over ``model``.  The
port's form of what GSPMD inserts around a projection is Megatron's:
:func:`gather_seq` all-gathers the sequence before a column-parallel product
(every block's entry: attention, MLP, MoE, SSM, cross-attention, the
unembedding) and reduce-scatters its gradient back; a row-parallel
product's ``Partial`` sum reaching ``shard_act(..., "btd")`` is
reduce-scattered to the sequence shards, and that constraint's gradient is
all-gathered.  A product then never flattens a (batch, sequence) pair that
is sharded on both, which DTensor refuses in some PyTorch versions.  With
``attn_seq_shard`` the attention's query sequence goes over ``model`` when
the heads do not divide it (:func:`attn_stripe_dim`, the reference's
``shard_attn_logits`` rule), as K6's query stripes
(``kernels/flash_attention/ops.py::flash_attention_striped``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Optional, Tuple

import torch

from repro_torch._device import is_dtensor, resolve_device
from repro_torch.launch.mesh import LocalMesh, axis_sizes, mesh_axis_names

__all__ = ["LEAF_AXIS", "LeafMesh", "LeafSharding", "ShardCtx", "current_ctx",
           "leaf_mesh", "leaf_sharding", "param_shardings", "shard_act",
           "use_ctx"]

_tls = threading.local()

LEAF_AXIS = "leaves"


@dataclasses.dataclass(frozen=True)
class LeafMesh:
    """An ordered, power-of-two tuple of shard devices along one axis."""

    devices: tuple
    axis: str = LEAF_AXIS

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct_devices(self) -> tuple:
        """The mesh's devices without repeats, in first-use order."""
        return tuple(dict.fromkeys(self.devices))


@dataclasses.dataclass(frozen=True)
class LeafSharding:
    """The row-stripe layout of leaf-order arrays over a :class:`LeafMesh`:
    shard ``s`` of ``D`` holds rows ``[s * R / D, (s + 1) * R / D)`` of an
    ``R``-row array (the reference's ``NamedSharding(mesh, P(axis, None))``)."""

    mesh: LeafMesh

    def stripes(self, n_rows: int) -> list:
        """``(start, stop)`` of each shard's rows; ``n_rows`` must divide."""
        d = self.mesh.size
        if n_rows % d:
            raise ValueError(f"{n_rows} rows do not divide over {d} shards")
        rps = n_rows // d
        return [(s * rps, (s + 1) * rps) for s in range(d)]

    def scatter(self, x: torch.Tensor) -> list:
        """Each shard's row stripe of ``x``, on the shard's device."""
        return [x[a:b].to(dev) for (a, b), dev in
                zip(self.stripes(x.shape[0]), self.mesh.devices)]

    def gather(self, parts, device) -> torch.Tensor:
        """The all-gather: the shards' stripes concatenated on ``device``."""
        return torch.cat([p.to(device) for p in parts], dim=0)


def leaf_mesh(devices=None, *, axis: str = LEAF_AXIS) -> LeafMesh:
    """1-D mesh over ``devices`` (default: every visible CUDA device).

    The count must be a power of two: each shard then owns a whole subtree
    of the (perfect binary) partition tree, which is what makes the sharded
    CollectUp/DistributeDown decomposition exact.  Without a card the
    default raises ``RuntimeError``, as every entry point of the port does;
    pass ``devices=["cpu"] * D`` to run on the CPU.
    """
    if devices is None:
        resolve_device(None)  # raises without a card: no CPU fallback
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [resolve_device(d) for d in devices]
    n = len(devs)
    if n < 1 or n & (n - 1):
        raise ValueError(
            f"leaf_mesh wants a power-of-two device count, got {n}")
    return LeafMesh(devices=tuple(devs), axis=axis)


def leaf_sharding(mesh: LeafMesh) -> LeafSharding:
    """Row-stripe layout for leaf-order ``(n_leaves, K)`` arrays."""
    return LeafSharding(mesh)


# ------------------------------------------------------------------ LM side

@dataclasses.dataclass(frozen=True)
class ShardCtx:
    mesh: object                          # DeviceMesh, or a LocalMesh layout
    dp: Tuple[str, ...] = ("data",)       # batch / FSDP axes
    tp: str = "model"                     # tensor-parallel axis
    seq_shard: bool = False               # sequence parallelism for long ctx
    fsdp: bool = True                     # shard params over dp too
    # when n_heads % tp_size != 0, shard the S^2 attention scores over the
    # query sequence instead of the heads
    attn_seq_shard: bool = False

    @property
    def dp_spec(self):
        return self.dp if len(self.dp) > 1 else self.dp[0]

    @property
    def tp_size(self) -> int:
        return axis_sizes(self.mesh)[self.tp]

    @property
    def spmd(self) -> bool:
        """The mesh is a ``DeviceMesh``: tensors are sharded over it."""
        return not isinstance(self.mesh, LocalMesh)


def current_ctx() -> Optional[ShardCtx]:
    return getattr(_tls, "ctx", None)


@contextlib.contextmanager
def use_ctx(ctx: Optional[ShardCtx]):
    """``ctx`` active in this thread for the block.  Over a ``DeviceMesh``
    the block also lets DTensor ops take plain tensors as replicated: the
    model code's own positions, masks and rotary tables, which every rank
    makes alike.  That switch is DTensor's, one for the process
    (``implicit_replication``, whose own exit turns it off); the block
    restores the state it found, so that a block nested in another (a
    recompute under ``remat``) does not end the enclosing one's."""
    prev = current_ctx()
    _tls.ctx = ctx
    try:
        if ctx is not None and ctx.spmd:
            from torch.distributed.tensor import DTensor

            dispatcher = DTensor._op_dispatcher
            was = dispatcher._allow_implicit_replication
            dispatcher._allow_implicit_replication = True
            try:
                yield
            finally:
                dispatcher._allow_implicit_replication = was
        else:
            yield
    finally:
        _tls.ctx = prev


_ACT_SPECS = {
    # kind -> fn(ctx) -> spec
    "btd": lambda c: (c.dp_spec, c.tp if c.seq_shard else None, None),
    "btv": lambda c: (c.dp_spec, None, c.tp),          # logits: vocab sharded
    "bthd": lambda c: (c.dp_spec, None, c.tp, None),   # heads sharded
    "btf": lambda c: (c.dp_spec, None, c.tp),          # mlp hidden
    "bd": lambda c: (c.dp_spec, None),
    "cache": lambda c: (c.dp_spec, None, c.tp, None),  # (B, W, Hkv, D)
    "cache_seq": lambda c: (c.dp_spec, c.tp, None, None),  # few kv heads
    "ecd": lambda c: (c.tp, None, None),               # EP expert buffers
}


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements, one a mesh dimension, of a per-dimension spec
    (``param_shardings``' or ``_ACT_SPECS``' form): a tensor dimension
    sharded over an axis is ``Shard(dim)`` on that mesh dimension, over a
    tuple of axes ``Shard(dim)`` on each (the first axis outermost, as
    JAX splits it); every other mesh dimension ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh_axis_names(mesh)
    out = [Replicate()] * len(names)
    for dim, ax in enumerate(spec):
        for a in (() if ax is None else ax if isinstance(ax, tuple)
                  else (ax,)):
            out[names.index(a)] = Shard(dim)
    return tuple(out)


class _Constrain(torch.autograd.Function):
    """``x`` redistributed to ``want``, and its cotangent to ``grad`` (by
    default ``want`` too): what ``with_sharding_constraint`` does to a
    value and, in the transpose, to its cotangent (a ``Partial`` gradient
    of the residual stream is all-reduced here, as GSPMD reduces it; a
    masked-partial embedding's forward reduction gets a gradient it can
    take)."""

    @staticmethod
    def forward(ctx, x, mesh, want, grad=None):
        ctx.mesh, ctx.grad = mesh, want if grad is None else grad
        return _dense(x.redistribute(mesh, want))

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.grad:
            g = _dense(g.redistribute(ctx.mesh, ctx.grad))
        return g, None, None, None


def _dense(t):
    """The DTensor ``t`` with a contiguous local shard: gathering an uneven
    shard (a sequence the mesh does not divide) leaves a padded buffer's
    view in some PyTorch versions, which a product's view then refuses."""
    local = t.to_local()
    if local.is_contiguous():
        return t
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local.contiguous(), t.device_mesh, t.placements,
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def _redistribute(x, spec: tuple, ctx: ShardCtx, seq: bool = False):
    """``x`` constrained to ``spec``; ``seq``: ``spec`` shards the sequence
    (dimension 1) of an activation."""
    want = placements(spec, ctx.mesh)
    if tuple(x.placements) == want:
        return x
    if seq and not any(p.is_shard(1) for p in x.placements):
        # onto the sequence shards (a reduce-scatter of a row-parallel
        # product's Partial sum, or a replica's slice): the gradient comes
        # back with its sequence whole, where a Partial's gradient is
        # replicated, as the product's backward takes it
        from torch.distributed.tensor import Replicate
        grad = tuple(Replicate() if p.is_partial() else p
                     for p in x.placements)
        return _Constrain.apply(x, ctx.mesh, want, grad)
    return _Constrain.apply(x, ctx.mesh, want)


def shard_act(x: torch.Tensor, kind: str, lead: int = 0) -> torch.Tensor:
    """The reference's named activation constraint.  With a context active
    the spec of ``kind`` is looked up (``KeyError`` for an unknown one); a
    DTensor ``x`` under a ``DeviceMesh`` context is redistributed to it (a
    ``Partial`` sum is reduced, a dimension sharded elsewhere moved), any
    other ``x`` is returned as it is.  ``lead`` unsharded dimensions come
    first (a stack over layers)."""
    ctx = current_ctx()
    if ctx is None:
        return x
    spec = (None,) * lead + _ACT_SPECS[kind](ctx)
    if not (ctx.spmd and is_dtensor(x)):
        return x
    return _redistribute(x, spec, ctx,
                         seq=kind == "btd" and ctx.seq_shard and not lead)


def gather_seq(x: torch.Tensor) -> torch.Tensor:
    """A DTensor activation (B, S, ...) whose sequence is sharded (Megatron's
    sequence parallelism: ``"btd"`` under ``seq_shard``, or a query
    stripe's output) all-gathered on it before a product, every other
    placement kept; its gradient goes back to ``x``'s placements (a
    column-parallel product's ``Partial`` gradient reduce-scattered to the
    sequence shards).  Anything else is returned as it is."""
    if not is_dtensor(x) or not any(p.is_shard(1) for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate

    pl = tuple(x.placements)
    return _Constrain.apply(x, x.device_mesh, tuple(
        Replicate() if p.is_shard(1) else p for p in pl), pl)


def attn_stripe_dim(n_heads: int, n_kv_heads: int) -> Optional[int]:
    """The mesh dimension over which self-attention runs as K6's query
    stripes under the active context, or None: with ``attn_seq_shard`` on
    a ``DeviceMesh``, when the ``model`` axis does not divide the query
    heads (the reference's ``shard_attn_logits``: its (B, H, Sq, Sk)
    scores' query sequence over ``model``), and also when it divides the
    query heads but not the kv heads (the reference shards its scores'
    query heads there; K6's heads rule needs both to divide, so the port
    takes the stripe: the same values, another program)."""
    ctx = current_ctx()
    if ctx is None or not ctx.attn_seq_shard or not ctx.spmd:
        return None
    tp = ctx.tp_size
    if n_heads % tp == 0 and n_kv_heads % tp == 0:
        return None
    return mesh_axis_names(ctx.mesh).index(ctx.tp)


def shard_attn_logits(logits: torch.Tensor) -> torch.Tensor:
    """(B, H, Sq, Sk) attention scores: with ``attn_seq_shard``, heads over
    tp when they divide, else the query sequence over tp.  The port's
    self-attention forms no score tensor (K6 keeps its tiles on chip): it
    takes the query sequence as K6's stripes where :func:`attn_stripe_dim`
    says so, and the heads through K6's rule otherwise.  This only pins a
    DTensor given to it; anything else is returned as it is."""
    ctx = current_ctx()
    if ctx is None or not ctx.attn_seq_shard or not (
            ctx.spmd and is_dtensor(logits)):
        return logits
    if logits.shape[1] % ctx.tp_size == 0:
        spec = (ctx.dp_spec, ctx.tp, None, None)
    else:
        spec = (ctx.dp_spec, None, ctx.tp, None)
    return _redistribute(logits, spec, ctx)


def shard_batch(x: torch.Tensor, ctx: ShardCtx):
    """An input ``x`` (B, ...) as a DTensor, its batch over the data axes
    when they divide it (else replicated), as the dry run lays inputs out."""
    from torch.distributed.tensor import distribute_tensor

    dp = ctx.dp_spec
    dp_size = math.prod(axis_sizes(ctx.mesh)[a] for a in
                        (dp if isinstance(dp, tuple) else (dp,)))
    spec = (dp if x.shape[0] % dp_size == 0 else None,) + (None,) * (
        x.dim() - 1)
    return distribute_tensor(x, ctx.mesh, placements(spec, ctx.mesh),
                             src_data_rank=None)


def decode_state_spec(shape: tuple, ctx: ShardCtx) -> tuple:
    """The reference's decode-cache spec (``launch/dryrun.py``'s
    ``_decode_state_shardings``) of a stacked cache leaf ``(L, B, ...)``:
    the batch over dp when it divides; a 5-dimension leaf (a KV cache
    ``(L, B, W, Hkv, D)``, and so an SSM state ``(L, B, H, P, N)``) its
    dimension 3 over tp when that divides, else dimension 2; a 4-dimension
    leaf (an SSM conv cache ``(L, B, K - 1, C)``) dimension 2 over tp when
    that divides, else dimension 3 when that does."""
    sizes = axis_sizes(ctx.mesh)
    dp = ctx.dp_spec
    dp_size = math.prod(sizes[a] for a in (dp if isinstance(dp, tuple)
                                           else (dp,)))
    tp_size = sizes[ctx.tp]
    parts = [None] * len(shape)
    if len(shape) >= 2 and shape[1] % dp_size == 0:
        parts[1] = dp
    if len(shape) == 5:
        parts[3 if shape[3] % tp_size == 0 else 2] = ctx.tp
    elif len(shape) == 4:
        if shape[2] % tp_size == 0:
            parts[2] = ctx.tp
        elif shape[3] % tp_size == 0:
            parts[3] = ctx.tp
    return tuple(parts)


def shard_state(x: torch.Tensor) -> torch.Tensor:
    """A stacked decode-cache leaf laid out by :func:`decode_state_spec`
    under the active context; anything but a DTensor under a ``DeviceMesh``
    context is returned as it is."""
    ctx = current_ctx()
    if ctx is None or not (ctx.spmd and is_dtensor(x)):
        return x
    return _redistribute(x, decode_state_spec(x.shape, ctx), ctx)


def shard_like(x, src, dims: dict):
    """The DTensor ``x`` redistributed so that every mesh dimension that
    shards ``src``'s dimension ``d`` shards ``x``'s dimension ``dims[d]``,
    and every other mesh dimension replicates it; its gradient is laid out
    so too (a constraint, as ``shard_act``'s, even where ``x`` already has
    that layout: a view after it then sees the layout it was planned for).
    The model code lines an operand up with another this way before running
    an operator on the shards (``local_map``)."""
    from torch.distributed.tensor import Replicate, Shard

    want = tuple(Shard(dims[p.dim]) if isinstance(p, Shard) and p.dim in dims
                 else Replicate() for p in src.placements)
    return _Constrain.apply(x, x.device_mesh, want)


def own_shard(t: torch.Tensor, pl: tuple, mesh) -> torch.Tensor:
    """This rank's shard of the full tensor ``t`` under the placements
    ``pl`` (even shards; the mesh dimensions split in order): a view of
    ``t``, copied only where the view is not contiguous.  A tensor the mesh
    does not split (every tensor on a one-rank mesh) is not copied, where
    ``distribute_tensor`` copies it in some PyTorch versions."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            size = t.shape[p.dim] // mesh.size(i)
            t = t.narrow(p.dim, coord[i] * size, size)
    return t if t.is_contiguous() else t.contiguous()


def shard_params(params, ctx: ShardCtx, expert_parallel: bool = False):
    """``params`` as DTensors on ``ctx.mesh`` under ``param_shardings``.
    Every rank passes the same full tensors (made from one seed, or carried
    across from the reference) and keeps its own shard: no collective, and
    no copy of a tensor the mesh does not split.  A stacked layers' leading
    dimension stays replicated."""
    from torch.distributed.tensor import DTensor

    specs = param_shardings(params, ctx, expert_parallel=expert_parallel)

    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(node[k], spec[k]) for k in node}
        pl = placements(spec, ctx.mesh)
        return DTensor.from_local(
            own_shard(node.detach(), pl, ctx.mesh), ctx.mesh, pl,
            run_check=False, shape=node.shape,
            stride=node.stride()).requires_grad_(node.requires_grad)

    return walk(params, specs)


# --------------------------------------------------------------------------
# parameter shardings, by path-name rules
# --------------------------------------------------------------------------

def _spec_for(path: str, shape: Tuple[int, ...], ctx: ShardCtx,
              expert_parallel: bool) -> tuple:
    fsdp = ctx.dp_spec if ctx.fsdp else None
    tp = ctx.tp
    name = path.split("/")[-1]
    ndim = len(shape)
    base: Tuple = ()

    if name in ("embed", "patch_proj_in"):
        base = (tp, None)                       # vocab over tp only
    elif name == "unembed":
        base = (fsdp, tp)                       # (D, V)
    elif name in ("w_q", "w_k", "w_v"):
        base = (fsdp, tp)                       # (D, H*hd)
    elif name == "w_o":
        base = (tp, fsdp)                       # (H*hd, D)
    elif name in ("w_gate", "w_up"):
        if ndim == 3:                           # MoE experts (E, D, F)
            base = (tp, fsdp, None) if expert_parallel else (None, fsdp, tp)
        else:
            base = (fsdp, tp)                   # (D, F)
    elif name == "w_down":
        if ndim == 3:                           # (E, F, D)
            base = (tp, None, fsdp) if expert_parallel else (None, tp, fsdp)
        else:
            base = (tp, fsdp)                   # (F, D)
    elif name == "router":
        base = (fsdp, None)
    elif name == "in_proj":
        base = (fsdp, tp)                       # ssm: (D, Din)
    elif name == "out_proj":
        base = (tp, fsdp)                       # ssm: (Din, D)
    elif name in ("conv_w", "conv_b"):
        base = (None,) * (ndim - 1) + (tp,)     # channels over tp
    elif name in ("a_log", "d_skip", "dt_bias"):
        base = (tp,)
    else:                                       # norms, scalars: replicated
        base = (None,) * ndim

    base = tuple(base)[:ndim] + (None,) * max(0, ndim - len(base))
    # stacked-layer leading dim (scan over layers): never sharded
    if ndim > len(base):
        base = (None,) + base
    return base


def param_shardings(params, ctx: ShardCtx, expert_parallel: bool = False,
                    n_layers_stacked: bool = True):
    """The reference's ``PartitionSpec`` of every parameter, as a tuple of
    one entry a dimension (an axis name, a tuple of them, or ``None``), in
    a tree matching ``params``."""

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in node.items()}
        shape = tuple(node.shape)
        stacked = n_layers_stacked and "/layers/" in path + "/"
        core_shape = shape[1:] if stacked and len(shape) > 1 else shape
        parts = _spec_for(path, core_shape, ctx, expert_parallel)
        if stacked and len(shape) > 1:
            parts = (None,) + parts
        parts = parts[: len(shape)]
        parts = parts + (None,) * (len(shape) - len(parts))
        # divisibility guard: drop axis sharding that does not divide
        fixed = []
        for dim, ax in zip(shape, parts):
            if ax is None:
                fixed.append(None)
                continue
            size = 1
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                size *= axis_sizes(ctx.mesh)[a]
            fixed.append(ax if dim % size == 0 else None)
        return tuple(fixed)

    return walk(params, "")
