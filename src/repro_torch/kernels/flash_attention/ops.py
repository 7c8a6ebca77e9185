"""``repro_torch/kernels/flash_attention/ops.py`` ↔ ``repro/kernels/flash_attention/ops.py``.

:func:`flash_attention` is the wrapper of K6, two hand-written CUDA kernels
picked by the operands' type:

- bfloat16, the served models' type: ``csrc/flash_attention_sm90.cu``, on
  Hopper's tensor cores (``wgmma``, K/V staged by TMA), route ``"sm90_bf16"``;
- float32: ``csrc/flash_attention_tf32x3.cu``, also on the tensor cores,
  float32-accurate as three TF32 products of split operands (3xTF32, the
  scheme of K1-K4, ``kernels/csrc/tf32x3.cuh``), route ``"sm90_tf32x3"``.
  One launch of its entry point runs a pre-pass that writes the split K and
  the split, transposed V (TF32 ``wgmma`` takes only K-major operands) into
  scratch this wrapper allocates, then the attention kernel.  The entry point
  reports the TF32 products a product takes, and the launch is counted under
  ``"sm90_tf32x<products>"``, so a build with one product shows off the route.

On CUDA tensors it launches one of them, counting the launch in
``flash_attention.launches`` and in ``flash_attention.launches_by_route``, or
raises; it never falls back.  On CPU tensors it runs the plain version
``flash_attention.flash_attention_plain``, which walks the kernels' tiles and
recurrence.

The call is a ``torch.autograd.Function``: its forward is the operator
``repro_torch::flash_attention_fwd`` (:func:`flash_attention_fwd`: the
kernel, or the plain version, run untaped; on ``meta`` tensors a fake that
gives the output's shape; its FLOPs registered as the unmasked pairs'
products), saving q, k and v; its backward is
``flash_attention.flash_attention_backward``, float32 torch ops that
recompute the scores (the reference has no Pallas backward kernel).  Only
the forward counts a launch; a recompute under activation checkpointing
runs, and counts, the forward again.  On DTensor operands (an LM sharded over a ``DeviceMesh``,
``distributed/sharding.py``) the operator has a sharding rule,
:func:`_attention_sharding`: the batch sharded over any mesh axes, or the
heads of q, k, v and the output together over an axis that both ``Hq`` and
``Hkv`` divide (query head ``h``'s key/value head ``h // (Hq / Hkv)`` is then
in the same shard), or all replicated; DTensor takes the one that moves
least and runs the kernel on each rank's shard.  The backward runs on each
rank's shard too (``local_map``), at the placements the forward took: its
torch ops slice, assign and batch heads in ways DTensor does not shard
alike in every PyTorch version, and they need no collective.

Query stripes (the reference's ``attn_seq_shard``, which pins its scores'
query sequence over ``model`` when the heads do not divide it): the kernels
take q as ``Sq`` rows of a sequence of ``Sk`` keys, starting at row
``row_base`` (the operator's last argument).  :func:`flash_attention_striped`
runs each rank's stripe: q sharded on its sequence over one mesh
dimension, k and v replicated there, the batch as q's on the others, and
each rank's ``row_base`` its stripe's first row (``torch.chunk``'s split,
DTensor's).  ``register_sharding`` cannot give a rank its own offset, so
the stripe is no strategy of the rule: it runs its shards directly, and
its backward gives dq for the stripe's rows and dk, dv as a ``Partial``
sum over the stripes, reduced to k's and v's placements.  Query heads
(the reference's layout where the axis divides ``Hq`` but not ``Hkv``):
:func:`flash_attention_query_heads` runs each rank's share of q's heads,
k and v replicated there, on the one kv head they read
(:func:`query_heads_kv`; k and v narrowed to it, so that the kernels'
uniform rule ``h // (Hq / Hkv)`` holds on the shard); its dk, dv are a
``Partial`` sum over the ranks, left so for the kv heads' producer.  A
stripe's FLOP formula counts the busiest stripe of its width (the last
when causal), whatever its ``row_base``: a dry run counts one rank's work,
and the step waits for the busiest.  Both kernels take head widths 64,
128 and 256, those of the ported dense configurations, with q, k and v of
one type.  The reference's ``block_q``/``block_k`` arguments are TPU tile
sizes and are not taken: the kernels' tiles are fixed (``KV_TILE``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch._device import is_dtensor
from repro_torch.kernels._build import (check_operand, launch, load_library,
                                        on_card)
from repro_torch.kernels.flash_attention.flash_attention import (
    KV_TILE, LOG2E, attention_work, flash_attention_backward,
    flash_attention_plain)

__all__ = ["HEAD_DIMS", "SM90_SOURCE", "TF32X3_SOURCE", "flash_attention",
           "flash_attention_fwd", "flash_attention_query_heads",
           "flash_attention_striped", "query_heads_kv", "sm90_library",
           "tf32x3_library"]

_CSRC = Path(__file__).resolve().parent / "csrc"
SM90_SOURCE = _CSRC / "flash_attention_sm90.cu"       # bfloat16, "sm90_bf16"
TF32X3_SOURCE = _CSRC / "flash_attention_tf32x3.cu"   # float32, "sm90_tf32x3"
HEAD_DIMS = (64, 128, 256)
_DTYPES = (torch.float32, torch.bfloat16)


def tf32x3_library():
    """Build (at first use) and load the float32 tensor-core kernel; returns
    a ``_build.BuiltLibrary``."""
    built = load_library(TF32X3_SOURCE)
    fn = built.lib.flash_attention_tf32x3
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [
            ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return built


def sm90_library():
    """Build (at first use) and load the bfloat16 tensor-core kernel."""
    built = load_library(SM90_SOURCE)
    fn = built.lib.flash_attention_sm90
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return built


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it when its storage is not 16-byte aligned (TMA)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=())
def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, window: int,
                        row_base: int = 0) -> torch.Tensor:
    """K6's forward as one operator: the kernel on CUDA tensors, the plain
    version on CPU ones.  A dispatch mode (``FlopCounterMode``,
    ``launch/dryrun.py``'s byte counter) sees this one call and not the
    operations inside it; on ``meta`` tensors only its fake runs."""
    if not on_card("flash_attention", q):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     row_base=row_base)
    return _launch(q, k, v, causal, window, row_base)


@flash_attention_fwd.register_fake
def _flash_attention_fwd_fake(q, k, v, causal, window, row_base=0):
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _flash_attention_fwd_flops(q_shape, k_shape, v_shape, causal, window,
                               row_base=0, *args, **kwargs) -> int:
    """The unmasked pairs' two products (:func:`attention_work`); of a
    stripe (``Sq < Sk``), those of the busiest stripe of its width,
    whatever ``row_base``: a row's kept keys never fall along the sequence
    when causal and never rise when bidirectional, so that is the last
    stripe or the first."""
    b, hq, sq, d = q_shape
    sk = k_shape[2]
    return int(max(attention_work(b, hq, k_shape[1], sk, d, window, 0,
                                  causal, row_base=r0, sq=sq)[0]
                   for r0 in (0, sk - sq)))


def _attention_sharding(q, k, v, causal, window, row_base=0):
    """K6's DTensor strategies, one mesh dimension at a time (DTensor
    expands them over the mesh): (output placement, input placements)."""
    from torch.distributed.tensor import Replicate, Shard

    rest = [None, None, None]
    rules = [([Replicate()], [Replicate()] * 3 + rest),
             ([Shard(0)], [Shard(0)] * 3 + rest)]
    hq, hkv = q.shape[1], k.shape[1]
    if all(hq % m == 0 and hkv % m == 0 for m in q.mesh.shape):
        rules.append(([Shard(1)], [Shard(1)] * 3 + rest))
    return rules


def _register_sharding():
    from torch.distributed.tensor.experimental import register_sharding

    register_sharding(torch.ops.repro_torch.flash_attention_fwd.default)(
        _attention_sharding)


if torch.distributed.is_available():
    _register_sharding()


def _stripe_rows(n: int, mesh, dim: int) -> tuple[int, int]:
    """This rank's first row and row count of ``n`` rows sharded over mesh
    dimension ``dim`` (``torch.chunk``'s split, as DTensor's)."""
    chunk = -(-n // mesh.size(dim))
    first = mesh.get_coordinate()[dim] * chunk
    return first, max(0, min(chunk, n - first))


def query_heads_kv(hq: int, hkv: int, n: int, rank: int):
    """The key/value head that rank ``rank`` of ``n`` reads when the ``hq``
    query heads are split over the ``n`` ranks and the ``hkv`` kv heads are
    not: its query heads ``rank * hq / n ..`` all read kv head ``rank * hq /
    n // (hq / hkv)``, which K6's uniform rule gives them over that one
    head.  None where the split does not keep each rank inside one kv head's
    group (``n`` not a multiple of ``hkv``) or the kv heads divide ``n``."""
    if hq % n or hkv % n == 0 or n % hkv:
        return None
    return rank * (hq // n) // (hq // hkv)


class _OnShards(torch.autograd.Function):
    """One rank's part of DTensor operands laid out by
    :func:`flash_attention_striped` (``heads`` False: its query stripe at
    its ``row_base``) or :func:`flash_attention_query_heads` (``heads``:
    its query heads on the one kv head they read): the operator on its
    shards; the backward's dk, dv a ``Partial`` sum over mesh dimension
    ``dim``, a stripe's reduced to k's and v's placements."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, dim, heads):
        from torch.distributed.tensor import DTensor

        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window, ctx.dim = causal, window, dim
        mesh = q.device_mesh
        if heads:
            ctx.row_base = 0
            ctx.kv = query_heads_kv(q.shape[1], k.shape[1], mesh.size(dim),
                                    mesh.get_coordinate()[dim])
        else:
            ctx.row_base = _stripe_rows(q.shape[2], mesh, dim)[0]
            ctx.kv = None
        out = flash_attention_fwd(q.to_local(), *_kv_heads(ctx, k, v),
                                  causal, window, ctx.row_base)
        return DTensor.from_local(out, mesh, q.placements, run_check=False,
                                  shape=q.shape, stride=q.stride())

    @staticmethod
    def backward(ctx, dout):
        from torch.distributed.tensor import DTensor, Partial

        q, k, v = ctx.saved_tensors
        mesh = q.device_mesh
        dout = dout.redistribute(mesh, q.placements)
        dq, dk, dv = flash_attention_backward(
            q.to_local(), *_kv_heads(ctx, k, v), dout.to_local(),
            ctx.causal, ctx.window, ctx.row_base)
        if ctx.kv is not None and k.shape[1] > 1:
            dk, dv = (torch.zeros_like(t.to_local()).index_copy_(
                1, torch.tensor([ctx.kv], device=g.device), g)
                      for g, t in ((dk, k), (dv, v)))
        summed = [Partial() if i == ctx.dim else p
                  for i, p in enumerate(k.placements)]
        dq = DTensor.from_local(dq, mesh, q.placements, run_check=False,
                                shape=q.shape, stride=q.stride())
        dk, dv = (DTensor.from_local(g, mesh, summed, run_check=False,
                                     shape=t.shape, stride=t.stride())
                  for g, t in ((dk, k), (dv, v)))
        if ctx.kv is None:
            # a stripe's dk, dv reduced to k's and v's placements; the
            # query heads' stay a Partial sum, which the kv heads' gather
            # (where a column shard cut one) reduce-scatters, half an
            # all-reduce's bytes
            dk, dv = (g.redistribute(mesh, t.placements)
                      for g, t in ((dk, k), (dv, v)))
        return dq, dk, dv, None, None, None, None


def _kv_heads(ctx, k, v):
    """This rank's k and v shards, narrowed to the one kv head its query
    heads read (``ctx.kv``) when there is one."""
    k, v = k.to_local(), v.to_local()
    if ctx.kv is None or k.shape[1] == 1:
        return k, v
    return k.narrow(1, ctx.kv, 1), v.narrow(1, ctx.kv, 1)


def _on_shards(q, k, v, causal, window, dim, q_at):
    """q with ``q_at`` on mesh dimension ``dim``, k and v replicated there,
    the batch of all three as q's on the other mesh dimensions (else
    replicated), run by :class:`_OnShards`."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = q.device_mesh
    rows = [Shard(0) if p == Shard(0) else Replicate() for p in q.placements]
    q_pl = [q_at if i == dim else p for i, p in enumerate(rows)]
    kv_pl = [Replicate() if i == dim else p for i, p in enumerate(rows)]
    # (a redistribution to the placements a tensor has would still take a
    # Partial gradient back to them, reduced)
    q, k, v = (t if list(t.placements) == pl else t.redistribute(mesh, pl)
               for t, pl in ((q, q_pl), (k, kv_pl), (v, kv_pl)))
    return _OnShards.apply(q, k, v, bool(causal), int(window), dim,
                           q_at == Shard(1))


def flash_attention_striped(q, k, v, causal: bool = True, window: int = 0,
                            dim: int = 0):
    """:func:`flash_attention` of DTensor operands as query stripes over
    mesh dimension ``dim``: q (B, Hq, S, D) sharded on its sequence there,
    k and v replicated there, the batch of all three as q's on the other
    mesh dimensions (else replicated); each rank runs the kernel on its
    stripe at its own ``row_base``.  Returns the output sharded as q."""
    from torch.distributed.tensor import Shard

    return _on_shards(q, k, v, causal, window, dim, Shard(2))


def flash_attention_query_heads(q, k, v, causal: bool = True,
                                window: int = 0, dim: int = 0):
    """:func:`flash_attention` of DTensor operands with q's heads split over
    mesh dimension ``dim`` where the kv heads are not (the reference's
    layout when the axis divides ``Hq`` but not ``Hkv``,
    :func:`query_heads_kv`): q (B, Hq, S, D) sharded on its heads there, k
    and v replicated there, the batch of all three as q's on the other mesh
    dimensions (else replicated); each rank runs the kernel on its query
    heads and the kv head they read.  Returns the output sharded as q."""
    from torch.distributed.tensor import Shard

    return _on_shards(q, k, v, causal, window, dim, Shard(1))


def _backward_on_shards(q, k, v, dout, causal: bool, window: int,
                        placements: tuple):
    """:func:`flash_attention_backward` of DTensor operands, run on each
    rank's shard at the forward's output ``placements`` (batch, heads or
    replicated on each mesh dimension; q, k, v and ``dout`` brought
    there)."""
    from torch.distributed.tensor.experimental import local_map

    mesh, pl = q.device_mesh, list(placements)
    q, k, v, dout = (t.redistribute(mesh, pl) for t in (q, k, v, dout))
    return local_map(
        lambda q, k, v, d: flash_attention_backward(q, k, v, d, causal,
                                                    window),
        out_placements=(pl, pl, pl), in_placements=(pl, pl, pl, pl),
        device_mesh=mesh)(q, k, v, dout)


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        out = flash_attention_fwd(q, k, v, causal, window)
        ctx.placements = tuple(out.placements) if is_dtensor(out) else None
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        if ctx.placements is not None:
            return (*_backward_on_shards(q, k, v, dout, ctx.causal,
                                         ctx.window, ctx.placements),
                    None, None)
        return (*flash_attention_backward(q, k, v, dout, ctx.causal,
                                          ctx.window), None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """``q`` (B, Hq, S, D), ``k``/``v`` (B, Hkv, S, D) -> (B, Hq, S, D)
    (of DTensors, through the rule; query stripes:
    :func:`flash_attention_striped`).

    Query head ``h`` attends with key/value head ``h // (Hq // Hkv)``;
    ``window`` > 0 keeps keys with ``i - j < window``.  Differentiable in q,
    k and v.
    """
    return _Attention.apply(q, k, v, bool(causal), int(window))


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: int, row_base: int = 0) -> torch.Tensor:
    """One launch of K6's kernel for the operands' type, counted: q's
    ``Sq`` rows are rows ``row_base ..`` of k's and v's ``Sk``."""
    b, hq, sq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head width {d} is not one of "
                         f"{HEAD_DIMS}")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"flash_attention: {hq} query heads are not a "
                         f"multiple of {hkv} key/value heads")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention: q, k and v must all be float32 or "
                         f"all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if window < 0:
        raise ValueError(f"flash_attention: window must be >= 0, got {window}")
    if row_base < 0 or row_base + sq > s:
        raise ValueError(f"flash_attention: query rows {row_base} .. "
                         f"{row_base + sq - 1} are not rows of {s} keys")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    check_operand("q", q, (b, hq, sq, d), q.device, _DTYPES)
    check_operand("k", k, (b, hkv, s, d), q.device, _DTYPES)
    check_operand("v", v, (b, hkv, s, d), q.device, _DTYPES)
    out = torch.empty_like(q)
    scale_log2 = float(d) ** -0.5 * LOG2E
    if q.dtype == torch.bfloat16:
        q, k, v = _aligned(q), _aligned(k), _aligned(v)
        route = "sm90_bf16"
        launch(sm90_library(), "flash_attention_sm90", q.device, q.data_ptr(),
               k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv, sq, s,
               int(row_base), d, int(bool(causal)), int(window), scale_log2)
    else:
        q = _aligned(q)
        # the pre-pass's output: split K (B, Hkv, Sk, D), split V^T
        # (B, Hkv, D, Sk rounded up to the 64-key tile)
        khi, klo = torch.empty_like(k), torch.empty_like(k)
        vthi = torch.empty((b, hkv, d, -(-s // KV_TILE) * KV_TILE),
                           dtype=torch.float32, device=q.device)
        vtlo = torch.empty_like(vthi)
        products = ctypes.c_int(0)
        launch(tf32x3_library(), "flash_attention_tf32x3", q.device,
               q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               khi.data_ptr(), klo.data_ptr(), vthi.data_ptr(),
               vtlo.data_ptr(), b, hq, hkv, sq, s, int(row_base), d,
               int(bool(causal)), int(window), scale_log2,
               ctypes.addressof(products))
        route = f"sm90_tf32x{products.value}"
    flash_attention.launches += 1
    by_route = flash_attention.launches_by_route
    by_route[route] = by_route.get(route, 0) + 1
    return out


# K6 launches, in all and by route; the CPU path does not count
flash_attention.launches = 0
flash_attention.launches_by_route = {"sm90_bf16": 0, "sm90_tf32x3": 0}
