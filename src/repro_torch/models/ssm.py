"""``repro_torch/models/ssm.py`` ↔ ``repro/models/ssm.py``.

Mamba2 (SSD — state-space duality) block: chunked quadratic-within /
recurrent-across scan for the full sequence, an O(1)-per-token recurrent
update for decode (arXiv:2405.21060).

Layout per layer:
  in_proj : D -> [z (Di), x (Di), B (G*N), C (G*N), dt (H)]
  conv1d  : causal depthwise (kernel K) over the (x, B, C) channels
  SSD     : h' = exp(dt*A) h + dt * B x ;  y = C h + D_skip * x
  out_proj: Di -> D                         (gated by silu(z))

Di = expand * D, H = Di / head_dim, G = ssm_groups, N = ssm_state.

The dtype boundaries are the reference's: the projections and the conv run
in the compute dtype; ``dt``, ``a``, the SSD and the recurrent state in
float32; the SSD output is cast back before the ``d_skip`` term and the
``silu(z)`` gate.  The reference's four-operand einsums are written as
pairwise products over ``(b, c, h)`` (a ``matmul`` each), so that no
``(b, c, l, s, h, p)`` intermediate is formed; its ``lax.scan`` over chunk
boundary states is a Python loop over the chunks.  No Pallas kernel runs
here in the reference, and no hand-written kernel runs here in the port.

Sharded (DTensor activations, parameters under ``param_shardings``: the
``in_proj`` columns, conv channels and per-head vectors over ``model``
where they divide it), the full-sequence block runs on column pieces
(:func:`_pieces`) when the mesh splits ``in_proj``'s columns or the conv's
channels: ``in_proj``'s weight is cut into z | x | B | C | dt and the
conv's into x | B | C, each piece laid out as the SSD takes its
activation (z, x and dt split by heads where the SSD splits them, B and C
whole, or by groups), so that no product's columns are moved, where the
column shards do not line up with the split (GSPMD moves the product's
straddling columns; the weight's are fewer at any sequence longer than
``d_model``).  The conv runs on its pieces' shards (:class:`_Conv`), the
SSD on the batch and the heads (gathered first when they do not divide
the axis) through ``local_map``, and B's and C's gradients stay ``Partial``
sums until the residual's reduction.  The one-token decode gathers its
product's columns instead (fewer than the weight's), and its recurrence
runs on the decode state's shards (P over ``model``, the reference's
cache layout).  The conv and the SSD need the whole sequence: a
sequence-sharded input (``seq_shard``) is gathered at the block's entry
(``sharding.gather_seq``).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch._device import is_dtensor
from repro_torch.distributed.sharding import (gather_seq, own_shard,
                                              product_weight, shard_like)
from repro_torch.models.layers import dense_init

__all__ = ["SSMCache", "init_ssm_cache", "ssd_chunked", "ssm_apply",
           "ssm_decode", "ssm_init", "ssm_param_shapes"]


@dataclasses.dataclass(frozen=True)
class SSMCache:
    conv: torch.Tensor    # (B, K-1, conv_channels) last inputs of the conv
    state: torch.Tensor   # (B, H, P, N) recurrent SSM state, float32


def _conv_channels(cfg) -> int:
    return cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state


def ssm_param_shapes(cfg) -> dict:
    """The shape of every parameter of one layer, as ``ssm_init`` makes it."""
    d, di, h = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    gn = cfg.ssm_groups * cfg.ssm_state
    conv_ch = _conv_channels(cfg)
    return {"in_proj": (d, 2 * di + 2 * gn + h),
            "conv_w": (cfg.ssm_conv, conv_ch), "conv_b": (conv_ch,),
            "a_log": (h,), "d_skip": (h,), "dt_bias": (h,),
            "out_proj": (di, d)}


def ssm_init(generator: torch.Generator, cfg, *, device) -> dict:
    """The reference's distributions: truncated-normal fan-in projections
    (``out_proj`` at scale ``d_inner ** -0.5``), a normal conv kernel scaled
    by ``(K * channels) ** -0.5``, ``a_log = log(1..H)``, ``d_skip`` ones and
    ``dt_bias`` uniform on ``[log 1e-3, log 1e-1]``."""
    shapes = ssm_param_shapes(cfg)
    d, di, h = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    k, conv_ch = shapes["conv_w"]
    in_proj = dense_init(generator, d, shapes["in_proj"][1], device=device)
    conv_w = torch.randn((k, conv_ch), generator=generator,
                         device=device).mul_((k * conv_ch) ** -0.5)
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt_bias = torch.rand((h,), generator=generator,
                         device=device).mul_(hi - lo).add_(lo)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros(conv_ch, device=device),
        "a_log": torch.log(torch.arange(1, h + 1, dtype=torch.float32,
                                        device=device)),
        "d_skip": torch.ones(h, device=device),
        "dt_bias": dt_bias,
        "out_proj": dense_init(generator, di, d, scale=di ** -0.5,
                               device=device),
    }


def _split_proj(cfg, proj: torch.Tensor):
    """``in_proj``'s product split into z | x B C | dt.  Of a DTensor, its
    columns gathered first: their shards do not line up with the split
    (the decode's one-token product, which is smaller than the weight)."""
    if is_dtensor(proj):
        proj = shard_like(proj, proj, {0: 0})
    di, gn, h = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state, cfg.ssm_heads
    return proj[..., :di], proj[..., di:2 * di + 2 * gn], proj[..., -h:]


class _Columns(torch.autograd.Function):
    """The DTensor ``w``'s last dimension cut at ``cuts`` into pieces, piece
    ``i`` laid out as ``pls[i]`` (its columns split over the heads' mesh
    dimensions, or whole): ``w``'s columns all-gathered over the mesh
    dimensions that split them, each rank keeping its shard of each piece.
    The pieces' gradients come back the other way: gathered over those
    dimensions, a ``Partial`` sum over the others (the products' batch
    shards), each rank keeping its columns of ``w``."""

    @staticmethod
    def forward(ctx, w, cuts, pls):
        from torch.distributed.tensor import DTensor, Replicate, Shard

        mesh, last = w.device_mesh, w.ndim - 1
        ctx.mesh, ctx.pl, ctx.shape, ctx.cuts = mesh, w.placements, w.shape, \
            cuts
        whole = [Replicate() if p == Shard(last) else p for p in w.placements]
        full = w.redistribute(mesh, whole).to_local()
        out = []
        for a, b, pl in zip(cuts[:-1], cuts[1:], pls):
            shape = (*w.shape[:-1], b - a)
            piece = own_shard(full.narrow(last, a, b - a), [
                p if p == Shard(last) else Replicate() for p in pl], mesh)
            out.append(DTensor.from_local(
                piece, mesh, pl, run_check=False, shape=shape,
                stride=torch.empty(shape, device="meta").stride()))
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        from torch.distributed.tensor import DTensor, Replicate, Shard

        mesh, last = ctx.mesh, len(ctx.shape) - 1
        given = [g for g in grads if g is not None]
        # whole columns over the dimensions that split w's; elsewhere the
        # gradients' common placement (a Partial sum over the batch's
        # shards), or replicated where they differ
        want = [Replicate() if p == Shard(last) else
                q[0] if all(x == q[0] for x in q) else Replicate()
                for p, q in zip(ctx.pl, zip(*(g.placements for g in given)))]
        parts = [None if g is None else g.redistribute(mesh, want).to_local()
                 for g in grads]
        like = given[0].to_local()
        full = torch.cat([
            like.new_zeros((*like.shape[:-1], b - a)) if t is None else t
            for t, a, b in zip(parts, ctx.cuts[:-1], ctx.cuts[1:])], dim=last)
        pl = [Shard(last) if p == Shard(last) else q
              for p, q in zip(ctx.pl, want)]
        g = DTensor.from_local(
            own_shard(full, [p if p == Shard(last) else Replicate()
                             for p in pl], mesh), mesh, pl, run_check=False,
            shape=ctx.shape, stride=torch.empty(ctx.shape,
                                                device="meta").stride())
        return g, None, None


def _conv_taps(xbc: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = torch.zeros_like(xbc)
    for i in range(k):
        out = out + pad[:, i:i + s, :] * w[i]
    return F.silu(out + b)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the sequence, then SiLU: ``xbc`` (B, S, C),
    ``w`` (K, C); the reference's K-tap loop in the input's dtype.  Of a
    DTensor, on each rank's batch rows and its shard of the channels
    (``conv_w``'s, over ``model``): ``xbc`` is laid out so, and returned
    so (:class:`_Conv`)."""
    if not is_dtensor(xbc):
        return _conv_taps(xbc, w, b)
    return _Conv.apply(_channels_like(xbc, w, 1), w, b)


class _Conv(torch.autograd.Function):
    """:func:`_conv_taps` of DTensors on each rank's shards.  Its backward
    is linear in the output's gradient, so a gradient that comes back as a
    ``Partial`` sum where the output is replicated (B and C, whole on every
    rank, from an SSD split by heads) stays one: the input's gradient is
    that ``Partial`` sum, reduced later with the residual's, where a
    ``local_map`` would all-reduce it here; the weight's is a ``Partial``
    sum over the batch's shards and over those."""

    @staticmethod
    def forward(ctx, xbc, w, b):
        from torch.distributed.tensor import DTensor

        ctx.save_for_backward(xbc, w, b)
        out = _conv_taps(xbc.to_local(), w.to_local(), b.to_local())
        return DTensor.from_local(out, xbc.device_mesh, xbc.placements,
                                  run_check=False, shape=xbc.shape,
                                  stride=xbc.stride())

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

        xbc, w, b = ctx.saved_tensors
        mesh = xbc.device_mesh
        pl = [q if q.is_partial() and p == Replicate() else p
              for p, q in zip(xbc.placements, g.placements)]
        g = g.redistribute(mesh, pl)
        with torch.enable_grad():
            ins = [t.to_local().detach().requires_grad_(True)
                   for t in (xbc, w, b)]
            grads = torch.autograd.grad(_conv_taps(*ins), ins, g.to_local())
        grads = [d.contiguous() for d in grads]
        summed = [p == Shard(0) or p.is_partial() for p in pl]
        return tuple(DTensor.from_local(
            d, mesh, out, run_check=False, shape=t.shape, stride=t.stride())
            for d, t, out in zip(grads, (xbc, w, b), (pl, *(
                [Partial() if s else q for s, q in zip(summed, t.placements)]
                for t in (w, b)))))


def _channels_like(x, w, w_dim: int):
    """DTensor ``x`` (B, ..., C): its batch rows as they are, its channels
    sharded as ``w``'s dimension ``w_dim``."""
    from torch.distributed.tensor import Replicate, Shard

    want = [Shard(x.ndim - 1) if q == Shard(w_dim) else
            p if p == Shard(0) else Replicate()
            for p, q in zip(x.placements, w.placements)]
    if list(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Lower-triangular pairwise cumulative sums:
    ``out[i, j] = sum_{j<k<=i} a_k``, ``-inf`` above the diagonal (the
    reference's formula, ``cs[:, None] - cs[None, :]``)."""
    s = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=a.device).tril_()
    return out.masked_fill_(~mask, -math.inf)


def _repeat_groups(t: torch.Tensor, rep: int, dim: int) -> torch.Tensor:
    return t if rep == 1 else t.repeat_interleave(rep, dim=dim)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                bmat: torch.Tensor, cmat: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None):
    """Chunked SSD scan: ``x`` (B, S, H, P), ``dt`` (B, S, H) positive steps,
    ``a`` (H,) negative decay rates, ``bmat`` / ``cmat`` (B, S, G, N), ``h0``
    (B, H, P, N) the initial state; returns ``(y (B, S, H, P), final)``.

    Of DTensors, the scan runs on each rank's batch rows and heads
    (``local_map``): the heads are split over the mesh dimensions that
    shard ``a`` (``a_log``'s, over ``model`` when the heads divide it, as
    K6's rule shards attention heads) when the groups allow it (one group,
    or groups that divide too), and gathered otherwise.

    Raises ``ValueError`` unless ``chunk`` divides S (the reference
    asserts it)."""
    if x.shape[1] % chunk:
        raise ValueError(f"ssd_chunked: the sequence length {x.shape[1]} is "
                         f"not a multiple of the chunk {chunk}")
    if is_dtensor(x):
        return _ssd_sharded(x, dt, a, bmat, cmat, chunk, h0)
    return _ssd(x, dt, a, bmat, cmat, chunk, h0)


class _Dense(torch.autograd.Function):
    """The identity on local shards, whose gradients are made contiguous: a
    shard's gradient from the scan's permuted products, handed to a view
    outside the ``local_map``, would be refused by it."""

    @staticmethod
    def forward(ctx, *ts):
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *gs):
        return tuple(None if g is None else g.contiguous() for g in gs)


def _ssd_sharded(x, dt, a, bmat, cmat, chunk: int, h0):
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, g = x.device_mesh, bmat.shape[2]
    batch = [p == Shard(0) for p in x.placements]
    heads = [not bt and q == Shard(0) and (g == 1 or g % mesh.size(i) == 0)
             for i, (bt, q) in enumerate(zip(batch, a.placements))]

    def pl(head_dim, group=None, on_batch=Shard(0), off=Replicate()):
        return [on_batch if bt else (Shard(head_dim) if group is None else
                                     group) if hd else off
                for bt, hd in zip(batch, heads)]

    grouped = Shard(2) if g > 1 else None
    x_pl, dt_pl, h_pl = pl(2), pl(2), pl(1)
    a_pl, a_grad = pl(0, on_batch=Replicate()), pl(0, on_batch=Partial())
    bc_pl = pl(2, group=grouped or Replicate())
    bc_grad = pl(2, group=grouped or Partial())
    h0_pl = None if h0 is None else h_pl
    # (a redistribution to the placements a tensor has would still take
    # its gradient back to them: a Partial B or C would be reduced there)
    x, dt, a, bmat, cmat, h0 = (
        t if q is None or list(t.placements) == q else t.redistribute(mesh, q)
        for t, q in zip(
            (x, dt, a, bmat, cmat, h0),
            (x_pl, dt_pl, a_pl, bc_pl, bc_pl, h0_pl)))
    return local_map(lambda *t: _ssd(*_Dense.apply(*t[:5]), chunk, t[5]),
                     out_placements=(x_pl, h_pl),
                     in_placements=(x_pl, dt_pl, a_pl, bc_pl, bc_pl, h0_pl),
                     in_grad_placements=(x_pl, dt_pl, a_grad, bc_grad,
                                         bc_grad, h0_pl),
                     device_mesh=mesh)(x, dt, a, bmat, cmat, h0)


def _ssd(x, dt, a, bmat, cmat, chunk: int, h0):
    b, s, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    nc, rep = s // chunk, h // g

    # (b, c, h, l, .) layouts: every product below is a batched matmul
    xr = x.reshape(b, nc, chunk, h, p).permute(0, 1, 3, 2, 4)
    dtr = dt.reshape(b, nc, chunk, h).permute(0, 1, 3, 2)       # (b,c,h,l)
    br = _repeat_groups(bmat.reshape(b, nc, chunk, g, n), rep, 3) \
        .permute(0, 1, 3, 2, 4)                                  # (b,c,h,l,n)
    cr = _repeat_groups(cmat.reshape(b, nc, chunk, g, n), rep, 3) \
        .permute(0, 1, 3, 2, 4)

    da = dtr * a[None, None, :, None]          # (b, c, h, l) log-decay
    da_cum = torch.cumsum(da, dim=-1)          # within-chunk cumulative
    da_tot = da_cum[..., -1]                   # (b, c, h)

    # --- intra-chunk (quadratic, attention-like with decay kernel) ---------
    ell = _segsum(da).exp_()                              # (b, c, h, l, l)
    scores = torch.matmul(cr, br.transpose(-1, -2))       # (b, c, h, l, s)
    xdt = xr * dtr[..., None]                             # (b, c, h, s, p)
    y = torch.matmul(scores.mul_(ell), xdt)               # (b, c, h, l, p)
    del ell, scores

    # --- chunk states -------------------------------------------------------
    decay_states = torch.exp(da_tot[..., None] - da_cum)  # (b, c, h, l)
    states = torch.matmul((xdt * decay_states[..., None]).transpose(-1, -2),
                          br)                             # (b, c, h, p, n)

    # --- inter-chunk recurrence over chunk boundary states -----------------
    carry = torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device) \
        if h0 is None else h0
    decay_tot = torch.exp(da_tot)
    prev = []
    for c in range(nc):
        prev.append(carry)                     # the state entering chunk c
        carry = carry * decay_tot[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)     # (b, c, h, p, n)

    # --- inter-chunk output contribution ------------------------------------
    y_off = torch.matmul(cr, prev_states.transpose(-1, -2))  # (b,c,h,l,p)
    y = y + y_off * torch.exp(da_cum)[..., None]
    return y.permute(0, 1, 3, 2, 4).reshape(b, s, h, p), carry


def _heads_split(cfg, a, x) -> list:
    """Per mesh dimension, whether the SSD splits the heads there: ``a``
    (``a_log``'s layout) sharded on it, the batch of ``x`` not, and the
    groups one or dividing it (:func:`ssd_chunked`'s rule)."""
    from torch.distributed.tensor import Shard

    mesh, g = x.device_mesh, cfg.ssm_groups
    return [p != Shard(0) and q == Shard(0) and (g == 1 or g % mesh.size(i)
                                                 == 0)
            for i, (p, q) in enumerate(zip(x.placements, a.placements))]


def _pieces(cfg, params: dict, x):
    """Of a DTensor ``x`` whose mesh splits ``in_proj``'s columns or the
    conv's channels over more than one rank: a function of the compute
    dtype giving ``in_proj``'s z | x | B | C | dt column pieces and the
    conv's x | B | C weight and bias pieces, each laid out as the SSD takes
    its activation (:class:`_Columns`): z, x and dt split by heads where
    the SSD splits them, B and C by groups there when there are several,
    whole otherwise.  Then no product's columns are moved: GSPMD moves the
    product's columns that straddle a piece's boundary, this moves the
    weight's, of which a sequence of more than ``d_model`` tokens has
    fewer.  None otherwise (plain tensors, or a one-rank split)."""
    from torch.distributed.tensor import Replicate, Shard

    w = params["in_proj"]
    if not is_dtensor(x) or not any(
            t.placements[i] == Shard(t.ndim - 1) and x.device_mesh.size(i) > 1
            for t in (w, params["conv_w"]) for i in range(x.device_mesh.ndim)):
        return None
    di, gn, h = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state, cfg.ssm_heads
    split = _heads_split(cfg, params["a_log"], x)

    rows = [q == Shard(0) for q in params["out_proj"].placements]

    def pls(t, by):
        last = Shard(t.ndim - 1)
        return [[last if on else p if p != last else Replicate()
                 for on, p in zip(split_on, t.placements)]
                for split_on in by]

    grouped = split if cfg.ssm_groups > 1 else [False] * len(split)
    # z split as out_proj's rows, so that its gated product stays
    # row-parallel where the heads are whole
    proj = (rows, split, grouped, grouped, split)
    conv = (split, grouped, grouped)

    def make(dtype):
        # the columns first, then each piece's FSDP rows: a rank gathers
        # the rows of its own pieces only
        cuts = tuple(itertools.accumulate((0, di, di, gn, gn, h)))
        conv_cuts = tuple(itertools.accumulate((0, di, gn, gn)))
        return (tuple(product_weight(t, dtype) for t in _Columns.apply(
            w.to(dtype), cuts, pls(w, proj))),
                *(_Columns.apply(params[k].to(dtype), conv_cuts,
                                 pls(params[k], conv))
                  for k in ("conv_w", "conv_b")))

    return make


def ssm_apply(params: dict, x: torch.Tensor, cfg, compute_dtype,
              h0: Optional[torch.Tensor] = None, return_state: bool = False):
    """Full-sequence SSD block: ``x`` (B, S, D) -> (B, S, D).

    ``return_state``: returns ``(out, SSMCache)``, the cache that decoding
    continues from: the last K-1 pre-conv channel inputs (taken from this
    call's ``in_proj`` product; the reference computes that product again)
    and the final SSM state (the reference's ``(out, final_state)``).

    Of a DTensor ``x`` (sharded by batch) under sharded parameters: the
    products and the conv run on :func:`_pieces` where the mesh splits
    their columns (else ``in_proj``'s product is taken whole and the conv's
    output gathered for the x | B | C split), the SSD runs over the batch
    and, where they divide, the heads (:func:`ssd_chunked`), and
    ``out_proj``'s product is the row-parallel ``Partial`` sum that the
    caller's ``shard_act(..., "btd")`` reduces."""
    x = gather_seq(x)
    b, s, _ = x.shape
    di, g, n, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    p = cfg.ssm_head_dim
    pieces = _pieces(cfg, params, x)
    if pieces is None:
        proj = x @ product_weight(params["in_proj"], compute_dtype)
        z, xbc_in, dt = _split_proj(cfg, proj)
        xbc = _causal_conv(xbc_in, params["conv_w"].to(compute_dtype),
                           params["conv_b"].to(compute_dtype))
        if is_dtensor(xbc):
            # the conv's channel shards all-gathered for the x | B | C split
            xbc = shard_like(xbc, xbc, {0: 0})
        xs, bmat, cmat = (xbc[..., :di], xbc[..., di:di + g * n],
                          xbc[..., di + g * n:])
    else:
        w, conv_w, conv_b = pieces(compute_dtype)
        z, x_in, b_in, c_in, dt = (x @ t for t in w)
        xbc_in = (x_in, b_in, c_in)
        xs, bmat, cmat = (_causal_conv(t, cw, cb) for t, cw, cb in
                          zip(xbc_in, conv_w, conv_b))
    xs = xs.reshape(b, s, h, p)
    bmat = bmat.reshape(b, s, g, n)
    cmat = cmat.reshape(b, s, g, n)
    dt = F.softplus(dt.to(torch.float32)
                    + params["dt_bias"].to(torch.float32))
    a = -torch.exp(params["a_log"].to(torch.float32))

    y, hf = ssd_chunked(xs.to(torch.float32), dt, a,
                        bmat.to(torch.float32), cmat.to(torch.float32),
                        chunk=min(cfg.ssm_chunk, s), h0=h0)
    y = y.to(compute_dtype)
    skip = params["d_skip"].to(compute_dtype)
    gathered = is_dtensor(y) and pieces is None
    if gathered:
        # the gathered conv output's x (and the skip) lined up with y's
        # heads: a local slice, whose gradient is all-gathered back
        xs, skip = shard_like(xs, y, {0: 0, 2: 2}), shard_like(skip, y, {2: 0})
    y = (y + xs * skip[None, None, :, None]).reshape(b, s, di)
    if is_dtensor(y):
        # the heads' merge's gradient laid out as its forward: where the
        # heads are split, no collective, and its view back to (B, S, H,
        # P) cuts no head; where they are whole, the all-gather that the
        # SSD's backward on every rank's copy needs
        y = shard_like(y, y, {0: 0, 2: 2})
    if gathered:
        # the gathered product's z lined up with y (a local slice; its
        # gradient all-gathered back)
        z = shard_like(z, y, {0: 0, 2: 2})
    out = (y * F.silu(z)) @ product_weight(params["out_proj"], compute_dtype)
    if return_state:
        # a copy: a view would hold the whole projection alive
        k = cfg.ssm_conv - 1
        conv = xbc_in[:, -k:].clone() if pieces is None else torch.cat(
            [t[:, -k:] for t in xbc_in], dim=-1)
        return out, SSMCache(conv=conv, state=hf)
    return out


def init_ssm_cache(cfg, batch: int, dtype, *, device) -> SSMCache:
    return SSMCache(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, _conv_channels(cfg)),
                         dtype=dtype, device=device),
        state=torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                           cfg.ssm_state), dtype=torch.float32,
                          device=device))


def _recurrence(state, xs, bmat, cmat, dt, a):
    """One step of the SSM recurrence: ``state`` (B, H, P, N) float32,
    ``xs`` (B, H, P), ``bmat`` / ``cmat`` (B, G, N), ``dt`` (B, H), ``a``
    (H,); returns ``(y (B, H, P) float32, new state)``."""
    rep = xs.shape[1] // bmat.shape[1]
    bmat, cmat = _repeat_groups(bmat, rep, 1), _repeat_groups(cmat, rep, 1)
    decay = torch.exp(dt * a[None, :])                   # (B, H)
    upd = (dt[:, :, None, None] * xs.to(torch.float32)[..., None]
           * bmat.to(torch.float32)[:, :, None, :])      # (B, H, P, N)
    state = state * decay[:, :, None, None] + upd
    return torch.matmul(state, cmat.to(torch.float32)[..., None])[..., 0], \
        state


def _recurrence_sharded(state, xs, bmat, cmat, dt, a):
    """:func:`_recurrence` of a DTensor ``state`` on each rank's shard of it
    (batch, and P or H over ``model`` as the decode cache is laid out), the
    other operands cut to match; ``y`` comes back with its heads' columns
    gathered (B, H, P), sharded as the state's batch and heads."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map

    groups = {0: 0}
    if bmat.shape[1] > 1:
        n = [state.device_mesh.size(i) for i, p in
             enumerate(state.placements) if p == Shard(1)]
        if any(bmat.shape[1] % m for m in n):
            raise ValueError(f"{bmat.shape[1]} SSM groups do not divide the "
                             f"head shards {n} of the decode state")
        groups[1] = 1
    xs = shard_like(xs, state, {0: 0, 1: 1, 2: 2})
    bmat, cmat = (shard_like(t, state, groups) for t in (bmat, cmat))
    dt, a = shard_like(dt, state, {0: 0, 1: 1}), shard_like(a, state, {1: 0})
    st_pl = list(state.placements)
    pl = [list(t.placements) for t in (state, xs, bmat, cmat, dt, a)]
    y, state = local_map(_recurrence, out_placements=(pl[1], st_pl),
                         in_placements=tuple(pl),
                         device_mesh=state.device_mesh)(
        state, xs, bmat, cmat, dt, a)
    return shard_like(y, state, {0: 0, 1: 1}), state


def ssm_decode(params: dict, x: torch.Tensor, cache: SSMCache, cfg,
               compute_dtype):
    """One-token recurrent update: ``x`` (B, 1, D) -> ``(out, new_cache)``;
    the cache given is not modified.  Of DTensors, the conv runs on the
    channel shards and the recurrence on the state's shards
    (``_recurrence_sharded``)."""
    b = x.shape[0]
    di, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    h, p = cfg.ssm_heads, cfg.ssm_head_dim
    proj = x @ product_weight(params["in_proj"], compute_dtype)
    z, xbc, dt = _split_proj(cfg, proj)

    # causal conv against the cached window
    conv, w = cache.conv, params["conv_w"].to(compute_dtype)
    bias = params["conv_b"].to(compute_dtype)
    if is_dtensor(conv):
        conv, xbc = _channels_like(conv, w, 1), _channels_like(xbc, w, 1)
    win = torch.cat([conv, xbc], dim=1)                  # (B, K, C)
    conv_out = (win * w[None]).sum(dim=1, keepdim=True)
    xbc1 = F.silu(conv_out + bias)
    if is_dtensor(xbc1):
        xbc1 = shard_like(xbc1, xbc1, {0: 0})

    xs = xbc1[..., :di].reshape(b, h, p)
    bmat = xbc1[..., di:di + g * n].reshape(b, g, n)
    cmat = xbc1[..., di + g * n:].reshape(b, g, n)
    dt = F.softplus(dt[:, 0].to(torch.float32)
                    + params["dt_bias"].to(torch.float32))     # (B, H)
    a = -torch.exp(params["a_log"].to(torch.float32))
    step = _recurrence_sharded if is_dtensor(cache.state) else _recurrence
    y, state = step(cache.state, xs, bmat, cmat, dt, a)
    y = y.to(compute_dtype)
    skip = params["d_skip"].to(compute_dtype)
    if is_dtensor(y):
        xs, skip = shard_like(xs, y, {0: 0, 1: 1}), shard_like(skip, y, {1: 0})
    y = (y + xs * skip[None, :, None]).reshape(b, 1, di)
    if is_dtensor(y):
        z = shard_like(z, y, {0: 0, 2: 2})
    out = (y * F.silu(z)) @ product_weight(params["out_proj"], compute_dtype)
    return out, SSMCache(conv=win[:, 1:], state=state)
