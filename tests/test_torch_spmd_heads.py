"""The pieces of the port's sharded step that hold its collectives to the
reference's, as units on the CPU (fake process groups: one process as rank
0, collectives moving nothing; the 2 x 2 gloo runs of
``test_torch_spmd.py`` hold their values end to end).

- K6 by query heads: which kv head a rank's query heads read
  (``query_heads_kv``); each rank's heads on that one kv head equal the
  whole attention's heads, forward and backward (dk and dv summed over the
  ranks); rank 0's DTensor call keeps q's placements and leaves dk a
  ``Partial`` sum; ``attn_heads_dim`` and ``attn_stripe_dim`` under the
  switches.
- ``product_weight``: a sharded product's FSDP weight all-gathered once,
  forward and backward, where DTensor's own product gathers it twice.
- ``redistribute``: a ``Partial`` sum over both mesh dimensions reduced
  by one all-reduce.
- The remat recompute takes its forward's all-reduces: a remat step
  reduces the same bytes as one without.
- The vocabulary-sharded embedding lookup: rank 0's masked rows, the
  table's gradient a ``Partial`` sum over the batch's shards.
- The SSM's column pieces: rank 0's shard of each piece of a weight.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from _spmd_count import port_bytes
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.configs import registry
from repro_torch.distributed.sharding import (ShardCtx, attn_heads_dim,
                                              attn_stripe_dim, product_weight,
                                              redistribute, use_ctx)
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_backward, flash_attention_plain)
from repro_torch.kernels.flash_attention.ops import (
    flash_attention_query_heads, query_heads_kv)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import device_mesh, fake_process_group

# (Hq, Hkv, ranks) -> each rank's kv head, or None where the split keeps no
# rank's query heads inside one kv head's group (or the kv heads divide)
KV_OF = [((4, 1, 2), [0, 0]), ((32, 2, 16), [r // 8 for r in range(16)]),
         ((32, 8, 16), [r // 2 for r in range(16)]),
         ((16, 8, 16), [r // 2 for r in range(16)]),
         ((12, 3, 4), None), ((4, 2, 2), None), ((3, 1, 2), None)]


@pytest.mark.parametrize("heads,want", KV_OF)
def test_query_heads_kv_is_the_group_of_each_rank_s_heads(heads, want):
    hq, hkv, n = heads
    got = [query_heads_kv(hq, hkv, n, r) for r in range(n)]
    if want is None:
        assert got == [None] * n
        return
    assert got == want
    group = hq // hkv
    for r, kv in enumerate(got):
        first = r * hq // n
        assert {h // group for h in range(first, first + hq // n)} == {kv}


def _qkv(b, hq, hkv, s, d, seed=0):
    r = np.random.RandomState(seed)
    return [torch.as_tensor(r.randn(b, h, s, d).astype(np.float32))
            for h in (hq, hkv, hkv)]


@pytest.mark.parametrize("hq,hkv,n,window", [(4, 1, 2, 0), (8, 2, 4, 0),
                                             (8, 2, 8, 24), (6, 1, 3, 0)])
def test_query_heads_on_their_kv_head_equal_the_whole(hq, hkv, n, window):
    """Each of ``n`` ranks' query heads on its one kv head: the whole
    attention's heads, forward; backward dq its heads' and dk, dv summed
    over the ranks the whole's."""
    b, s, d = 2, 80, 32
    q, k, v = _qkv(b, hq, hkv, s, d)
    dout = torch.as_tensor(np.random.RandomState(1).randn(
        b, hq, s, d).astype(np.float32))
    whole = flash_attention_plain(q, k, v, causal=True, window=window)
    dq, dk, dv = flash_attention_backward(q, k, v, dout, True, window)
    sk, sv = torch.zeros_like(dk), torch.zeros_like(dv)
    w = hq // n
    for r in range(n):
        kv = query_heads_kv(hq, hkv, n, r)
        heads = slice(r * w, (r + 1) * w)
        ks, vs = k[:, kv:kv + 1], v[:, kv:kv + 1]
        out = flash_attention_plain(q[:, heads], ks, vs, causal=True,
                                    window=window)
        torch.testing.assert_close(out, whole[:, heads], rtol=1e-5,
                                   atol=1e-6)
        gq, gk, gv = flash_attention_backward(q[:, heads], ks, vs,
                                              dout[:, heads], True, window)
        torch.testing.assert_close(gq, dq[:, heads], rtol=1e-5,
                                   atol=1e-6 * float(dq.abs().max()))
        sk[:, kv:kv + 1] += gk
        sv[:, kv:kv + 1] += gv
    for got, want in ((sk, dk), (sv, dv)):
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-6 * float(want.abs().max()))


def test_query_heads_dtensor_rank_0():
    """Rank 0 of a 1 x 2 fake group, 4 query heads over ``model`` and 1 kv
    head replicated: its output is the whole's first two heads, sharded as
    q; its dk a ``Partial`` sum over ``model``; no collective."""
    b, hq, hkv, s, d = 2, 4, 1, 64, 32
    q, k, v = _qkv(b, hq, hkv, s, d)
    whole = flash_attention_plain(q, k, v, causal=True, window=0)
    with fake_process_group(2):
        mesh = device_mesh((1, 2), ("data", "model"), "cpu")
        dq = DTensor.from_local(q[:, :2].clone(), mesh,
                                [Replicate(), Shard(1)], run_check=False,
                                shape=q.shape, stride=q.stride())
        dk, dv = (distribute_tensor(t, mesh, [Replicate(), Replicate()])
                  .requires_grad_(True) for t in (k, v))
        dq.requires_grad_(True)
        work = dryrun.count_sharded(
            lambda q, k, v: flash_attention_query_heads(q, k, v, True, 0, 1),
            dq, dk, dv)
        out = flash_attention_query_heads(dq, dk, dv, True, 0, 1)
        assert tuple(out.placements) == (Replicate(), Shard(1))
        torch.testing.assert_close(out.to_local(), whole[:, :2], rtol=1e-5,
                                   atol=1e-6)
        out.sum().backward()
        assert dk.grad is not None
        assert work.collectives == []


def test_query_heads_take_the_place_of_stripes_and_heads_rule():
    with fake_process_group(4):
        mesh = device_mesh((2, 2), ("data", "model"), "cuda")
        for switches in ({}, {"attn_seq_shard": True}):
            with use_ctx(ShardCtx(mesh=mesh, **switches)):
                assert attn_heads_dim(4, 1) == 1
                assert attn_heads_dim(4, 2) is None     # both divide
                assert attn_heads_dim(3, 1) is None     # q heads do not
                assert attn_stripe_dim(4, 1) is None
                assert (attn_stripe_dim(3, 1) == 1) == bool(switches)
    assert attn_heads_dim(4, 1) is None                 # no context


def test_product_weight_gathers_once_a_use():
    """x (batch over data) @ w (FSDP rows over data, columns over model),
    forward and backward: through ``product_weight`` the weight's one
    all-gather (its shard's rows over data) and its gradient's one
    reduce-scatter; besides, only x's gradient, a ``Partial`` sum over
    model, is all-reduced where it accumulates.  The product is sharded as
    x's batch and w's columns."""
    with fake_process_group(4):
        mesh = device_mesh((2, 2), ("data", "model"), "cuda")
        ctx = ShardCtx(mesh=mesh)
        x = distribute_tensor(torch.empty((8, 16, 32), device="meta"),
                              mesh, [Shard(0), Replicate()],
                              src_data_rank=None).requires_grad_(True)
        w = distribute_tensor(torch.empty((32, 64), device="meta"), mesh,
                              [Shard(0), Shard(1)],
                              src_data_rank=None).requires_grad_(True)

        def fn(x, w):
            with use_ctx(ctx):
                out = x @ product_weight(w, torch.float32)
                out.backward(torch.ones_like(out))
                return out

        work = dryrun.count_sharded(fn, x, w)
        with use_ctx(ctx):
            out = x @ product_weight(w, torch.float32)
    assert tuple(out.placements) == (Shard(0), Shard(2))
    assert sorted(work.collectives) == [("all-gather", 32 * 32 * 4),
                                        ("all-reduce", 4 * 16 * 32 * 4),
                                        ("reduce-scatter", 16 * 32 * 4)]


@pytest.mark.parametrize("pl,want", [
    ((Partial(), Partial()), [("all-reduce", 12)]),
    ((Shard(0), Partial()), [("all-reduce", 12), ("all-gather", 24)])])
def test_redistribute_reduces_both_dimensions_at_once(pl, want):
    """A ``Partial`` sum over both dimensions of a 2 x 2 mesh made
    replicated: one all-reduce over the flattened group (DTensor, in some
    PyTorch versions, runs one a dimension); a sum over one dimension is
    DTensor's own redistribution."""
    with fake_process_group(4):
        mesh = device_mesh((2, 2), ("data", "model"), "cuda")
        t = DTensor.from_local(torch.empty((3,), device="meta"), mesh,
                               list(pl), run_check=False,
                               shape=(6 if pl[0] == Shard(0) else 3,),
                               stride=(1,))
        work = dryrun.count_sharded(
            lambda t: redistribute(t, [Replicate(), Replicate()]), t)
        out = redistribute(t, [Replicate(), Replicate()])
    assert sorted(work.collectives) == sorted(want)
    assert tuple(out.placements) == (Replicate(), Replicate())


@pytest.mark.parametrize("case", ("gemma3-1b", "zamba2-1.2b"))
def test_remat_recompute_reduces_nothing_again(case):
    """With ``remat`` the recompute takes its forward's all-reduces: the
    step's all-reduce bytes equal those without; its weights are gathered
    again, as the reference's recompute gathers them."""
    plain = port_bytes(case, (4, 16))
    remat = port_bytes(case, (4, 16), remat=True)
    assert remat["all-reduce"] == plain["all-reduce"] > 0
    assert remat["all-gather"] > plain["all-gather"]


def test_vocabulary_sharded_lookup_rank_0():
    """Rank 0 of a 2 x 2 fake group holds vocabulary rows 0..V/2 of the
    table (rows over ``model``): its lookup is the embedding of the tokens
    in them and zeros elsewhere, a ``Partial`` sum over ``model``; the
    table's gradient is rank 0's rows, a ``Partial`` sum over ``data``."""
    from repro_torch.models.transformer import _lookup

    v, d = 16, 4
    table = torch.randn(v, d)
    tokens = torch.tensor([[0, 7, 8, 15], [3, 9, 1, 12]])
    with fake_process_group(4):
        mesh = device_mesh((2, 2), ("data", "model"), "cpu")
        emb = DTensor.from_local(table[:v // 2].clone(), mesh,
                                 [Replicate(), Shard(0)], run_check=False,
                                 shape=table.shape, stride=table.stride())
        emb.requires_grad_(True)
        tok = DTensor.from_local(tokens[:1], mesh, [Shard(0), Replicate()],
                                 run_check=False, shape=tokens.shape,
                                 stride=tokens.stride())
        out = _lookup(emb, tok)
        assert tuple(out.placements) == (Shard(0), Partial())
        want = F.embedding(tokens[:1], table) * (tokens[:1] < v // 2)[
            ..., None]
        torch.testing.assert_close(out.to_local(), want)
        out.to_local().sum().backward()
        assert tuple(emb.grad.placements) == (Partial(), Shard(0))
        counts = torch.bincount(tokens[:1].reshape(-1), minlength=v)[:v // 2]
        torch.testing.assert_close(emb.grad.to_local(),
                                   counts[:, None].float().expand(-1, d))


def test_ssm_column_pieces_rank_0():
    """mamba2-130m's SMOKE ``in_proj`` (64 x 296: z 128 | x 128 | B 16 |
    C 16 | dt 8) with its columns over ``model`` (148 a rank) cut into
    pieces on a 2 x 2 fake group: rank 0 holds z's, x's and dt's first
    halves and the whole B and C, its FSDP rows kept."""
    from repro_torch.models.ssm import _Columns

    cfg = registry.get_smoke_config("mamba2-130m")
    di, gn, h = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state, cfg.ssm_heads
    w = torch.randn(cfg.d_model, 2 * di + 2 * gn + h)
    cuts = (0, di, 2 * di, 2 * di + gn, 2 * di + 2 * gn, w.shape[1])
    split, whole = [Shard(0), Shard(1)], [Shard(0), Replicate()]
    with fake_process_group(4):
        mesh = device_mesh((2, 2), ("data", "model"), "cpu")
        dw = DTensor.from_local(
            w[:w.shape[0] // 2, :w.shape[1] // 2].clone(), mesh, split,
            run_check=False, shape=w.shape, stride=w.stride())
        pieces = _Columns.apply(dw, cuts, [split, split, whole, whole,
                                           split])
    rows = w.shape[0] // 2
    for piece, a, b, pl in zip(pieces, cuts[:-1], cuts[1:],
                               [split, split, whole, whole, split]):
        assert list(piece.placements) == pl
        assert piece.shape == (w.shape[0], b - a)
        # the fake group gathers rank 0's own columns again; its pieces'
        # first halves are rank 0's, read from the gathered local copy
        cols = (b - a) // 2 if pl == split else b - a
        assert piece.to_local().shape == (rows, cols)
    np.testing.assert_array_equal(pieces[0].to_local().numpy(),
                                  w[:rows, :di // 2].numpy())
