"""Sequence parallelism in the port's SPMD program (the reference's
``seq_shard`` residual and ``attn_seq_shard`` attention), and K6's query
stripes, on the CPU.

- A 2 x 2 ("data", "model") gloo mesh (``tests/_spmd_worker.py``) runs each
  case's float32 train step, prefill and 4 decode steps (the decode steps
  with ``seq_shard`` off, as the reference's dry run decodes) under
  ``ShardCtx(seq_shard=True)`` (``#seq``), ``ShardCtx(attn_seq_shard=True)``
  (``#attn``) or both (``#both``), for the ``SMOKE`` configurations of
  smollm-360m (3 / 1 heads: the query stripes), deepseek-moe-16b,
  mamba2-130m (``#seq`` only: it has no attention), zamba2-1.2b,
  internvl2-1b (7 / 1 heads: the stripes) and
  whisper-medium (and whisper at 15 encoder frames, which the model axis
  does not divide): equal to plain tensors within ``rtol=1e-5`` and to the
  reference's GSPMD program under the same ``ShardCtx`` within ``2e-3``,
  as ``test_torch_spmd.py`` holds the layouts without the switches.
- K6's stripe (``row_base``) against the reference's Pallas kernel,
  interpreted, taking the rows of its whole output: causal, windowed,
  bidirectional and GQA, float32 at ``2e-4`` and bfloat16 at ``5e-2``;
  its backward (dq the whole's rows, dk and dv summed over the stripes the
  whole's, ``rtol=1e-5``); the stripes' pairs summing to the whole's.
- Counts: a stripe's FLOPs are the busiest stripe's of its width (the
  last), per device on a fake group too; the gathered-before-product
  placement (every local product of a sequence-sharded forward takes whole
  sequences); the dry run's ``prefill_32k`` cells with ``seq_shard`` on
  and an ``attn_seq_shard`` train cell counted alike on CPU and meta
  shards.

Each subprocess has its own time limit (120 s); they run one at a time.
"""
import dataclasses
import json
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_spmd import (B, N_DECODE, OPT, REF_TOL, ROOT, S, SRC, TOL,
                             _close, _names, _placements, _run)
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.utils.flop_counter import FlopCounterMode

from repro.kernels.flash_attention import flash_attention as r_flash
from repro_torch.configs import registry, shapes
from repro_torch.distributed.sharding import (ShardCtx, attn_heads_dim,
                                              attn_stripe_dim, gather_seq,
                                              placements,
                                              shard_act, shard_params,
                                              use_ctx)
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.kernels.flash_attention.flash_attention import (
    _mask, attention_pairs, attention_work, flash_attention_backward)
from repro_torch.kernels.flash_attention.ops import (flash_attention_fwd,
                                                     flash_attention_striped)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import device_mesh, fake_process_group
from repro_torch.models.transformer import init_lm

SWITCHES = {"seq": {"seq_shard": True}, "attn": {"attn_seq_shard": True},
            "both": {"seq_shard": True, "attn_seq_shard": True}}
OVERRIDES = {"whisper-medium@15frames": {"encoder_frames": 15}}
# mamba2-130m has no attention: attn_seq_shard alone leaves its program
# as test_torch_spmd.py runs it
GROUPS = (("smollm-360m#seq", "smollm-360m#attn", "smollm-360m#both",
           "internvl2-1b#seq"),
          ("internvl2-1b#attn", "deepseek-moe-16b#seq",
           "deepseek-moe-16b#attn"),
          ("mamba2-130m#seq", "zamba2-1.2b#seq", "zamba2-1.2b#attn"),
          ("whisper-medium#seq", "whisper-medium#attn",
           "whisper-medium@15frames#seq"))
CASES = sum(GROUPS, ())


def _split(case):
    """``(variant, arch, switches)`` of ``arch[@name]#switches``."""
    variant, sw = case.split("#")
    return variant, variant.split("@")[0], SWITCHES[sw]


def _reference_code(out, cases) -> str:
    """The reference's run of ``cases`` on 4 forced host devices, each
    under its ``ShardCtx`` switches (decode with ``seq_shard`` off)."""
    runs = {c: (_split(c)[1], OVERRIDES.get(_split(c)[0], {}), _split(c)[2])
            for c in cases}
    return textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        import dataclasses, json, sys, warnings
        sys.path.insert(0, {SRC!r})
        warnings.simplefilter("ignore", DeprecationWarning)
        import numpy as np
        import jax, jax.numpy as jnp
        from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
        from repro.configs.registry import get_smoke_config
        from repro.distributed.sharding import (ShardCtx, param_shardings,
                                                use_ctx)
        from repro.launch.roofline import collective_bytes
        from repro.models.transformer import init_lm
        from repro.models.whisper import init_encdec
        from repro.serving.decode import decode_step, prefill
        from repro.training.optimizer import AdamWConfig
        from repro.training.train_step import (init_train_state,
                                               make_train_step)

        mesh = jax.make_mesh((2, 2), ("data", "model"),
                             axis_types=(AxisType.Auto, AxisType.Auto))
        opt = AdamWConfig(**{OPT!r})
        flat = lambda tree, pre: {{
            pre + "/".join(k.key for k in path): np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}}
        coll = {{}}
        for case, (arch, over, switches) in {runs!r}.items():
            cfg = dataclasses.replace(get_smoke_config(arch),
                                      dtype="float32", **over)
            ctx = ShardCtx(mesh=mesh, **switches)
            dctx = dataclasses.replace(ctx, seq_shard=False)
            audio = cfg.family == "audio"
            params = (init_encdec if audio else init_lm)(
                cfg, jax.random.PRNGKey(0))
            r = np.random.RandomState(0)
            tokens = r.randint(0, cfg.vocab_size, ({B}, {S} + 1))
            decode = r.randint(0, cfg.vocab_size, ({B}, {N_DECODE}))
            extras = {{}}
            if cfg.family in ("vlm", "audio"):
                name, n = ("frames", cfg.encoder_frames) if audio else (
                    "patches", cfg.n_patches)
                extras[name] = r.randn({B}, n, cfg.d_model).astype(
                    np.float32)
            np.savez(f"{out}/{{case}}_inputs.npz", **flat(params, "p/"),
                     tokens=tokens.astype(np.int32),
                     decode=decode.astype(np.int32),
                     overrides=np.array(json.dumps(over)),
                     ctx=np.array(json.dumps(switches)), **extras)
            params = jax.device_put(params, param_shardings(
                params, ctx, expert_parallel=cfg.expert_parallel))
            rows = NamedSharding(mesh, P("data", None))
            tokens = jax.device_put(jnp.asarray(tokens, jnp.int32), rows)
            decode = jax.device_put(jnp.asarray(decode, jnp.int32), rows)
            extras = {{k: jax.device_put(jnp.asarray(v), NamedSharding(
                mesh, P("data", None, None))) for k, v in extras.items()}}
            step = make_train_step(cfg, opt)

            def train(s, b):
                with use_ctx(ctx):
                    return step(s, b)

            def pre(p, t, e):
                with use_ctx(ctx):
                    return prefill(p, t, cfg, **e)

            def dec(p, t, s):
                with use_ctx(dctx):
                    return decode_step(p, t, s, cfg)

            res = {{}}
            with mesh:
                state = init_train_state(params, opt)
                batch = {{"tokens": tokens, **extras}}
                compiled = jax.jit(train).lower(state, batch).compile()
                coll[case] = collective_bytes(compiled.as_text())
                new, metrics = compiled(state, batch)
                res["loss"] = np.asarray(metrics["loss"])
                res["grad_norm"] = np.asarray(metrics["grad_norm"])
                res.update(flat(new.params, "param/"))
                res.update(flat(new.opt.mu, "mu/"))
                logits, dstate = jax.jit(pre)(params, tokens[:, :-1], extras)
                res["prefill"] = np.asarray(logits)
                dec = jax.jit(dec)      # traced once for the N steps
                for i in range({N_DECODE}):
                    logits, dstate = dec(params, decode[:, i:i + 1], dstate)
                    res[f"decode/{{i}}"] = np.asarray(logits)
            np.savez(f"{out}/{{case}}_ref.npz", **res)
        print(json.dumps(coll))
    """)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's weights, inputs and sharded results (one 4-device
    subprocess a group of cases), then the port's sharded and plain results
    (one 4-rank gloo run a group).  The subprocesses run one at a time: the
    other SPMD test files run theirs beside this one."""
    out = tmp_path_factory.mktemp("spmd_seq")
    coll = {}
    for cases in GROUPS:
        stdout = _run([sys.executable, "-c", _reference_code(out, cases)],
                      f"the reference's run of {cases}")
        coll.update(json.loads(stdout.strip().splitlines()[-1]))
    for cases in GROUPS:
        _run([sys.executable, str(ROOT / "tests" / "_spmd_worker.py"),
              str(out), *cases], f"the port's 2 x 2 gloo run of {cases}")
    return out, {case: dict(np.load(out / f"{case}_out.npz"))
                 for case in CASES}, coll


def _cache_placements(cfg) -> dict:
    """The reference's decode-cache layout over (L, B, ...) on a 2 x 2
    mesh: the batch over data; kv heads over model when they divide it,
    else the slots; an SSM state's P and a conv cache's channels."""
    batch_and = "(Shard(dim=1), Shard(dim={}))".format
    kv = batch_and(3 if cfg.n_kv_heads % 2 == 0 else 2)
    if cfg.family in ("ssm", "hybrid"):
        want = {"ssm/conv": batch_and(3), "ssm/state": batch_and(3)}
        if cfg.family == "hybrid":
            want.update({"shared_kv/k": kv, "shared_kv/v": kv})
        return want
    want = {"kv/k": kv, "kv/v": kv}
    if cfg.family == "audio":
        want.update({"cross_k": kv, "cross_v": kv})
    return want


@pytest.mark.parametrize("case", CASES)
def test_sequence_sharded_step_prefill_decode_equal_the_unsharded_port(
        case, runs):
    _, port, _ = runs
    res = port[case]
    names = _names(res, "plain/")
    assert names == _names(res, "spmd/") and len(names) > 10
    for name in names:
        _close(name, res[f"spmd/{name}"], res[f"plain/{name}"], TOL, 1e-6)
    variant, arch, _ = _split(case)
    cfg = dataclasses.replace(registry.get_smoke_config(arch),
                              **OVERRIDES.get(variant, {}))
    assert _placements(res) == _cache_placements(cfg)


@pytest.mark.parametrize("case", CASES)
def test_sequence_sharded_step_prefill_decode_equal_the_reference(case,
                                                                  runs):
    out, port, _ = runs
    ref = dict(np.load(out / f"{case}_ref.npz"))
    init = dict(np.load(out / f"{case}_inputs.npz"))
    res = port[case]
    assert sorted(ref) == _names(res, "spmd/", skip=("table",))
    for name, want in ref.items():
        _close(name, res[f"spmd/{name}"], want, REF_TOL, REF_TOL)
    # one AdamW step moves a parameter by about lr: the update itself,
    # new - initial, within REF_TOL of its own largest magnitude
    for name in (n for n in ref if n.startswith("param/")):
        w0 = init["p/" + name[len("param/"):]]
        want = ref[name] - w0
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(
            res[f"spmd/{name}"] - w0, want, rtol=REF_TOL,
            atol=REF_TOL * float(np.abs(want).max()), err_msg=name)


# the port's collective bytes of those steps before they were held to the
# reference's (tests/test_torch_spmd_bytes.py): none may rise above them
WAS_COLLECTIVES = {"smollm-360m#seq": 748_048, "smollm-360m#attn": 742_928,
                   "mamba2-130m#seq": 924_784}


@pytest.mark.parametrize("case", tuple(WAS_COLLECTIVES))
def test_collective_bytes_printed_beside_the_reference(case, runs):
    """The port's collectives of the case's SMOKE train step on the same
    2 x 2 mesh under its switches (counted on meta under a fake group),
    printed beside the reference's HLO count and beside the port's without
    the switches, and no higher than ``WAS_COLLECTIVES``.  Under
    ``seq_shard`` the residual's reductions are reduce-scatters in
    both."""
    from repro_torch.launch.roofline import collective_bytes
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)

    _, _, ref = runs
    _, arch, switches = _split(case)
    cfg = dataclasses.replace(registry.get_smoke_config(arch),
                              dtype="float32")
    got = {}
    with fake_process_group(4):
        mesh = device_mesh((2, 2), ("data", "model"), "cuda")
        for name, sw in (("port", switches), ("port without", {})):
            ctx = ShardCtx(mesh=mesh, **sw)
            opt = AdamWConfig(**OPT)
            state = init_train_state(shard_params(
                init_lm(cfg, 0, device="meta"), ctx), opt)
            tokens = distribute_tensor(
                torch.empty((B, S + 1), dtype=torch.int64, device="meta"),
                mesh, placements(("data", None), mesh), src_data_rank=None)
            step = make_train_step(cfg, opt)

            def fn(state, tokens):
                with use_ctx(ctx):
                    return step(state, {"tokens": tokens})

            got[name] = collective_bytes(dryrun.count_sharded(
                fn, state, tokens).collectives)
    print(f"{case}: port {got['port']}; port without the switches "
          f"{got['port without']}; reference HLO {ref[case]}")
    assert got["port"]["total"] > 0 and ref[case]["total"] > 0
    assert got["port"]["total"] <= WAS_COLLECTIVES[case]
    if switches.get("seq_shard"):
        assert got["port"]["reduce-scatter"] > \
            got["port without"]["reduce-scatter"]


# K6's query stripes: (name, B, Hq, Hkv, S, D, causal, window); the
# bidirectional case's S is a multiple of the reference kernel's 32-key
# block (it lets zero-padded keys in otherwise, ROADMAP Queue 3)
K6_STRIPES = [("causal", 1, 4, 2, 128, 64, True, 0),
              ("windowed", 1, 3, 1, 128, 64, True, 40),
              ("bidirectional", 2, 2, 2, 96, 32, False, 0),
              ("gqa", 1, 8, 2, 128, 16, True, 0)]
# stripe boundaries: even stripes, and stripes whose row_base is not a
# multiple of the kernels' 64-row tile
CUTS = {128: ([0, 32, 64, 96, 128], [0, 37, 90, 128]),
        96: ([0, 24, 48, 72, 96], [0, 37, 61, 96])}


def _qkv(seed, b, hq, hkv, s, d):
    r = np.random.RandomState(seed)
    return [r.randn(b, h, s, d).astype(np.float32) for h in (hq, hkv, hkv)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("name,b,hq,hkv,s,d,causal,window", K6_STRIPES)
def test_k6_stripes_match_the_reference_kernel(name, b, hq, hkv, s, d,
                                               causal, window, dtype, tol):
    """Each stripe of K6's plain version (the operator on CPU tensors,
    ``row_base`` its first row) against the rows of the reference's Pallas
    kernel's whole output (interpreted) and the port's oracle at the
    stripe's offset."""
    arrays = _qkv(s + d, b, hq, hkv, s, d)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(r_flash(*(jnp.asarray(a, jdt) for a in arrays),
                              causal=causal, window=window, block_q=32,
                              block_k=32), np.float32)
    q, k, v = (torch.as_tensor(a).to(dtype) for a in arrays)
    for cuts in CUTS[s]:
        for r0, r1 in zip(cuts[:-1], cuts[1:]):
            got = flash_attention_fwd(q[:, :, r0:r1].contiguous(), k, v,
                                      causal, window, r0)
            assert got.dtype == dtype and got.shape == (b, hq, r1 - r0, d)
            np.testing.assert_allclose(got.float().numpy(),
                                       want[:, :, r0:r1], rtol=tol, atol=tol,
                                       err_msg=f"{name} rows {r0}:{r1}")
            np.testing.assert_allclose(
                got.float().numpy(), flash_attention_ref(
                    q[:, :, r0:r1], k, v, causal, window, r0).float().numpy(),
                rtol=tol, atol=tol)


@pytest.mark.parametrize("name,b,hq,hkv,s,d,causal,window", K6_STRIPES)
def test_k6_stripe_backward_sums_to_the_whole(name, b, hq, hkv, s, d, causal,
                                              window):
    """The stripes' backwards: each dq the whole's rows, dk and dv summed
    over the stripes the whole's (a stripe's share of the sum)."""
    q, k, v = (torch.as_tensor(a) for a in _qkv(s * d, b, hq, hkv, s, d))
    dout = torch.as_tensor(np.random.RandomState(1).randn(
        b, hq, s, d).astype(np.float32))
    dq, dk, dv = flash_attention_backward(q, k, v, dout, causal, window)
    for cuts in CUTS[s]:
        sk = torch.zeros_like(dk)
        sv = torch.zeros_like(dv)
        for r0, r1 in zip(cuts[:-1], cuts[1:]):
            gq, gk, gv = flash_attention_backward(
                q[:, :, r0:r1], k, v, dout[:, :, r0:r1], causal, window, r0)
            torch.testing.assert_close(gq, dq[:, :, r0:r1], rtol=1e-5,
                                       atol=1e-6 * float(dq.abs().max()))
            sk += gk
            sv += gv
        for got, want in ((sk, dk), (sv, dv)):
            torch.testing.assert_close(got, want, rtol=1e-5,
                                       atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("s,window,causal", [(128, 0, True), (128, 40, True),
                                             (96, 0, False), (96, 17, False),
                                             (2_048, 0, True)])
def test_k6_stripe_pairs_sum_to_the_whole(s, window, causal):
    """A stripe's kept pairs are its mask's, and the stripes' sum the
    whole's exactly; the operator's FLOP formula counts a stripe of any
    ``row_base`` as the busiest (the last when causal, the first
    bidirectional with a window)."""
    n = 16 if s == 2_048 else 4
    cuts = [s * i // n for i in range(n + 1)]
    pairs = [attention_pairs(s, window, causal, r0, r1 - r0)
             for r0, r1 in zip(cuts[:-1], cuts[1:])]
    if s <= 128:
        assert pairs == [int(_mask(r1 - r0, s, causal, window, "cpu", r0)
                             .sum()) for r0, r1 in zip(cuts[:-1], cuts[1:])]
    assert sum(pairs) == attention_pairs(s, window, causal)
    assert max(pairs) == (pairs[-1] if causal else pairs[0])
    q = torch.empty((1, 1, s // n, 64), device="meta")
    kv = torch.empty((1, 1, s, 64), device="meta")
    for r0 in cuts[:-1]:
        with FlopCounterMode(display=False) as mode:
            flash_attention_fwd(q, kv, kv, causal, window, r0)
        assert mode.get_total_flops() == 4 * 64 * max(pairs)


def test_k6_stripe_is_counted_as_the_busiest_stripe():
    """The operator's FLOP formula counts a stripe as the last stripe of its
    width, whatever its ``row_base``: on one tensor, and per device of a
    fake 1 x 4 group, where rank 0 runs the first stripe."""
    b, hq, hkv, s, d = 1, 3, 1, 256, 64
    q = torch.empty((b, hq, s, d), device="meta")
    kv = torch.empty((b, hkv, s, d), device="meta")
    last = attention_work(b, hq, hkv, s, d, 0, 0, True, row_base=3 * s // 4,
                          sq=s // 4)[0]
    first = attention_work(b, hq, hkv, s, d, 0, 0, True, row_base=0,
                           sq=s // 4)[0]
    assert last > 6 * first
    with FlopCounterMode(display=False) as mode:
        flash_attention_fwd(q[:, :, :s // 4], kv, kv, True, 0, 0)
    assert mode.get_total_flops() == last
    with fake_process_group(4):
        mesh = device_mesh((1, 4), ("data", "model"), "cuda")
        q_d, kv_d = (distribute_tensor(t, mesh, [Replicate(), Replicate()],
                                       src_data_rank=None) for t in (q, kv))
        work = dryrun.count_sharded(
            lambda q, k, v: flash_attention_striped(q, k, v, True, 0, 1),
            q_d, kv_d, kv_d)
    assert work.flops == last


def test_gather_seq_and_the_residual_constraint_placements():
    """On a fake 2 x 2 group: ``gather_seq`` all-gathers the sequence
    (batch kept) and sends its gradient back to the sequence shards; under
    ``seq_shard`` a row-parallel ``Partial`` reaching ``"btd"`` is
    reduce-scattered to the sequence shards and its gradient all-gathered
    (replicated over model, as the product's backward takes it)."""
    with fake_process_group(4):
        mesh = device_mesh((2, 2), ("data", "model"), "cuda")
        ctx = ShardCtx(mesh=mesh, seq_shard=True)
        full = torch.empty((4, 8, 6), device="meta")

        def dt(pl, grad=True):
            return DTensor.from_local(
                torch.empty((2, 8, 6) if pl[1] != Shard(1) else (2, 4, 6),
                            device="meta"), mesh, pl, run_check=False,
                shape=full.shape, stride=full.stride()).requires_grad_(grad)

        x = dt([Shard(0), Shard(1)])
        y = gather_seq(x)
        assert tuple(y.placements) == (Shard(0), Replicate())
        y.backward(dt([Shard(0), Partial()], grad=False))
        assert tuple(x.grad.placements) == (Shard(0), Shard(1))
        assert gather_seq(y) is y
        p = dt([Shard(0), Partial()])
        with use_ctx(ctx):
            z = shard_act(p, "btd")
        assert tuple(z.placements) == (Shard(0), Shard(1))
        z.backward(dt([Shard(0), Shard(1)], grad=False))
        assert tuple(p.grad.placements) == (Shard(0), Replicate())
        with use_ctx(dataclasses.replace(ctx, attn_seq_shard=True)):
            assert attn_stripe_dim(3, 1) == 1
            # 4 query heads divide the axis, 1 kv head does not: K6's
            # query heads, the reference's layout, not the stripes
            assert attn_stripe_dim(4, 1) is None
            assert attn_heads_dim(4, 1) == 1
            assert attn_stripe_dim(4, 2) is None
        with use_ctx(ctx):
            assert attn_stripe_dim(3, 1) is None


class _Products(dryrun.DeviceWork):
    """A device's count that also records every local product's operands'
    shapes."""

    def __init__(self):
        super().__init__()
        self.mm = []

    def add(self, func, args, kwargs, out):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.mm.append(tuple(args[-2].shape))
        super().add(func, args, kwargs, out)


@pytest.mark.parametrize("attn", [False, True])
def test_sequence_sharded_products_take_whole_sequences(attn, monkeypatch):
    """smollm-360m's SMOKE forward under ``seq_shard`` on a fake 2 x 2
    group: every local product's first operand has B / 2 x S rows (the
    sequence gathered before it, never a (batch, sequence) pair sharded on
    both), and the residual's constraints are reduce-scatters."""
    cfg = registry.get_smoke_config("smollm-360m")
    b, s = 4, 16
    with fake_process_group(4):
        mesh = device_mesh((2, 2), ("data", "model"), "cuda")
        ctx = ShardCtx(mesh=mesh, seq_shard=True, attn_seq_shard=attn)
        params = shard_params(init_lm(cfg, 0, device="meta"), ctx)
        tokens = distribute_tensor(
            torch.empty((b, s), dtype=torch.int64, device="meta"), mesh,
            placements(("data", None), mesh), src_data_rank=None)
        work = _Products()
        monkeypatch.setattr(dryrun, "DeviceWork", lambda: work)

        def fwd(p, t):
            from repro_torch.models.transformer import lm_forward
            with use_ctx(ctx):
                return lm_forward(p, t, cfg)

        dryrun.count_sharded(fwd, params, tokens)
    assert work.mm and all(rows == b // 2 * s for rows, _ in work.mm), \
        work.mm
    kinds = [k for k, _ in work.collectives]
    assert kinds.count("reduce-scatter") >= 2 * cfg.n_layers + 1, kinds


# the dry run's prefill_32k cells of every family at SMOKE width, 32 tokens
SEQ_CELLS = ("smollm-360m", "deepseek-moe-16b", "mamba2-130m",
             "zamba2-1.2b", "internvl2-1b", "whisper-medium")


def _seq_ctx_for(mesh, cfg, shape):
    """The dry run's context with ``seq_shard`` as at S >= 32,768 (the
    cells here are cut to 32 tokens)."""
    return dataclasses.replace(_ctx_for(mesh, cfg, shape), seq_shard=True)


_ctx_for = dryrun._ctx_for


@pytest.mark.parametrize("arch", SEQ_CELLS)
def test_seq_sharded_prefill_cell_counts_the_same_on_cpu_and_meta(
        arch, monkeypatch):
    """The dry run's ``prefill_32k`` cell (cut to 32 tokens, batch 4) on a
    fake 2 x 2 group with ``seq_shard`` on, as the dry run now runs it:
    the per-device count of CPU shards equals that of meta shards, with
    collectives among which the residual's reduce-scatters."""
    monkeypatch.setitem(dryrun.SHAPES, "prefill_32k",
                        shapes.ShapeSpec("prefill_32k", 32, 2, "prefill"))
    monkeypatch.setattr(dryrun, "_ctx_for", _seq_ctx_for)
    cfg = registry.get_smoke_config(arch)
    counts = []
    with fake_process_group(4):
        mesh = device_mesh((2, 2), ("data", "model"), "cpu")
        for device in ("cpu", "meta"):
            fn, args, arg_bytes, _, _, _, _, ctx = dryrun.build_sharded_cell(
                arch, "prefill_32k", False, cfg_override=cfg,
                batch_override=4, device=device, mesh=mesh)
            assert ctx.seq_shard
            work = dryrun.count_sharded(fn, *args)
            counts.append((work.flops, work.bytes, work.collectives,
                           arg_bytes))
    assert counts[0] == counts[1]
    assert counts[0][0] > 0 and counts[0][1] > 0
    assert "reduce-scatter" in [k for k, _ in counts[0][2]]


def test_attn_seq_shard_train_cell_counts_the_same_on_cpu_and_meta(
        monkeypatch):
    """smollm-360m's ``train_4k`` cell (cut to 32 tokens, batch 4) with
    ``attn_seq_shard`` (``perf_iter``'s variant): K6 runs as query stripes,
    counted alike on CPU and meta shards, each stripe as the busiest; its
    K6 FLOPs per device below the unstriped cell's."""
    monkeypatch.setitem(dryrun.SHAPES, "train_4k",
                        shapes.ShapeSpec("train_4k", 32, 2, "train"))
    cfg = dataclasses.replace(registry.get_smoke_config("smollm-360m"),
                              remat=True)
    counts = {}
    with fake_process_group(4):
        mesh = device_mesh((2, 2), ("data", "model"), "cpu")
        for variant in ({}, {"attn_seq_shard": True}):
            monkeypatch.setattr(dryrun, "CTX_KW", variant)
            for device in ("cpu", "meta"):
                fn, args, *_ = dryrun.build_sharded_cell(
                    "smollm-360m", "train_4k", False, cfg_override=cfg,
                    batch_override=4, device=device, mesh=mesh)
                work = dryrun.count_sharded(fn, *args)
                counts[bool(variant), device] = (work.flops, work.bytes,
                                                 work.collectives,
                                                 work.k6_flops)
    assert counts[True, "cpu"] == counts[True, "meta"]
    assert counts[False, "cpu"] == counts[False, "meta"]
    # smollm's 3 / 1 heads over a model axis of 2: replicated K6 against
    # the last of two stripes, 2 forwards a layer (remat), 2 layers
    whole = attention_work(2, 3, 1, 32, 20, 0, 0)[0]
    stripe = attention_work(2, 3, 1, 32, 20, 0, 0, row_base=16, sq=16)[0]
    assert counts[False, "meta"][3] == 4 * whole
    assert counts[True, "meta"][3] == 4 * stripe < 4 * whole



@pytest.mark.parametrize("unset", [False, True])
def test_remat_recompute_keeps_the_sharding_context(unset):
    """A gradient through ``cfg.remat``'s checkpoints recomputes each layer
    under the forward's ``ShardCtx``, also where the backward runs without
    it (the autograd engine runs a CUDA backward in a thread of its own,
    where the caller's thread-local context is unset; DTensor's implicit
    replication is one switch for the process): K6's recompute takes the
    query stripes again, so its FLOPs are the forward's twice over; and a
    recompute's nested context leaves the enclosing one's replication on
    for the rest of the backward."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models.transformer import leaves
    from repro_torch.training.optimizer import tree_map
    from repro_torch.training.train_step import lm_loss

    cfg = dataclasses.replace(registry.get_smoke_config("smollm-360m"),
                              remat=True, dtype="float32")
    with fake_process_group(4):
        mesh = device_mesh((2, 2), ("data", "model"), "cuda")
        ctx = ShardCtx(mesh=mesh, attn_seq_shard=True)
        params = shard_params(init_lm(cfg, 0, device="meta"), ctx)
        tokens = distribute_tensor(
            torch.empty((B, S + 1), dtype=torch.int64, device="meta"), mesh,
            placements(("data", None), mesh), src_data_rank=None)

        def step(params, tokens):
            leafs = tree_map(lambda p: p.detach().requires_grad_(True),
                             params)
            with use_ctx(ctx):
                loss = lm_loss(leafs, {"tokens": tokens}, cfg)[0]
                if not unset:
                    torch.autograd.grad(loss, list(leaves(leafs)),
                                        allow_unused=True)
            if unset:
                with implicit_replication():
                    torch.autograd.grad(loss, list(leaves(leafs)),
                                        allow_unused=True)

        work = dryrun.count_sharded(step, params, tokens)
    # B / 2 rows a rank, the last of two stripes of S, D = 20, 2 layers,
    # each forward twice (the forward and its recompute)
    stripe = attention_work(B // 2, 3, 1, S, 20, 0, 0, row_base=S // 2,
                            sq=S // 2)[0]
    assert work.k6_flops == 2 * cfg.n_layers * stripe


def test_decode_step_raises_under_seq_shard():
    """One token has no sequence to shard: ``decode_step`` raises under a
    context with ``seq_shard`` on, as the dry run never decodes so."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        from repro_torch.serving.decode import decode_step, init_state

    cfg = registry.get_smoke_config("smollm-360m")
    params = init_lm(cfg, 0, device="meta")
    state = init_state(cfg, 2, 8, device="meta")
    token = torch.zeros((2, 1), dtype=torch.int64, device="meta")
    with fake_process_group(4):
        ctx = ShardCtx(mesh=device_mesh((2, 2), ("data", "model"), "cuda"),
                       seq_shard=True)
        with use_ctx(ctx), pytest.raises(ValueError, match="seq_shard"):
            decode_step(params, token, state, cfg)
