"""The port's LM as an SPMD program (DTensors over a ``DeviceMesh``) against
the unsharded port and the reference's GSPMD program, on the CPU.

- A 2 x 2 ("data", "model") gloo mesh (``tests/_spmd_worker.py``, four
  spawned ranks, one subprocess a group of cases) runs each case's float32
  train step (AdamW), prefill and 4 decode steps with its parameters as
  DTensors and its inputs sharded by batch: the four dense ``SMOKE``
  configurations; the MoE ones (deepseek-moe-16b, experts over ``model``;
  mixtral-8x7b, experts replicated and their FFN width over ``model``; and
  deepseek at capacity factor 1, where assignments are dropped); the SSM
  and hybrid ones (mamba2-130m, zamba2-1.2b, and mamba2 at 3 SSM heads,
  which a model axis of 2 does not divide).  Each is equal to the same
  calls on plain tensors within ``rtol=1e-5`` and ``1e-6`` of the tensor's
  largest magnitude (at least 1; the first moment, ~1e-3, within ``1e-5``
  of its own): a sum split over shards adds in another order.  An MoE
  model's dispatch table is the unsharded one, entry for entry.
  The optimizer's ``eps`` is ``1e-4`` there, so that its ``g / (|g| +
  eps)`` does not turn a gradient's reassociation noise (near ``|g|`` =
  1e-8) into an update difference of up to ``lr``.
- The reference's step, prefill and decode, jitted over a 2 x 2 mesh of
  ``Auto`` axes on 4 forced host devices (one subprocess; ``jax.make_mesh``'s
  default ``Explicit`` axes break its ``shard_act``, ROADMAP Queue 3), on
  the same weights and tokens: the port's sharded results within ``2e-3``,
  the LM tolerance of ``test_torch_lm.py`` (moments relative to their
  tensor's largest magnitude; each parameter's update, new - initial,
  relative to its own, since one step moves it by about ``lr``, under
  that tolerance).  Its HLO ``collective_bytes`` of the train
  step is printed beside the port's count of the same step on meta
  tensors, which may not rise above its count before it was held to the
  reference's (``WAS_COLLECTIVES``; ``test_torch_spmd_bytes.py`` holds
  it to the reference's).
- Units on a fake process group (one process): ``collective_bytes`` of a
  1-layer forward on a 1 x 2 mesh against the three all-reduces derived by
  hand; K6's sharding rule (heads when both head counts divide the axis,
  else replicated); the per-device count of a sharded ``mm`` (its shard's
  work, where ``FlopCounterMode`` above DTensor reads the global work);
  ``placements`` of ``param_shardings``' specs; ``shard_act`` the identity
  on plain tensors; K6's per-device FLOPs with heads that the model axis
  does not divide (the global count / dp); the dry run's own sharded
  cells (``build_sharded_cell``) counted alike on CPU and meta shards;
  K6's module imported without the sharding or launch modules.

Each subprocess has its own time limit (120 s); the groups run side by
side.
"""
import dataclasses
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import registry, shapes
from repro_torch.distributed.sharding import (ShardCtx, param_shardings,
                                              placements, shard_act,
                                              shard_params, use_ctx)
from repro_torch.kernels.flash_attention.ops import flash_attention_fwd
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (axis_sizes, device_mesh,
                                     fake_process_group, make_local_mesh)
from repro_torch.launch.roofline import collective_bytes
from repro_torch.models.transformer import init_lm, lm_forward
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import init_train_state, make_train_step

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
DENSE = ("smollm-360m", "gemma3-1b", "internlm2-1.8b", "glm4-9b")
# the moe, ssm and hybrid families, each case an architecture's SMOKE
# configuration or a variant of one ("arch@name", its changed fields below)
MOE = ("deepseek-moe-16b", "deepseek-moe-16b@drop", "mixtral-8x7b")
SSM = ("mamba2-130m", "mamba2-130m@3heads", "zamba2-1.2b")
OVERRIDES = {
    # capacity 17 of the 64 x 2 assignments of a prefill (8 experts):
    # assignments are dropped, in the same places in every layout
    "deepseek-moe-16b@drop": {"capacity_factor": 1.0},
    # 3 SSM heads over a model axis of 2: the SSD gathers the heads first,
    # as mamba2-130m's 24 heads over 16 do
    "mamba2-130m@3heads": {"d_model": 24},
}
GROUPS = (DENSE, MOE, SSM)
CASES = DENSE + MOE + SSM
B, S, N_DECODE = 4, 16, 4
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-4)
TOL, REF_TOL = 1e-5, 2e-3
TIMEOUT = 120
# the port's collective bytes of each case's B 4 x S 16 train step before
# they were held to the reference's (tests/test_torch_spmd_bytes.py): no
# case may rise above them
WAS_COLLECTIVES = {
    "smollm-360m": 709_648, "gemma3-1b": 1_061_776, "internlm2-1.8b": 723_856,
    "glm4-9b": 723_856, "deepseek-moe-16b": 1_199_000,
    "deepseek-moe-16b@drop": 1_051_544, "mixtral-8x7b": 1_700_760,
    "mamba2-130m": 900_208, "mamba2-130m@3heads": 282_744,
    "zamba2-1.2b": 1_947_984}


def _env():
    return {"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2",
            "JAX_PLATFORMS": "cpu"}


def _run(cmd, what):
    return _run_all([(cmd, what)])[0]


def _run_all(jobs):
    """The commands of ``jobs`` (``(cmd, what)`` pairs) run side by side,
    each within ``TIMEOUT``; their standard outputs, in order."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=_env())
             for cmd, _ in jobs]
    outs = []
    try:
        for proc, (_, what) in zip(procs, jobs):
            stdout, stderr = proc.communicate(timeout=TIMEOUT)
            assert proc.returncode == 0, f"{what}:\n" + stderr[-4000:]
            outs.append(stdout)
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()
    return outs


def _reference_code(out, cases) -> str:
    """The reference's run of ``cases`` on 4 forced host devices."""
    overrides = {c: OVERRIDES.get(c, {}) for c in cases}
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
        from repro.serving.decode import decode_step, prefill
        from repro.training.optimizer import AdamWConfig
        from repro.training.train_step import (init_train_state,
                                               make_train_step)

        mesh = jax.make_mesh((2, 2), ("data", "model"),
                             axis_types=(AxisType.Auto, AxisType.Auto))
        ctx = ShardCtx(mesh=mesh)
        opt = AdamWConfig(**{OPT!r})
        flat = lambda tree, pre: {{
            pre + "/".join(k.key for k in path): np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}}
        coll = {{}}
        for case, over in {overrides!r}.items():
            cfg = dataclasses.replace(get_smoke_config(case.split("@")[0]),
                                      dtype="float32", **over)
            params = init_lm(cfg, jax.random.PRNGKey(0))
            r = np.random.RandomState(0)
            tokens = r.randint(0, cfg.vocab_size, ({B}, {S} + 1))
            decode = r.randint(0, cfg.vocab_size, ({B}, {N_DECODE}))
            np.savez(f"{out}/{{case}}_inputs.npz", **flat(params, "p/"),
                     tokens=tokens.astype(np.int32),
                     decode=decode.astype(np.int32),
                     overrides=np.array(json.dumps(over)))
            params = jax.device_put(params, param_shardings(
                params, ctx, expert_parallel=cfg.expert_parallel))
            rows = NamedSharding(mesh, P("data", None))
            tokens = jax.device_put(jnp.asarray(tokens, jnp.int32), rows)
            decode = jax.device_put(jnp.asarray(decode, jnp.int32), rows)
            step = make_train_step(cfg, opt)

            def train(s, b):
                with use_ctx(ctx):
                    return step(s, b)

            def pre(p, t):
                with use_ctx(ctx):
                    return prefill(p, t, cfg)

            def dec(p, t, s):
                with use_ctx(ctx):
                    return decode_step(p, t, s, cfg)

            res = {{}}
            with mesh:
                state = init_train_state(params, opt)
                compiled = jax.jit(train).lower(
                    state, {{"tokens": tokens}}).compile()
                coll[case] = collective_bytes(compiled.as_text())
                new, metrics = compiled(state, {{"tokens": tokens}})
                res["loss"] = np.asarray(metrics["loss"])
                res["grad_norm"] = np.asarray(metrics["grad_norm"])
                res.update(flat(new.params, "param/"))
                res.update(flat(new.opt.mu, "mu/"))
                logits, dstate = jax.jit(pre)(params, tokens[:, :-1])
                res["prefill"] = np.asarray(logits)
                dec = jax.jit(dec)      # traced once for the N steps
                for i in range({N_DECODE}):
                    logits, dstate = dec(params, decode[:, i:i + 1], dstate)
                    res[f"decode/{{i}}"] = np.asarray(logits)
            np.savez(f"{out}/{{case}}_ref.npz", **res)
        print(json.dumps(coll))
    """)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's weights and tokens (``{case}_inputs.npz``), its
    sharded results (``{case}_ref.npz``) and its train steps' HLO
    collective bytes: one 4-device subprocess a group of cases, the groups
    side by side."""
    out = tmp_path_factory.mktemp("spmd")
    coll = {}
    for stdout in _run_all([
            ([sys.executable, "-c", _reference_code(out, cases)],
             f"the reference's run of {cases}") for cases in GROUPS]):
        coll.update(json.loads(stdout.strip().splitlines()[-1]))
    return out, coll


@pytest.fixture(scope="module")
def port(reference):
    """The port's sharded and plain results: one 4-rank gloo run a group,
    the groups side by side."""
    out, _ = reference
    _run_all([([sys.executable, str(ROOT / "tests" / "_spmd_worker.py"),
                str(out), *cases], f"the port's 2 x 2 gloo run of {cases}")
              for cases in GROUPS])
    return {case: dict(np.load(out / f"{case}_out.npz")) for case in CASES}


def _close(name, got, want, rtol, atol_frac):
    """Within ``rtol`` and ``atol_frac`` of the tensor's largest magnitude,
    at least 1; a first moment (0.1 x the clipped gradient, ~1e-3) within
    ``rtol`` of its own largest magnitude."""
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    atol = rtol * scale if name.startswith("mu/") else \
        atol_frac * max(1.0, scale)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)


def _names(res, prefix, skip=()):
    return sorted(k[len(prefix):] for k in res if k.startswith(prefix)
                  and not k.startswith("spmd/placements/")
                  and k[len(prefix):] not in skip)


def _placements(res) -> dict:
    return {k[len("spmd/placements/"):]: str(v) for k, v in res.items()
            if k.startswith("spmd/placements/")}


@pytest.mark.parametrize("arch", CASES)
def test_sharded_step_prefill_decode_equal_the_unsharded_port(arch, port):
    res = port[arch]
    names = _names(res, "plain/")
    assert names == _names(res, "spmd/") and len(names) > 10
    for name in names:
        _close(name, res[f"spmd/{name}"], res[f"plain/{name}"], TOL, 1e-6)
    # the reference's cache specs over (L, B, ...): the batch over data;
    # a KV cache (L, B, W, Hkv, D) its kv heads over model when they divide
    # it ("cache"), else the slots ("cache_seq"); an SSM state (L, B, H, P,
    # N) P over model (it divides), a conv cache (L, B, K - 1, C) the
    # channels (K - 1 = 3 does not divide)
    cfg = registry.get_smoke_config(arch.split("@")[0])
    batch_and = "(Shard(dim=1), Shard(dim={}))".format
    kv = batch_and(3 if cfg.n_kv_heads % 2 == 0 else 2)
    want = {"kv/k": kv, "kv/v": kv} if cfg.family in ("dense", "moe") \
        else {"ssm/conv": batch_and(3), "ssm/state": batch_and(3)}
    if cfg.family == "hybrid":
        want.update({"shared_kv/k": kv, "shared_kv/v": kv})
    assert _placements(res) == want


@pytest.mark.parametrize("arch", CASES)
def test_sharded_step_prefill_decode_equal_the_reference(arch, reference,
                                                         port):
    out, _ = reference
    ref = dict(np.load(out / f"{arch}_ref.npz"))
    init = dict(np.load(out / f"{arch}_inputs.npz"))
    res = port[arch]
    assert sorted(ref) == _names(res, "spmd/", skip=("table",))
    for name, want in ref.items():
        _close(name, res[f"spmd/{name}"], want, REF_TOL, REF_TOL)
    # one AdamW step moves a parameter by about lr = 1e-3, below the
    # tolerance above: the update itself, new - initial, within REF_TOL of
    # its own largest magnitude
    for name in (n for n in ref if n.startswith("param/")):
        w0 = init["p/" + name[len("param/"):]]
        want = ref[name] - w0
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(
            res[f"spmd/{name}"] - w0, want, rtol=REF_TOL,
            atol=REF_TOL * float(np.abs(want).max()), err_msg=name)


@pytest.mark.parametrize("case", MOE)
def test_moe_dispatch_table_is_the_global_one(case, port):
    """The sharded layer routes all B S tokens together: its dispatch table
    (capacity counted over all of them, assignments ordered by one stable
    sort) equals the unsharded one entry for entry; with capacity factor 1
    assignments are dropped, the same ones."""
    res = port[case]
    got, want = res["spmd/table"], res["plain/table"]
    np.testing.assert_array_equal(got, want)
    t_k = B * S * registry.get_smoke_config(case.split("@")[0]) \
        .experts_per_token
    kept = int((want < t_k).sum())
    assert (kept < t_k) == (case == "deepseek-moe-16b@drop"), kept


def test_collective_bytes_printed_beside_the_reference(reference):
    """The port's collectives of each SMOKE train step on the same 2 x 2
    mesh (counted on meta under a fake group), printed beside the
    reference's HLO count; both must have reduced activations, and the
    port's total is no higher than ``WAS_COLLECTIVES``."""
    _, ref = reference
    with fake_process_group(4):
        mesh = device_mesh((2, 2), ("data", "model"), "cuda")
        for arch in CASES:
            cfg = dataclasses.replace(
                registry.get_smoke_config(arch.split("@")[0]),
                dtype="float32", **OVERRIDES.get(arch, {}))
            ctx = ShardCtx(mesh=mesh)
            params = shard_params(init_lm(cfg, 0, device="meta"), ctx,
                                  expert_parallel=cfg.expert_parallel)
            opt = AdamWConfig(**OPT)
            state = init_train_state(params, opt)
            tokens = distribute_tensor(
                torch.empty((B, S + 1), dtype=torch.int64, device="meta"),
                mesh, placements(("data", None), mesh), src_data_rank=None)
            step = make_train_step(cfg, opt)

            def fn(state, tokens):
                with use_ctx(ctx):
                    return step(state, {"tokens": tokens})

            got = collective_bytes(dryrun.count_sharded(
                fn, state, tokens).collectives)
            print(f"{arch}: port {got}; reference HLO {ref[arch]}")
            assert got["all-reduce"] > 0 and ref[arch]["all-reduce"] > 0
            assert got["total"] <= WAS_COLLECTIVES[arch], arch
            assert got["total"] == sum(got[k] for k in (
                "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute"))


# ----------------------------------------------------------------- units

def test_collective_bytes_of_a_one_layer_forward_by_hand():
    """smollm's SMOKE widths at 1 layer, 4 heads of 16 over (data 1, model
    2), forward only: the embedding's masked partial sum, the attention's
    and the MLP's row-parallel products are each one all-reduce of the
    (B, S, D) float32 residual; the logits stay vocabulary-sharded, and a
    data axis of 1 gathers nothing."""
    cfg = dataclasses.replace(registry.get_smoke_config("smollm-360m"),
                              n_layers=1, d_model=64, n_heads=4,
                              n_kv_heads=2, dtype="float32")
    with fake_process_group(2):
        mesh = device_mesh((1, 2), ("data", "model"), "cuda")
        ctx = ShardCtx(mesh=mesh)
        params = shard_params(init_lm(cfg, 0, device="meta"), ctx)
        tokens = distribute_tensor(
            torch.empty((B, S), dtype=torch.int64, device="meta"), mesh,
            placements(("data", None), mesh), src_data_rank=None)

        def fn(params, tokens):
            with use_ctx(ctx):
                return lm_forward(params, tokens, cfg)

        got = collective_bytes(dryrun.count_sharded(
            fn, params, tokens).collectives)
    residual = B * S * cfg.d_model * 4
    assert got == {"all-gather": 0, "all-reduce": 3 * residual,
                   "reduce-scatter": 0, "all-to-all": 0,
                   "collective-permute": 0, "count": 3,
                   "total": 3 * residual}


def test_collective_bytes_sums_records_by_kind():
    got = collective_bytes([("all-gather", 8), ("all-reduce", 16),
                            ("all-gather", 4), ("reduce-scatter", 2)])
    assert got == {"all-gather": 12, "all-reduce": 16, "reduce-scatter": 2,
                   "all-to-all": 0, "collective-permute": 0, "count": 4,
                   "total": 30}
    with pytest.raises(ValueError):
        collective_bytes([("broadcast", 1)])


@pytest.mark.parametrize("hkv,want", [(2, Shard(1)), (1, Replicate())])
def test_k6_sharding_rule_shards_heads_only_when_both_counts_divide(hkv,
                                                                    want):
    """q sharded by heads over a 2-rank axis (one batch row, so the batch
    cannot be): with 4 query and 2 kv heads K6 runs on each rank's heads;
    with 1 kv head the heads rule is not offered and the operands are
    replicated.  A batch of 2 is sharded by batch, whatever the heads."""
    with fake_process_group(2):
        mesh = device_mesh((2,), ("model",), "cuda")
        q = torch.empty((1, 4, 64, 64), device="meta")
        kv = torch.empty((1, hkv, 64, 64), device="meta")
        heads = [Shard(1)] if hkv % 2 == 0 else [Replicate()]
        dq = distribute_tensor(q, mesh, [Shard(1)], src_data_rank=None)
        dk = distribute_tensor(kv, mesh, heads, src_data_rank=None)
        dv = distribute_tensor(kv, mesh, heads, src_data_rank=None)
        out = flash_attention_fwd(dq, dk, dv, True, 0)
        assert isinstance(out, DTensor) and tuple(out.placements) == (want,)
        assert out.shape == q.shape
        q2 = torch.empty((2, 4, 64, 64), device="meta")
        kv2 = torch.empty((2, hkv, 64, 64), device="meta")
        bq = distribute_tensor(q2, mesh, [Shard(0)], src_data_rank=None)
        bk = distribute_tensor(kv2, mesh, [Shard(0)], src_data_rank=None)
        out = flash_attention_fwd(bq, bk, bk, True, 0)
        assert tuple(out.placements) == (Shard(0),)


def test_k6_per_device_flops_are_the_global_count_over_data():
    """smollm's case at test size: 3 query heads and 1 kv head, which a
    model axis of 2 does not divide, so K6's rule replicates them over
    ``model`` and shards only the batch over ``data``: one device counts
    the global FLOPs / dp (2), not / 4, and its output keeps the batch
    shard."""
    q = torch.empty((4, 3, 64, 64), device="meta")
    kv = torch.empty((4, 1, 64, 64), device="meta")
    global_flops, _ = dryrun.count_work(flash_attention_fwd, q, kv, kv,
                                        True, 0)
    with fake_process_group(4):
        mesh = device_mesh((2, 2), ("data", "model"), "cuda")
        dq, dk, dv = (distribute_tensor(t, mesh, [Shard(0), Replicate()],
                                        src_data_rank=None)
                      for t in (q, kv, kv))
        work = dryrun.count_sharded(
            lambda q, k, v: flash_attention_fwd(q, k, v, True, 0),
            dq, dk, dv)
        out = flash_attention_fwd(dq, dk, dv, True, 0)
    assert global_flops > 0 and work.flops == global_flops // 2
    assert tuple(out.placements) == (Shard(0), Replicate())
    assert work.collectives == []


@pytest.mark.parametrize("kind,name", [("train", "train_4k"),
                                       ("prefill", "prefill_32k"),
                                       ("decode", "decode_32k")])
def test_sharded_cell_counts_the_same_on_cpu_and_meta(kind, name,
                                                      monkeypatch):
    """The dry run's sharded cell (``build_sharded_cell``: its parameter,
    batch and decode-cache placements, the cache write through
    ``local_map``) at smollm's SMOKE width, batch 4, on a 2 x 2 mesh of a
    fake group: the per-device count of CPU shards equals that of meta
    shards, FLOPs, bytes, collective records and argument bytes."""
    monkeypatch.setitem(dryrun.SHAPES, name,
                        shapes.ShapeSpec(name, 24, 2, kind))
    cfg = dataclasses.replace(registry.get_smoke_config("smollm-360m"),
                              remat=kind == "train")
    counts = []
    with fake_process_group(4):
        mesh = device_mesh((2, 2), ("data", "model"), "cpu")
        for device in ("cpu", "meta"):
            fn, args, arg_bytes, *_ = dryrun.build_sharded_cell(
                "smollm-360m", name, False, cfg_override=cfg,
                batch_override=4, device=device, mesh=mesh)
            work = dryrun.count_sharded(fn, *args)
            counts.append((work.flops, work.bytes, work.collectives,
                           arg_bytes))
    assert counts[0] == counts[1]
    assert counts[0][0] > 0 and counts[0][1] > 0 and counts[0][2]


@pytest.mark.parametrize("arch", ("deepseek-moe-16b", "mamba2-130m",
                                  "zamba2-1.2b"))
@pytest.mark.parametrize("kind,name", [("train", "train_4k"),
                                       ("prefill", "prefill_32k"),
                                       ("decode", "decode_32k")])
def test_family_sharded_cell_counts_the_same_on_cpu_and_meta(arch, kind, name,
                                                             monkeypatch):
    """As above for one SMOKE architecture of each family added to
    ``SHARDED_FAMILIES`` after the dense one (moe, ssm, hybrid), at 32
    tokens (an SSD chunk of 16): its experts' dispatch, its SSD and conv
    and its SSM caches (every decode-state leaf laid out by
    ``decode_state_spec``) counted alike on CPU and meta shards, with
    collectives."""
    monkeypatch.setitem(dryrun.SHAPES, name,
                        shapes.ShapeSpec(name, 32, 2, kind))
    cfg = dataclasses.replace(registry.get_smoke_config(arch),
                              remat=kind == "train", ssm_chunk=16)
    assert cfg.family in dryrun.SHARDED_FAMILIES
    counts = []
    with fake_process_group(4):
        mesh = device_mesh((2, 2), ("data", "model"), "cpu")
        for device in ("cpu", "meta"):
            fn, args, arg_bytes, *_ = dryrun.build_sharded_cell(
                arch, name, False, cfg_override=cfg, batch_override=4,
                device=device, mesh=mesh)
            if kind == "decode":
                state = args[2]
                leaves = [t for c in (state.kv, state.ssm, state.shared_kv)
                          if c is not None for t in vars(c).values()
                          if isinstance(t, torch.Tensor) and t.dim() > 1]
                assert leaves and all(isinstance(t, DTensor)
                                      for t in leaves)
            work = dryrun.count_sharded(fn, *args)
            counts.append((work.flops, work.bytes, work.collectives,
                           arg_bytes))
    assert counts[0] == counts[1]
    assert counts[0][0] > 0 and counts[0][1] > 0 and counts[0][2]


@pytest.mark.parametrize("heads,want", [(4, Shard(2)), (3, Replicate())])
def test_ssd_shards_heads_only_when_they_divide(heads, want):
    """The SSD on DTensors over a 1 x 2 mesh: with ``a`` (H,) sharded over
    ``model`` (``a_log``'s layout when the heads divide the axis) the scan
    runs on each rank's heads; with 3 heads ``a`` is replicated, and so is
    the scan's output over ``model`` (the heads gathered first)."""
    from repro_torch.models.ssm import ssd_chunked

    with fake_process_group(2):
        mesh = device_mesh((1, 2), ("data", "model"), "cuda")
        rows = [Shard(0), Replicate()]

        def dist(shape, pl):
            return distribute_tensor(torch.empty(shape, device="meta"), mesh,
                                     pl, src_data_rank=None)

        a_pl = [Replicate(), Shard(0) if heads % 2 == 0 else Replicate()]
        y, final = ssd_chunked(dist((2, 16, heads, 8), rows),
                               dist((2, 16, heads), rows),
                               dist((heads,), a_pl), dist((2, 16, 1, 4), rows),
                               dist((2, 16, 1, 4), rows), chunk=8)
    assert tuple(y.placements) == (Shard(0), want)
    assert tuple(final.placements) == (
        Shard(0), Shard(1) if want == Shard(2) else Replicate())
    assert y.shape == (2, 16, heads, 8) and final.shape == (2, heads, 8, 4)


def test_the_kernel_imports_no_sharding_or_launch_module():
    """K6's operator and its DTensor rule load without the LM sharding
    module or the launch tooling."""
    code = ("import sys, repro_torch.kernels.flash_attention.ops; "
            "print(sorted(m for m in sys.modules if m.startswith("
            "('repro_torch.distributed', 'repro_torch.launch'))))")
    assert _run([sys.executable, "-c", code], "import").strip() == "[]"


def test_per_device_count_is_the_shard_s_work():
    """A (32, 32) x (32, 64) product with its rows over 4 ranks: rank 0's
    shard does 2 * 8 * 32 * 64 = 32,768 FLOPs; ``FlopCounterMode`` above
    DTensor reads the global 131,072."""
    with fake_process_group(4):
        mesh = device_mesh((4,), ("data",), "cuda")
        a = distribute_tensor(torch.empty((32, 32), device="meta"), mesh,
                              [Shard(0)], src_data_rank=None)
        b = distribute_tensor(torch.empty((32, 64), device="meta"), mesh,
                              [Replicate()], src_data_rank=None)
        work = dryrun.count_sharded(torch.mm, a, b)
        with FlopCounterMode(display=False) as above:
            torch.mm(a, b)
    assert work.flops == 32_768 and above.get_total_flops() == 131_072
    assert work.bytes == 4 * (8 * 32 + 32 * 64 + 8 * 64)
    assert work.collectives == []


def test_placements_of_param_specs():
    with fake_process_group(8):
        mesh = device_mesh((2, 2, 2), ("pod", "data", "model"), "cuda")
        assert axis_sizes(mesh) == {"pod": 2, "data": 2, "model": 2}
        assert placements((("pod", "data"), "model"), mesh) == (
            Shard(0), Shard(0), Shard(1))
        assert placements((None, None), mesh) == (Replicate(),) * 3
        ctx = ShardCtx(mesh=mesh, dp=("pod", "data"))
        params = {"layers": {"attn": {"w_q": torch.empty(
            (3, 8, 6), device="meta")}}, "embed": torch.empty(
            (10, 8), device="meta")}
        specs = param_shardings(params, ctx)
        sharded = shard_params(params, ctx)
        w_q = sharded["layers"]["attn"]["w_q"]
        assert specs["layers"]["attn"]["w_q"] == (None, ("pod", "data"),
                                                   "model")
        assert tuple(w_q.placements) == (Shard(1), Shard(1), Shard(2))
        assert w_q.to_local().shape == (3, 2, 3)
        # the embedding's vocabulary over model only
        assert tuple(sharded["embed"].placements) == (
            Replicate(), Replicate(), Shard(0))


def test_shard_act_is_the_identity_on_plain_tensors():
    x = torch.randn(2, 3, 4)
    with fake_process_group(4):
        mesh = device_mesh((2, 2), ("data", "model"), "cuda")
        ctx = ShardCtx(mesh=mesh)
        assert ctx.spmd and ctx.tp_size == 2
        with use_ctx(ctx):
            assert shard_act(x, "btd") is x
            with pytest.raises(KeyError):
                shard_act(x, "no such kind")
            d = distribute_tensor(torch.empty((4, 3, 8), device="meta"),
                                  mesh, [Replicate(), Replicate()],
                                  src_data_rank=None)
            assert tuple(shard_act(d, "btv").placements) == (Shard(0),
                                                              Shard(2))
    local = ShardCtx(mesh=make_local_mesh(data=2, model=2,
                                          devices=["cpu"] * 4))
    assert not local.spmd
    with use_ctx(local):
        assert shard_act(x, "btd") is x


def test_partial_sums_are_reduced_by_shard_act():
    """A ``Partial`` residual reduces to the ``"btd"`` spec: one all-reduce
    over the model axis on the shards' bytes."""
    with fake_process_group(4):
        mesh = device_mesh((2, 2), ("data", "model"), "cuda")
        ctx = ShardCtx(mesh=mesh)
        d = DTensor.from_local(torch.empty((2, 3, 8), device="meta"), mesh,
                               [Shard(0), Partial()], run_check=False)

        def fn(d):
            with use_ctx(ctx):
                return shard_act(d, "btd")

        work = dryrun.count_sharded(fn, d)
    assert work.collectives == [("all-reduce", 2 * 3 * 8 * 4)]

