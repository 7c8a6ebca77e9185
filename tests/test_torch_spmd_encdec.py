"""The port's vlm and audio LMs as SPMD programs (DTensors over a
``DeviceMesh``) against the unsharded port and the reference's GSPMD
program, on the CPU.

- A 2 x 2 ("data", "model") gloo mesh (``tests/_spmd_worker.py``, four
  spawned ranks, one subprocess) runs each case's float32 train step
  (AdamW), prefill and 4 decode steps with its parameters as DTensors and
  its inputs (tokens, internvl2-1b's patch embeddings, whisper-medium's
  frame embeddings) sharded by batch, at the ``SMOKE`` widths: equal to the
  same calls on plain tensors within ``rtol=1e-5`` and ``1e-6`` of the
  tensor's largest magnitude (at least 1; the first moment within ``1e-5``
  of its own), as ``test_torch_spmd.py`` holds the other families.
  whisper's two encoder layers over a data axis of 2 are sharded on their
  layer axis (the reference's rules, kept), so its encoder gathers that
  axis first.  The decode caches are laid out by the reference's rule:
  internvl2-1b's one kv head leaves the slots over ``model``; whisper's
  self-attention and cross-attention K/V their heads.
- The reference's step, prefill and decode, jitted over a 2 x 2 mesh of
  ``Auto`` axes on 4 forced host devices (one subprocess), on the same
  weights and inputs: the port's sharded results within ``2e-3``.
- Each case's train-step collectives, counted on meta under a fake group,
  printed beside the reference's HLO ``collective_bytes`` (compiled, then
  run), and no higher than ``WAS_COLLECTIVES``.
- whisper's ``param_shardings`` placements equal the reference's spec for
  spec (``enc_layers/attn/w_{q,k,v}`` layer-sharded over ``data``, ``w_o``
  over ``model``); each family's three dry-run cells count alike on CPU and
  meta shards of a fake group.

Each subprocess has its own time limit (120 s); the two run side by side.
"""
import dataclasses
import json
import sys
import textwrap

import numpy as np
import pytest
import torch
from test_torch_spmd import (B, N_DECODE, OPT, REF_TOL, ROOT, S, SRC, TOL,
                             _close, _names, _placements, _run_all)
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.configs import registry, shapes
from repro_torch.distributed.sharding import (ShardCtx, param_shardings,
                                              placements, shard_params,
                                              use_ctx)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import device_mesh, fake_process_group
from repro_torch.launch.roofline import collective_bytes
from repro_torch.models.transformer import init_lm
from repro_torch.models.whisper import init_encdec
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import init_train_state, make_train_step

CASES = ("internvl2-1b", "whisper-medium")
# the port's collective bytes of each case's train step before they were
# held to the reference's (tests/test_torch_spmd_bytes.py): none may rise
# above them
WAS_COLLECTIVES = {"internvl2-1b": 678_864, "whisper-medium": 1_612_176}


def _reference_code(out) -> str:
    """The reference's run of ``CASES`` on 4 forced host devices; prints
    each case's train-step HLO collective bytes and whisper's parameter
    specs."""
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
        ctx = ShardCtx(mesh=mesh)
        opt = AdamWConfig(**{OPT!r})
        paths = lambda tree: jax.tree_util.tree_flatten_with_path(tree)[0]
        flat = lambda tree, pre: {{
            pre + "/".join(k.key for k in path): np.asarray(v, np.float32)
            for path, v in paths(tree)}}
        specs, coll = {{}}, {{}}
        for case in {CASES!r}:
            cfg = dataclasses.replace(get_smoke_config(case),
                                      dtype="float32")
            audio = cfg.family == "audio"
            params = (init_encdec if audio else init_lm)(
                cfg, jax.random.PRNGKey(0))
            r = np.random.RandomState(0)
            tokens = r.randint(0, cfg.vocab_size, ({B}, {S} + 1))
            decode = r.randint(0, cfg.vocab_size, ({B}, {N_DECODE}))
            name, n = ("frames", cfg.encoder_frames) if audio else (
                "patches", cfg.n_patches)
            extra = r.randn({B}, n, cfg.d_model).astype(np.float32)
            np.savez(f"{out}/{{case}}_inputs.npz", **flat(params, "p/"),
                     tokens=tokens.astype(np.int32),
                     decode=decode.astype(np.int32), **{{name: extra}},
                     overrides=np.array("{{}}"))
            pspec = param_shardings(params, ctx)
            if audio:
                specs = {{"/".join(k.key for k in path): [
                    list(a) if isinstance(a, tuple) else a for a in s]
                    for path, s in ((p, n.spec) for p, n in paths(pspec))}}
            params = jax.device_put(params, pspec)
            rows = NamedSharding(mesh, P("data", None))
            tokens = jax.device_put(jnp.asarray(tokens, jnp.int32), rows)
            decode = jax.device_put(jnp.asarray(decode, jnp.int32), rows)
            extra = jax.device_put(jnp.asarray(extra), NamedSharding(
                mesh, P("data", None, None)))
            step = make_train_step(cfg, opt)

            def train(s, b):
                with use_ctx(ctx):
                    return step(s, b)

            def pre(p, t, e):
                with use_ctx(ctx):
                    return prefill(p, t, cfg, **{{name: e}})

            def dec(p, t, s):
                with use_ctx(ctx):
                    return decode_step(p, t, s, cfg)

            res = {{}}
            with mesh:
                state = init_train_state(params, opt)
                batch = {{"tokens": tokens, name: extra}}
                compiled = jax.jit(train).lower(state, batch).compile()
                coll[case] = collective_bytes(compiled.as_text())
                new, metrics = compiled(state, batch)
                res["loss"] = np.asarray(metrics["loss"])
                res["grad_norm"] = np.asarray(metrics["grad_norm"])
                res.update(flat(new.params, "param/"))
                res.update(flat(new.opt.mu, "mu/"))
                logits, dstate = jax.jit(pre)(params, tokens[:, :-1], extra)
                res["prefill"] = np.asarray(logits)
                dec = jax.jit(dec)      # traced once for the N steps
                for i in range({N_DECODE}):
                    logits, dstate = dec(params, decode[:, i:i + 1], dstate)
                    res[f"decode/{{i}}"] = np.asarray(logits)
            np.savez(f"{out}/{{case}}_ref.npz", **res)
        print(json.dumps({{"specs": specs, "coll": coll}}))
    """)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's weights and inputs, its sharded results, its train
    steps' HLO collective bytes and whisper's parameter specs; then the
    port's sharded and plain results (the worker reads the reference's
    inputs, so the two run in turn)."""
    out = tmp_path_factory.mktemp("spmd_encdec")
    ref_out, = _run_all([([sys.executable, "-c", _reference_code(out)],
                          "the reference's run of the vlm and audio LMs")])
    _run_all([([sys.executable, str(ROOT / "tests" / "_spmd_worker.py"),
                str(out), *CASES], "the port's 2 x 2 gloo run of the vlm "
               "and audio LMs")])
    printed = json.loads(ref_out.strip().splitlines()[-1])
    return dict(out=out, specs=printed["specs"], coll=printed["coll"],
                port={case: dict(np.load(out / f"{case}_out.npz"))
                      for case in CASES})


@pytest.mark.parametrize("arch", CASES)
def test_sharded_step_prefill_decode_equal_the_unsharded_port(arch, runs):
    res = runs["port"][arch]
    names = _names(res, "plain/")
    assert names == _names(res, "spmd/") and len(names) > 10
    for name in names:
        _close(name, res[f"spmd/{name}"], res[f"plain/{name}"], TOL, 1e-6)
    cfg = registry.get_smoke_config(arch)
    kv = "(Shard(dim=1), Shard(dim={}))".format(
        3 if cfg.n_kv_heads % 2 == 0 else 2)
    want = {"kv/k": kv, "kv/v": kv}
    if cfg.family == "audio":
        want.update({"cross_k": kv, "cross_v": kv})
    assert _placements(res) == want


@pytest.mark.parametrize("arch", CASES)
def test_sharded_step_prefill_decode_equal_the_reference(arch, runs):
    out = runs["out"]
    ref = dict(np.load(out / f"{arch}_ref.npz"))
    init = dict(np.load(out / f"{arch}_inputs.npz"))
    res = runs["port"][arch]
    assert sorted(ref) == _names(res, "spmd/")
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


@pytest.mark.parametrize("arch", CASES)
def test_collective_bytes_printed_beside_the_reference(arch, runs):
    """The port's collectives of the case's SMOKE train step (its patch or
    frame embeddings sharded by batch) on the same 2 x 2 mesh, counted on
    meta under a fake group, printed beside the reference's HLO count; both
    reduce activations, and the port's total is no higher than
    ``WAS_COLLECTIVES``."""
    cfg = dataclasses.replace(registry.get_smoke_config(arch),
                              dtype="float32")
    audio = cfg.family == "audio"
    with fake_process_group(4):
        mesh = device_mesh((2, 2), ("data", "model"), "cuda")
        ctx = ShardCtx(mesh=mesh)
        opt = AdamWConfig(**OPT)
        state = init_train_state(shard_params(
            (init_encdec if audio else init_lm)(cfg, 0, device="meta"), ctx),
            opt)
        name, n = ("frames", cfg.encoder_frames) if audio else (
            "patches", cfg.n_patches)

        def rows(shape, dtype=torch.float32):
            return distribute_tensor(
                torch.empty(shape, dtype=dtype, device="meta"), mesh,
                placements(("data",) + (None,) * (len(shape) - 1), mesh),
                src_data_rank=None)

        batch = {"tokens": rows((B, S + 1), torch.int64),
                 name: rows((B, n, cfg.d_model))}
        step = make_train_step(cfg, opt)

        def fn(state, batch):
            with use_ctx(ctx):
                return step(state, batch)

        got = collective_bytes(dryrun.count_sharded(fn, state,
                                                    batch).collectives)
    ref = runs["coll"][arch]
    print(f"{arch}: port {got}; reference HLO {ref}")
    assert got["all-reduce"] > 0 and ref["all-reduce"] > 0
    assert got["total"] <= WAS_COLLECTIVES[arch]


def _flat_specs(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_specs(v, f"{prefix}{k}/")
        else:
            yield prefix + k, [list(a) if isinstance(a, tuple) else a
                               for a in v]


def test_whisper_param_placements_equal_the_reference(runs):
    """The port's ``param_shardings`` of whisper-medium's SMOKE tree on a
    2 x 2 mesh equal the reference's spec for spec, the encoder's
    layer-sharded attention weights among them (its leaves are stacked
    only under ``/layers/`` in both packages)."""
    cfg = registry.get_smoke_config("whisper-medium")
    with fake_process_group(4):
        ctx = ShardCtx(mesh=device_mesh((2, 2), ("data", "model"), "cuda"))
        got = dict(_flat_specs(param_shardings(
            init_encdec(cfg, 0, device="meta"), ctx)))
    assert got == runs["specs"]
    assert got["enc_layers/attn/w_q"] == ["data", "model", None]
    assert got["enc_layers/attn/w_o"] == ["model", "data", None]
    assert got["layers/attn/w_q"] == [None, "data", "model"]


@pytest.mark.parametrize("arch", CASES)
@pytest.mark.parametrize("kind,name", [("train", "train_4k"),
                                       ("prefill", "prefill_32k"),
                                       ("decode", "decode_32k")])
def test_family_sharded_cell_counts_the_same_on_cpu_and_meta(arch, kind, name,
                                                             monkeypatch):
    """The dry run's sharded cell of the vlm and audio families at SMOKE
    width, batch 4, 32 tokens, on a 2 x 2 mesh of a fake group: the patch
    and frame embeddings sharded by batch, every decode-state leaf
    (whisper's cross-attention K/V too) laid out by ``decode_state_spec``;
    the per-device count of CPU shards equals that of meta shards, with
    collectives."""
    monkeypatch.setitem(dryrun.SHAPES, name,
                        shapes.ShapeSpec(name, 32, 2, kind))
    cfg = dataclasses.replace(registry.get_smoke_config(arch),
                              remat=kind == "train")
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
                leaves = [t for t in (state.kv.k, state.kv.v, state.cross_k,
                                      state.cross_v) if t is not None]
                assert len(leaves) == (4 if cfg.family == "audio" else 2)
                assert all(isinstance(t, DTensor) for t in leaves)
            else:
                extras = args[1] if kind == "train" else args[2]
                assert all(isinstance(v, DTensor) for k, v in
                           extras.items() if k in ("patches", "frames"))
            work = dryrun.count_sharded(fn, *args)
            counts.append((work.flops, work.bytes, work.collectives,
                           arg_bytes))
    assert counts[0] == counts[1]
    assert counts[0][0] > 0 and counts[0][1] > 0 and counts[0][2]
