"""The port's LM sharding context (``distributed/sharding.py``, its LM half),
GPipe schedule (``distributed/pipeline.py``) and local mesh
(``launch/mesh.py``) against the reference on the CPU.

- ``param_shardings``: the reference's ``PartitionSpec`` of every parameter
  of every architecture's full configuration, on a (4, 2) and a (1, 1)
  ("data", "model") mesh, a (2, 2, 2) ("pod", "data", "model") mesh with
  ``dp=("pod", "data")``, and with expert parallelism for the MoE ones;
- ``ShardCtx``, ``use_ctx`` (thread-local), ``shard_act`` and
  ``shard_attn_logits`` (the identity on one controller);
- ``pipeline_forward`` on ``["cpu"] * 4``: equal to running the stages one
  after another (``rtol=1e-4, atol=1e-5``) and to the reference's
  ``pipeline_forward`` on the same numpy inputs, with ``n_micro *
  n_stages`` calls of ``stage_fn``;
- ``make_local_mesh``: its axes, shape and devices, and no CPU fallback.

The reference side runs once, in one subprocess with
``--xla_force_host_platform_device_count=8``, as
``tests/test_distributed.py::_run`` does (XLA fixes the device count per
process; no flag is set in this one).  The port's full-size parameters are
``meta`` tensors of ``lm_param_shapes`` / ``encdec_param_shapes``.
"""
import json
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.distributed.pipeline import pipeline_forward
from repro_torch.distributed.sharding import (ShardCtx, current_ctx,
                                              param_shardings, shard_act,
                                              shard_attn_logits, use_ctx)
from repro_torch.launch.mesh import LocalMesh, make_local_mesh, \
    mesh_axis_names
from repro_torch.models.transformer import lm_param_shapes
from repro_torch.models.whisper import encdec_param_shapes

SRC = str(Path(__file__).resolve().parents[1] / "src")
N_STAGES, N_MICRO, MB, DIM = 4, 8, 2, 16
# (name, axis sizes, axis names, dp axes, expert_parallel)
MESHES = [("4x2", (4, 2), ("data", "model"), ("data",), False),
          ("1x1", (1, 1), ("data", "model"), ("data",), False),
          ("2x2x2", (2, 2, 2), ("pod", "data", "model"), ("pod", "data"),
           False),
          ("4x2 ep", (4, 2), ("data", "model"), ("data",), True)]


def _pipeline_inputs():
    r = np.random.RandomState(0)
    ws = (r.randn(N_STAGES, DIM, DIM) * 0.3).astype(np.float32)
    x = r.randn(N_MICRO, MB, DIM).astype(np.float32)
    return ws, x


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's specs for every architecture and mesh, and its
    pipeline's output, from one 8-device subprocess."""
    out = tmp_path_factory.mktemp("ref")
    ws, x = _pipeline_inputs()
    np.savez(out / "inputs.npz", ws=ws, x=x)
    code = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import json, sys
        sys.path.insert(0, {SRC!r})
        import numpy as np
        import jax, jax.numpy as jnp
        from repro.configs.registry import ARCH_IDS, get_config
        from repro.distributed.pipeline import pipeline_forward
        from repro.distributed.sharding import ShardCtx, param_shardings
        from repro.models.transformer import init_lm
        from repro.models.whisper import init_encdec

        specs = {{}}
        for arch in ARCH_IDS:
            cfg = get_config(arch)
            init = init_encdec if cfg.family == "audio" else init_lm
            shapes = jax.eval_shape(lambda k: init(cfg, k),
                                    jax.random.PRNGKey(0))
            specs[arch] = {{}}
            for name, sizes, axes, dp, ep in {MESHES!r}:
                mesh = jax.make_mesh(sizes, axes, devices=jax.devices()[
                    :int(np.prod(sizes))])
                sh = param_shardings(shapes, ShardCtx(mesh=mesh, dp=dp),
                                     expert_parallel=ep)
                specs[arch][name] = {{
                    jax.tree_util.keystr(p): list(s.spec) for p, s in
                    jax.tree_util.tree_flatten_with_path(sh)[0]}}
        inp = np.load({str(out / "inputs.npz")!r})
        mesh = jax.make_mesh((4,), ("pod",), devices=jax.devices()[:4])
        with mesh:
            got = pipeline_forward(lambda w, h, s: jnp.tanh(h @ w),
                                   jnp.asarray(inp["ws"]),
                                   jnp.asarray(inp["x"]), mesh, axis="pod")
        np.save({str(out / "pipeline.npy")!r}, np.asarray(got))
        print(json.dumps(specs))
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=420)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return (json.loads(proc.stdout.strip().splitlines()[-1]),
            np.load(out / "pipeline.npy"))


def _meta(shapes):
    return {k: _meta(v) if isinstance(v, dict) else
            torch.empty(v, device="meta") for k, v in shapes.items()}


def _keystr(path):
    return "".join(f"[{k!r}]" for k in path)


def _flat_specs(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_specs(v, path + (k,))
        else:
            yield _keystr(path + (k,)), v


# ------------------------------------------------------------ param specs

@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_param_shardings_equal_the_reference(arch, reference):
    cfg = registry.get_config(arch)
    shapes = (encdec_param_shapes(cfg) if cfg.family == "audio" else
              lm_param_shapes(cfg))
    params = _meta(shapes)
    for name, sizes, axes, dp, ep in MESHES:
        mesh = LocalMesh(axes, sizes, ("cpu",) * int(np.prod(sizes)))
        got = dict(_flat_specs(param_shardings(
            params, ShardCtx(mesh=mesh, dp=dp), expert_parallel=ep)))
        want = reference[0][arch][name]
        assert sorted(got) == sorted(want), name
        for path, spec in got.items():
            assert isinstance(spec, tuple)
            assert len(spec) == len(_at(params, path).shape)
            assert json.loads(json.dumps(spec)) == want[path], (name, path)


def _at(tree, keystr):
    for key in keystr[2:-2].split("']['"):
        tree = tree[key]
    return tree


def test_param_shardings_guard_and_stacked_layers():
    mesh = LocalMesh(("data", "model"), (4, 2), ("cpu",) * 8)
    ctx = ShardCtx(mesh=mesh)
    specs = param_shardings({
        "embed": torch.empty(9, 8, device="meta"),      # 9 % 2 != 0
        "layers": {"attn": {"w_q": torch.empty(3, 8, 6, device="meta")},
                   "ln1": torch.empty(3, 8, device="meta")},
        "final_ln": torch.empty(8, device="meta")}, ctx)
    assert specs["embed"] == (None, None)
    assert specs["layers"]["attn"]["w_q"] == (None, "data", "model")
    assert specs["layers"]["ln1"] == (None, None)
    assert specs["final_ln"] == (None,)
    no_fsdp = param_shardings({"w_o": torch.empty(8, 8, device="meta")},
                              ShardCtx(mesh=mesh, fsdp=False))
    assert no_fsdp["w_o"] == ("model", None)


# ---------------------------------------------------------------- context

def test_shard_ctx_specs_and_thread_local_context():
    mesh = make_local_mesh(data=2, model=2, devices=["cpu"] * 4)
    ctx = ShardCtx(mesh=mesh)
    assert ctx.dp_spec == "data" and ctx.tp_size == 2
    pod = LocalMesh(("pod", "data", "model"), (2, 2, 2), ("cpu",) * 8)
    assert ShardCtx(mesh=pod, dp=("pod", "data")).dp_spec == ("pod", "data")
    x = torch.randn(2, 3, 4)
    assert current_ctx() is None
    assert shard_act(x, "no such kind") is x   # no context: no lookup
    seen = []
    with use_ctx(ctx):
        assert current_ctx() is ctx
        t = threading.Thread(target=lambda: seen.append(current_ctx()))
        t.start()
        t.join(10)
        assert not t.is_alive()
        for kind in ("btd", "btv", "bthd", "btf", "bd", "cache",
                     "cache_seq", "ecd"):
            assert shard_act(x, kind) is x
        with pytest.raises(KeyError):
            shard_act(x, "no such kind")
        with use_ctx(None):
            assert current_ctx() is None
        assert current_ctx() is ctx
        logits = torch.randn(1, 3, 4, 4)
        assert shard_attn_logits(logits) is logits
    assert current_ctx() is None and seen == [None]


# --------------------------------------------------------------- pipeline

def _stage_fn(calls):
    def stage_fn(w, h, stage_idx):
        calls.append((stage_idx, w.device, h.device))
        return torch.tanh(h @ w)
    return stage_fn


def test_pipeline_matches_sequential_and_the_reference(reference):
    ws, x = _pipeline_inputs()
    mesh = make_local_mesh(data=N_STAGES, devices=["cpu"] * N_STAGES)
    calls = []
    got = pipeline_forward(_stage_fn(calls), torch.as_tensor(ws),
                           torch.as_tensor(x), mesh, axis="data")
    ref = torch.as_tensor(x)
    for s in range(N_STAGES):
        ref = torch.tanh(ref @ torch.as_tensor(ws[s]))
    assert got.shape == (N_MICRO, MB, DIM)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), reference[1], rtol=1e-4,
                               atol=1e-5)


def test_pipeline_runs_each_stage_once_per_microbatch():
    """Only the (stage, microbatch) pairs that carry a microbatch run:
    n_micro * n_stages calls, in GPipe order, each stage with its own
    parameters; per microbatch, bit for bit the stages run in sequence."""
    ws, x = _pipeline_inputs()
    mesh = make_local_mesh(data=N_STAGES, devices=["cpu"] * N_STAGES)
    calls = []
    got = pipeline_forward(_stage_fn(calls), torch.as_tensor(ws),
                           torch.as_tensor(x), mesh, axis="data")
    assert len(calls) == N_MICRO * N_STAGES
    # tick t runs stage s on microbatch t - s: stage order within a tick
    ticks = [s for s, _, _ in calls]
    assert ticks[:3] == [0, 0, 1] and ticks[-3:] == [2, 3, 3]
    for m in range(N_MICRO):
        h = torch.as_tensor(x[m])
        for s in range(N_STAGES):
            h = torch.tanh(h @ torch.as_tensor(ws[s]))
        assert torch.equal(got[m], h)


def test_pipeline_stage_fn_sees_its_stage_params():
    mesh = make_local_mesh(data=2, devices=["cpu"] * 2)
    params = {"scale": torch.tensor([[2.0], [3.0]]),
              "shift": {"b": torch.tensor([1.0, 10.0])}}
    got = pipeline_forward(
        lambda p, h, s: h * p["scale"] + p["shift"]["b"] + 100 * s,
        params, torch.ones(3, 1, 1), mesh, axis="data")
    # (1 * 2 + 1) * 3 + 10 + 100
    assert torch.equal(got, torch.full((3, 1, 1), 119.0))


# ------------------------------------------------------------------- mesh

def test_make_local_mesh(monkeypatch):
    mesh = make_local_mesh(model=2, devices=["cpu"] * 4)
    assert mesh_axis_names(mesh) == ("data", "model")
    assert mesh.shape == {"data": 2, "model": 2}
    assert mesh.devices_along("data") == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError, match="needs 6 devices"):
        make_local_mesh(data=3, model=2, devices=["cpu"] * 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_local_mesh()
