"""The paper's LP step (``core/distributed.py::lp_step_leaforder``) as a
row-sharded SPMD program, against the unsharded port and the reference's
GSPMD program, on the CPU.

- A 2 x 2 ("data", "model") gloo mesh (``tests/_spmd_paper_worker.py``,
  four spawned ranks, one subprocess) runs one step with float32 and with
  bfloat16 carriers and a 4-step scan, every input (leaves and blocks)
  split by rows over the whole mesh, on two inputs: the fitted tree of
  ``tests/test_distributed.py``'s sharded-step test (n = 1,024, d = 8,
  C = 4, the coarsest partition, its blocks padded with q = 0 to a count
  the 4 ranks divide) and the ``separated_clusters_vdt`` fixture's fit
  (n = 128, two classes, one point in four labelled).  Each equals the
  same calls on plain tensors within ``rtol=1e-5, atol=1e-6`` (the CPU has
  no atomics, but the shards' partial sums add in another order); the
  bfloat16 carriers within the bfloat16 tolerance of
  ``test_torch_distributed.py::test_bf16_carriers_match_reference``.
- The reference's step, jitted with the same inputs' rows over a 2 x 2
  mesh of ``Auto`` axes on 4 forced host devices (one subprocess), and its
  scan: the port's sharded results within ``rtol=1e-4, atol=1e-5``.  Its
  HLO ``collective_bytes`` are printed beside the port's count of the same
  step: recorded, not compared.
- On a fake process group (one process): the layouts the sharded form does
  not take raise; the dry run's paper cell reads ``sharded: true`` with
  collectives, its variants too, and the paper cell's per-device count on
  CPU shards equals that on meta shards.

Each subprocess has its own time limit (120 s); the two run side by side.
"""
import json
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_spmd import ROOT, SRC, _run_all
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro.core.blocks import coarsest_partition
from repro.core.qopt import optimize_q
from repro.core.tree import build_tree
from repro_torch.configs import paper_vdt
from repro_torch.core.distributed import lp_step_leaforder, shard_rows
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import device_mesh, fake_process_group
from repro_torch.launch.roofline import collective_bytes

CASES = ("fitted", "clusters")
ALPHA, N_ITERS = 0.3, 4
TOL = dict(rtol=1e-5, atol=1e-6)
REF_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)


def _padded(a, b, q, n=4):
    """Blocks padded with inert (q = 0) entries to a multiple of ``n``."""
    pad = (-a.shape[0]) % n
    return (np.pad(a, (0, pad)).astype(np.int64),
            np.pad(b, (0, pad)).astype(np.int64),
            np.pad(q, (0, pad)).astype(np.float32))


def _fitted_inputs() -> dict:
    r = np.random.RandomState(0)
    n, d, c = 1024, 8, 4
    tree = build_tree(r.randn(n, d).astype(np.float32))
    bp = coarsest_partition(tree)
    qs = optimize_q(tree, jnp.asarray(bp.a), jnp.asarray(bp.b),
                    jnp.asarray(bp.active), jnp.asarray(1.0))
    q = np.asarray(jnp.where(jnp.isfinite(qs.log_q), jnp.exp(qs.log_q), 0.0))
    a, b, q = _padded(np.asarray(bp.a), np.asarray(bp.b), q)
    return dict(y=r.randn(n, c).astype(np.float32),
                y0=r.randn(n, c).astype(np.float32), a=a, b=b, q=q,
                L=int(tree.L))


def _cluster_inputs(fixture) -> dict:
    _, labels, vdt = fixture
    tree = vdt.tree
    n_leaves, slot = int(tree.n_leaves), np.asarray(tree.slot_of)
    y0 = np.zeros((n_leaves, 2), np.float32)
    lab = np.arange(len(labels)) % 4 == 0
    y0[slot[lab], np.asarray(labels)[lab]] = 1.0
    y = np.zeros_like(y0)
    y[slot] = np.random.RandomState(1).rand(len(labels), 2)
    log_q = np.asarray(vdt.qstate.log_q)
    q = np.where(np.asarray(vdt.bp.active) & np.isfinite(log_q),
                 np.exp(np.where(np.isfinite(log_q), log_q, 0.0)), 0.0)
    a, b, q = _padded(np.asarray(vdt.bp.a), np.asarray(vdt.bp.b), q)
    return dict(y=y, y0=y0, a=a, b=b, q=q, L=int(tree.L))


def _reference_code(out) -> str:
    """The reference's sharded step and scan on 4 forced host devices."""
    return textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        import json, sys
        sys.path.insert(0, {SRC!r})
        import numpy as np
        import jax, jax.numpy as jnp
        from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
        from repro.core.distributed import (label_propagate_distributed,
                                            lp_step_leaforder)
        from repro.launch.roofline import collective_bytes

        mesh = jax.make_mesh((2, 2), ("data", "model"),
                             axis_types=(AxisType.Auto, AxisType.Auto))
        rows = lambda x: NamedSharding(mesh, P(("data", "model"),
                                               *[None] * (x.ndim - 1)))
        coll = {{}}
        for case in {CASES!r}:
            npz = np.load(f"{out}/{{case}}_inputs.npz")
            alpha, L, n = float(npz["alpha"]), int(npz["L"]), \\
                int(npz["n_iters"])
            args = [jax.device_put(jnp.asarray(npz[k]), rows(npz[k]))
                    for k in ("y", "y0", "a", "b", "q")]
            shards = tuple(rows(x) for x in args)
            res = {{}}
            with mesh:
                step = jax.jit(lambda *t: lp_step_leaforder(*t, alpha, L),
                               in_shardings=shards)
                compiled = step.lower(*args).compile()
                coll[case] = collective_bytes(compiled.as_text())
                res["step"] = np.asarray(compiled(*args))
                res["step_bf16"] = np.asarray(jax.jit(
                    lambda *t: lp_step_leaforder(
                        *t, alpha, L, carrier_dtype=jnp.bfloat16),
                    in_shardings=shards)(*args))
                res["scan"] = np.asarray(jax.jit(
                    lambda y0, a, b, q: label_propagate_distributed(
                        y0, a, b, q, alpha, L, n),
                    in_shardings=shards[1:])(*args[1:]))
            np.savez(f"{out}/{{case}}_ref.npz", **res)
        print(json.dumps(coll))
    """)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, separated_clusters_vdt):
    """The inputs, the reference's sharded results and HLO collective
    bytes, and the port's sharded and plain results, by case."""
    out = tmp_path_factory.mktemp("spmd_paper")
    inputs = {"fitted": _fitted_inputs(),
              "clusters": _cluster_inputs(separated_clusters_vdt)}
    for case, inp in inputs.items():
        np.savez(out / f"{case}_inputs.npz", alpha=ALPHA, n_iters=N_ITERS,
                 **inp)
    ref_out, _ = _run_all([
        ([sys.executable, "-c", _reference_code(out)],
         "the reference's sharded LP step"),
        ([sys.executable, str(ROOT / "tests" / "_spmd_paper_worker.py"),
          str(out), *CASES], "the port's 2 x 2 gloo run of the LP step")])
    coll = json.loads(ref_out.strip().splitlines()[-1])
    return {case: dict(inputs=inputs[case],
                       ref=dict(np.load(out / f"{case}_ref.npz")),
                       port=dict(np.load(out / f"{case}_out.npz")),
                       ref_coll=coll[case]) for case in CASES}


@pytest.mark.parametrize("case", CASES)
def test_sharded_step_and_scan_equal_the_unsharded_port(case, runs):
    res = runs[case]["port"]
    for name in ("step", "scan"):
        np.testing.assert_allclose(res[f"spmd/{name}"], res[f"plain/{name}"],
                                   err_msg=name, **TOL)
        assert str(res[f"spmd/placements/{name}"]) == str(
            (Shard(0), Shard(0)))
    assert np.abs(res["plain/step"] - runs[case]["inputs"]["y0"]).max() > 0


@pytest.mark.parametrize("case", CASES)
def test_sharded_step_and_scan_equal_the_reference(case, runs):
    res, ref = runs[case]["port"], runs[case]["ref"]
    for name in ("step", "scan"):
        np.testing.assert_allclose(res[f"spmd/{name}"], ref[name],
                                   err_msg=name, **REF_TOL)


@pytest.mark.parametrize("case", CASES)
def test_sharded_bf16_carriers(case, runs):
    """bfloat16 carriers (the collectives in bfloat16): within the
    bfloat16 tolerance of the plain port's and the reference's sharded
    bfloat16 step, and rounded (not the float32 step)."""
    res, ref = runs[case]["port"], runs[case]["ref"]
    got = res["spmd/step_bf16"]
    assert got.dtype == np.float32   # cast back to the labels' type
    np.testing.assert_allclose(got, res["plain/step_bf16"], **BF16_TOL)
    np.testing.assert_allclose(got, ref["step_bf16"], **BF16_TOL)
    assert np.abs(got - res["plain/step"]).max() > 0


def test_collective_bytes_printed_beside_the_reference(runs):
    """The port's collectives of the fitted case's step on the same 2 x 2
    mesh (counted on meta under a fake group) beside the reference's HLO
    count: the leaf rows all-gathered, the partials reduce-scattered and
    the top levels all-reduced."""
    inp = runs["fitted"]["inputs"]
    with fake_process_group(4):
        mesh = device_mesh((2, 2), ("data", "model"), "cuda")
        args = [shard_rows(torch.empty(inp[k].shape, device="meta",
                                       dtype=torch.as_tensor(inp[k]).dtype),
                           mesh) for k in ("y", "y0", "a", "b", "q")]
        got = collective_bytes(dryrun.count_sharded(
            lambda *t: lp_step_leaforder(*t, ALPHA, inp["L"]),
            *args).collectives)
    ref = runs["fitted"]["ref_coll"]
    print(f"paper LP step, 2 x 2: port {got}; reference HLO {ref}")
    n, c = inp["y"].shape
    assert got["all-gather"] >= n * c * 4
    assert got["reduce-scatter"] > 0 and got["all-reduce"] > 0
    assert ref["total"] > 0


def _meta_rows(shape, mesh, dtype=torch.float32, pl=None):
    x = torch.empty(shape, dtype=dtype, device="meta")
    if pl is None:
        return shard_rows(x, mesh)
    return DTensor.from_local(x, mesh, pl, run_check=False, shape=shape,
                              stride=x.stride())


@pytest.mark.parametrize("bad", ["replicated", "columns", "rows",
                                 "blocks", "plain", "ranks"])
def test_layouts_the_sharded_step_does_not_take_raise(bad):
    """Rows over one mesh dimension only, columns sharded, leaf rows that
    are not a whole tree's, blocks that do not divide, a plain input beside
    DTensors, or 3 ranks: ``ValueError``, nothing gathered to one rank."""
    L, c, nb = 4, 2, 32
    world = 3 if bad == "ranks" else 4
    with fake_process_group(world):
        mesh = device_mesh((world,) if bad == "ranks" else (2, 2),
                           ("data",) if bad == "ranks" else
                           ("data", "model"), "cuda")
        n = (1 << L) - (4 if bad == "rows" else 0)
        y = _meta_rows((n, c), mesh, pl={
            "replicated": [Shard(0), Replicate()],
            "columns": [Shard(0), Shard(1)]}.get(bad))
        y0 = _meta_rows((n, c), mesh)
        a, b = (_meta_rows((nb + (2 if bad == "blocks" else 0),), mesh,
                           torch.int64) for _ in range(2))
        q = torch.zeros(nb) if bad == "plain" else _meta_rows((nb,), mesh)
        with pytest.raises(ValueError):
            lp_step_leaforder(y, y0, a, b, q, ALPHA, L)


@pytest.mark.parametrize("variant", ["", "sorted", "bf16"])
def test_run_vdt_cell_is_counted_per_device(variant, tmp_path, monkeypatch):
    """The dry run's paper cell (and the variants ``perf_iter`` asks for)
    counted per device on the production mesh: ``sharded: true``, its
    collectives by kind, globalised as ``run_cell`` globalises (FLOPs, 0:
    products only; bytes x the chips), the argument bytes unchanged."""
    monkeypatch.setattr(dryrun, "ART", tmp_path)
    rec = dryrun.run_vdt_cell(False, force=True, variant=variant)
    assert rec["status"] == "ok", rec.get("trace")
    assert rec["sharded"] is True and rec["n_chips"] == 256
    assert rec["flops"] == rec["flops_per_device"] * 256 == 0
    assert rec["bytes"] == rec["bytes_per_device"] * 256 > 0
    coll = rec["collectives"]
    assert coll["all-gather"] > 0 and coll["reduce-scatter"] > 0
    assert coll["all-reduce"] > 0
    assert coll["total"] == rec["roofline"]["coll_bytes"]
    n, c = paper_vdt.N_POINTS, paper_vdt.N_CLASSES
    carrier = 2 if variant == "bf16" else 4
    # the leaf rows gathered in the carrier type (two mesh dimensions)
    assert coll["all-gather"] == n * c * carrier * (1 + 1 / 16)
    specs, _ = paper_vdt.input_specs()
    assert rec["argument_bytes_per_device"] == sum(
        x.numel() * x.element_size() for x in specs.values()) // 256


def test_paper_cell_counts_the_same_on_cpu_and_meta():
    """The paper cell at full size on the production mesh's 16 x 16 fake
    group: rank 0's count on seeded CPU shards equals that on meta shards,
    bytes and collective records."""
    counts = []
    with fake_process_group(256):
        mesh = device_mesh((16, 16), ("data", "model"), "cpu")
        for device in ("cpu", "meta"):
            work = dryrun.count_sharded(
                dryrun.vdt_step_fn(), *dryrun.vdt_sharded_inputs(
                    mesh, device=device))
            counts.append((work.flops, work.bytes, work.collectives))
    assert counts[0] == counts[1]
    assert counts[0][1] > 0 and counts[0][2]
