"""The port's distributed VDT step and leaf mesh against the reference.

``lp_step_leaforder`` at the shapes of ``tests/test_distributed.py``'s
``test_distributed_vdt_lp_step_matches_reference`` (n = 1,024, d = 8, C = 4,
the coarsest partition, sigma = 1), on the reference's block lists and q,
against the reference's ``lp_step_leaforder`` on one device
(``rtol=1e-4, atol=1e-5``; with bfloat16 carriers ``5e-2``, the reference's
bfloat16 tolerance); the scan against the port's ``lp_scan_leaforder``; the
dry-run stand-ins; and the leaf mesh's rules.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as r_dist
from repro.core.blocks import coarsest_partition
from repro.core.qopt import optimize_q
from repro.core.tree import build_tree
from repro_torch.core import distributed
from repro_torch.core.label_prop import lp_scan_leaforder
from repro_torch.distributed import (LEAF_AXIS, leaf_mesh, leaf_sharding)

ALPHA = 0.3


@pytest.fixture(scope="module")
def step_inputs():
    """The reference test's inputs, as numpy."""
    r = np.random.RandomState(0)
    n, d, c = 1024, 8, 4
    x = r.randn(n, d).astype(np.float32)
    tree = build_tree(x)
    bp = coarsest_partition(tree)
    qs = optimize_q(tree, jnp.asarray(bp.a), jnp.asarray(bp.b),
                    jnp.asarray(bp.active), jnp.asarray(1.0))
    q = jnp.where(jnp.isfinite(qs.log_q), jnp.exp(qs.log_q), 0.0)
    return dict(y=r.randn(n, c).astype(np.float32),
                y0=r.randn(n, c).astype(np.float32),
                a=np.asarray(bp.a), b=np.asarray(bp.b),
                q=np.array(q, np.float32), L=int(tree.L))


def _port(inp, sort=False):
    a, b, q = inp["a"], inp["b"], inp["q"]
    if sort:
        order = np.argsort(a, kind="stable")
        a, b, q = a[order], b[order], q[order]
    return (torch.as_tensor(inp["y"]), torch.as_tensor(inp["y0"]),
            torch.as_tensor(a.astype(np.int64)),
            torch.as_tensor(b.astype(np.int64)), torch.as_tensor(q))


def _ref_step(inp, **kw):
    return np.asarray(r_dist.lp_step_leaforder(
        jnp.asarray(inp["y"]), jnp.asarray(inp["y0"]), jnp.asarray(inp["a"]),
        jnp.asarray(inp["b"]), jnp.asarray(inp["q"]), ALPHA, inp["L"], **kw))


def test_lp_step_matches_reference(step_inputs):
    got = distributed.lp_step_leaforder(*_port(step_inputs), ALPHA,
                                        step_inputs["L"])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _ref_step(step_inputs),
                               rtol=1e-4, atol=1e-5)


def test_bf16_carriers_match_reference(step_inputs):
    got = distributed.lp_step_leaforder(*_port(step_inputs), ALPHA,
                                        step_inputs["L"],
                                        carrier_dtype=torch.bfloat16)
    want = _ref_step(step_inputs, carrier_dtype=jnp.bfloat16)
    assert got.dtype == torch.float32  # cast back to the labels' type
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-2, atol=5e-2)
    f32 = _ref_step(step_inputs)
    assert np.abs(got.numpy() - f32).max() > 0  # the carriers did round


def test_sorted_blocks_equal_unsorted(step_inputs):
    """Blocks pre-sorted by their a-node with ``sorted_blocks=True`` (the
    reference's hint, which ``index_add_`` does not need) give the same
    step as the unsorted blocks, up to the order of each node's sum."""
    plain = distributed.lp_step_leaforder(*_port(step_inputs), ALPHA,
                                          step_inputs["L"])
    got = distributed.lp_step_leaforder(*_port(step_inputs, sort=True),
                                        ALPHA, step_inputs["L"],
                                        sorted_blocks=True)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(got.numpy(), _ref_step(
        step_inputs, sorted_blocks=False), rtol=1e-4, atol=1e-5)


def test_scan_matches_lp_scan_leaforder(step_inputs):
    _, y0, a, b, q = _port(step_inputs)
    L = step_inputs["L"]
    got = distributed.label_propagate_distributed(y0, a, b, q, ALPHA, L, 5)
    want = lp_scan_leaforder(y0, torch.ones((y0.shape[0], 1)), a, b, q,
                             torch.tensor(ALPHA), L, 5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    ref = jax.jit(lambda y: r_dist.label_propagate_distributed(
        y, jnp.asarray(step_inputs["a"]), jnp.asarray(step_inputs["b"]),
        jnp.asarray(step_inputs["q"]), ALPHA, L, 5))(
            jnp.asarray(step_inputs["y0"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("kw", [{}, dict(n_points=1 << 12, n_classes=3,
                                         blocks_per_point=2)])
def test_vdt_input_specs_match_reference(kw):
    specs, meta = distributed.vdt_input_specs(**kw)
    r_specs, r_meta = r_dist.vdt_input_specs(**kw)
    assert meta == r_meta
    assert sorted(specs) == sorted(r_specs)
    for name, t in specs.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == r_specs[name].shape
        assert str(t.dtype).split(".")[1] == str(r_specs[name].dtype)


def test_leaf_mesh_rules(monkeypatch):
    mesh = leaf_mesh(["cpu"] * 4)
    assert mesh.axis == LEAF_AXIS and mesh.size == 4
    assert mesh.distinct_devices == (torch.device("cpu"),)
    layout = leaf_sharding(mesh)
    assert layout.stripes(16) == [(0, 4), (4, 8), (8, 12), (12, 16)]
    x = torch.arange(32.0).reshape(16, 2)
    parts = layout.scatter(x)
    assert [p.shape[0] for p in parts] == [4] * 4
    assert torch.equal(layout.gather(parts, "cpu"), x)
    with pytest.raises(ValueError, match="do not divide"):
        layout.stripes(10)
    for n in (0, 3, 5, 12):
        with pytest.raises(ValueError, match="power-of-two"):
            leaf_mesh(["cpu"] * n)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        leaf_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        leaf_mesh(["cuda:0", "cuda:0"])
