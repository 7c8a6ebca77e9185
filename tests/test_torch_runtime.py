"""The port's runtime against the reference on the CPU: checkpoints
(``runtime/checkpoint.py``), preemption (``runtime/preemption.py``) and
gradient compression (``distributed/compression.py``).

- everything ``tests/test_runtime.py`` holds, against the port: round trip,
  the ``LATEST`` pointer, fingerprint and structure refusals, async then
  wait, no partial directories; elastic restore of a tree saved from an
  8-shard ``["cpu"] * 8`` mesh onto 4 shards and back; the shutdown flag
  and the watchdog; the bf16 and int8 bounds and int8's unbiasedness;
- the host snapshot: ``save_async`` copies a CPU leaf before it returns, so
  an in-place write after it does not reach the file;
- a DTensor tree on gloo ranks (``tests/_ckpt_worker.py``: ``Shard(0)``,
  ``Shard(1)``, ``Replicate``, int32, 0-dim and 2-D-mesh leaves): ``save``
  and ``save_async`` on 8 ranks write the whole arrays bit for bit, rank 0
  alone; the reference's 8 -> 4 -> 8 elastic case (and 8 -> 2) restores
  DTensors with ``like``'s placements, each rank's local tensor its slice
  of the stored array bit for bit;
- interchange: smollm-360m ``SMOKE``'s train state saved by either package
  restores in the other with every leaf in its place, bit for bit (both
  number leaves in JAX's order);
- ``config_fingerprint`` equal to the reference's for all 10 architectures,
  full and ``SMOKE``;
- compression against the reference: bf16 bit for bit; int8 bit for bit
  when the reference's threefry uniforms are replayed (``uniforms=``).
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as r_registry
from repro.distributed import compression as r_comp
from repro.models import transformer as r_tf
from repro.runtime import checkpoint as r_ckpt
from repro.training import optimizer as r_opt
from repro.training import train_step as r_ts
from repro_torch._tree import flatten
from repro_torch.configs import registry
from repro_torch.distributed import compression
from repro_torch.distributed.compression import (compress_tree,
                                                 decompress_tree)
from repro_torch.distributed.sharding import leaf_mesh, leaf_sharding
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime.preemption import GracefulShutdown, Watchdog
from repro_torch.training import optimizer, train_step


def _tree(seed=0):
    r = np.random.RandomState(seed)
    return {
        "a": torch.as_tensor(r.randn(4, 8).astype(np.float32)),
        "nested": {"b": torch.as_tensor(r.randn(3).astype(np.float32)),
                   "c": torch.as_tensor(r.randint(0, 5, (2, 2)).astype(
                       np.int32))},
    }


def _assert_trees_equal(a, b):
    la, lb = flatten(a)[0], flatten(b)[0]
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype
        assert torch.equal(x, y)


# ------------------------------------------------------------- checkpoint

def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(tmp_path, 7, t, fingerprint="fp1")
    like = {"a": torch.zeros(4, 8), "nested": {"b": torch.zeros(3),
                                               "c": torch.zeros(2, 2)}}
    restored, step = ckpt.restore(tmp_path, like, expect_fingerprint="fp1")
    assert step == 7
    _assert_trees_equal(t, restored)


def test_checkpoint_latest_pointer(tmp_path):
    t = _tree()
    ckpt.save(tmp_path, 1, t)
    ckpt.save(tmp_path, 5, t)
    ckpt.save(tmp_path, 3, t)  # out-of-order write: LATEST moves to 3
    assert ckpt.latest_step(tmp_path) == 3
    assert ckpt.latest_step(tmp_path / "missing") is None


def test_checkpoint_fingerprint_mismatch_refuses(tmp_path):
    t = _tree()
    ckpt.save(tmp_path, 1, t, fingerprint="good")
    with pytest.raises(ValueError, match="fingerprint"):
        ckpt.restore(tmp_path, t, expect_fingerprint="bad")


def test_checkpoint_structure_mismatch_refuses(tmp_path):
    ckpt.save(tmp_path, 1, _tree())
    with pytest.raises(ValueError, match="structure"):
        ckpt.restore(tmp_path, {"only": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(tmp_path, {"a": torch.zeros(8, 4),
                                "nested": {"b": torch.zeros(3),
                                           "c": torch.zeros(2, 2)}})
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path / "empty", _tree())


def test_checkpoint_async_then_wait(tmp_path):
    t = _tree(3)
    ckpt.save_async(tmp_path, 11, t, fingerprint="x")
    ckpt.wait_for_saves()
    restored, step = ckpt.restore(tmp_path, t)
    assert step == 11
    _assert_trees_equal(t, restored)


def test_checkpoint_atomicity_no_partial_dirs(tmp_path):
    """A completed save leaves no tmp dirs behind."""
    ckpt.save(tmp_path, 2, _tree())
    ckpt.save_async(tmp_path, 3, _tree())
    ckpt.wait_for_saves()
    leftovers = [p for p in tmp_path.iterdir() if ".tmp" in p.name]
    assert not leftovers


def test_save_async_snapshots_cpu_leaves_before_it_returns(tmp_path,
                                                           monkeypatch):
    """The write is held until the caller has written into its tensors in
    place: the file still holds the values at ``save_async``."""
    release = threading.Event()
    real_save = ckpt.save

    def held_save(*args, **kwargs):
        assert release.wait(30)
        return real_save(*args, **kwargs)

    monkeypatch.setattr(ckpt, "save", held_save)
    t = _tree(4)
    want_a = t["a"].clone()
    ckpt.save_async(tmp_path, 1, t)
    t["a"].add_(1.0)
    t["nested"]["b"].zero_()
    release.set()
    ckpt.wait_for_saves()
    restored, _ = ckpt.restore(tmp_path, t)
    assert torch.equal(restored["a"], want_a)
    assert torch.equal(restored["nested"]["b"], _tree(4)["nested"]["b"])


def test_failed_background_write_raises_at_wait(tmp_path, monkeypatch):
    def failing_save(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "save", failing_save)
    ckpt.save_async(tmp_path, 1, _tree())
    with pytest.raises(RuntimeError, match="background checkpoint"):
        ckpt.wait_for_saves()
    ckpt.wait_for_saves()  # reported once


def test_restore_places_each_leaf_and_keeps_the_key_order(tmp_path):
    t = _tree(5)
    ckpt.save(tmp_path, 1, t)
    like = {"nested": {"c": torch.zeros(2, 2, device="meta"),
                       "b": torch.zeros(3)},
            "a": np.zeros((4, 8), np.float32)}
    got, _ = ckpt.restore(tmp_path, like, device="cpu")
    assert list(got) == ["nested", "a"] and list(got["nested"]) == ["c", "b"]
    _assert_trees_equal(t, got)
    got, _ = ckpt.restore(tmp_path, like)   # on like's devices
    assert got["nested"]["c"].device.type == "meta"
    assert got["a"].device.type == got["nested"]["b"].device.type == "cpu"
    got, _ = ckpt.restore(tmp_path, like, device="meta")
    assert all(t.device.type == "meta" for t in flatten(got)[0])


@pytest.mark.parametrize("shards", [(8, 4), (4, 8)])
def test_elastic_restore_across_device_counts(tmp_path, shards):
    """Saved from stripes on an 8-shard ``["cpu"] * 8`` mesh (the stored
    array is whole, the stripes gathered), restored onto 4 shards, and
    back: the stored global array is placed on the current mesh."""
    w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    n_save, n_load = shards
    save_sh = leaf_sharding(leaf_mesh(["cpu"] * n_save))
    stripes = save_sh.scatter(w)
    ckpt.save(tmp_path, 1, {"w": save_sh.gather(stripes, "cpu")},
              fingerprint="elastic")
    load_sh = leaf_sharding(leaf_mesh(["cpu"] * n_load))
    restored, step = ckpt.restore(tmp_path, {"w": torch.zeros(8, 8)},
                                  device=load_sh.mesh.devices[0],
                                  expect_fingerprint="elastic")
    parts = load_sh.scatter(restored["w"])
    assert step == 1 and len(parts) == n_load
    assert torch.equal(load_sh.gather(parts, "cpu"), w)


@pytest.fixture(scope="module")
def dtensor_ckpt(tmp_path_factory):
    """``tests/_ckpt_worker.py``'s four phases of spawned gloo ranks."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    out = tmp_path_factory.mktemp("dtensor_ckpt")
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, str(root / "tests" / "_ckpt_worker.py"), str(out)],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, OMP_NUM_THREADS="1",
                 PYTHONPATH=str(root / "src")))
    assert proc.returncode == 0, proc.stderr[-4000:]
    return out


def _ranks(out, phase: str) -> list:
    import json

    return [json.loads(p.read_text()) for p in
            sorted(out.glob(f"{phase}_rank*.json"),
                   key=lambda p: int(p.stem.rsplit("rank", 1)[1]))]


def test_sharded_save_writes_whole_arrays_from_rank_zero_alone(dtensor_ckpt):
    from _ckpt_worker import whole

    want = [np.asarray(v) for v in flatten(whole())[0]]
    for name in ("save8", "async8", "save4"):
        d = dtensor_ckpt / name
        assert sorted(p.name for p in d.iterdir()) == ["LATEST",
                                                       "step_00000002"]
        with np.load(d / "step_00000002" / "arrays.npz") as data:
            got = [data[str(i)] for i in range(len(data.files))]
        assert len(got) == len(want) == 7
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    # rank 0 wrote save8 and async8, and (of 4) save4; no other rank wrote
    assert [r["savez"] for r in _ranks(dtensor_ckpt, "p8")] == [2] + [0] * 7
    assert [r["savez"] for r in _ranks(dtensor_ckpt, "p4")] == [1] + [0] * 3


@pytest.mark.parametrize("phase,n", [("p4", 4), ("p8b", 8), ("p2", 2)])
def test_sharded_restore_onto_other_rank_counts(dtensor_ckpt, phase, n):
    ranks = _ranks(dtensor_ckpt, phase)
    assert len(ranks) == n
    for rank, r in enumerate(ranks):
        assert r["savez"] == 0 or (phase == "p4" and rank == 0)
        assert len(r["leaves"]) == r["n_leaves"] == 7
        for k, leaf in r["leaves"].items():
            assert leaf["dtensor"] == (k != "step"), (rank, k)
            assert leaf["placements"] == leaf["like_placements"], (rank, k)
            assert leaf["shape"] == leaf["like_shape"], (rank, k)
            assert leaf["equal"], (rank, k)


# ------------------------------------------------------------- preemption

def test_graceful_shutdown_flag():
    g = GracefulShutdown(signals=())
    assert not g.requested
    g.request()
    assert g.requested


def test_watchdog_detects_stall():
    events = []
    w = Watchdog(timeout_s=0.2, on_stall=lambda dt: events.append(dt),
                 poll_s=0.02).start()
    for _ in range(3):
        w.beat()
        time.sleep(0.05)
    assert not w.stalled
    time.sleep(0.4)
    assert w.stalled and events
    w.stop()


# ----------------------------------------------------------- interchange

def _at(tree, path):
    """The leaf of a port tree at a ``jax.tree_util`` key path."""
    for key in path:
        if hasattr(key, "key"):
            tree = tree[key.key]
        elif hasattr(key, "name"):
            tree = getattr(tree, key.name)
        else:
            tree = tree[key.idx]
    return tree


def _reference_state(seed):
    """smollm-360m ``SMOKE``'s reference train state, its moments and step
    made distinct per leaf (zeros could be swapped unseen)."""
    rcfg = r_registry.get_smoke_config("smollm-360m")
    params = r_tf.init_lm(rcfg, jax.random.PRNGKey(seed))
    state = r_ts.init_train_state(params, r_opt.AdamWConfig())
    r = np.random.RandomState(seed)
    moments = [jax.tree_util.tree_map(
        lambda p: jnp.asarray(r.randn(*p.shape).astype(np.float32)), params)
        for _ in range(2)]
    return state._replace(
        opt=state.opt._replace(step=jnp.asarray(5, jnp.int32), mu=moments[0],
                               nu=moments[1]),
        step=jnp.asarray(5, jnp.int32))


def _port_like():
    cfg = registry.get_smoke_config("smollm-360m")
    return train_step.init_train_state(
        lm_params_from_numpy(jax.tree_util.tree_map(
            np.asarray, r_tf.init_lm(r_registry.get_smoke_config(
                "smollm-360m"), jax.random.PRNGKey(9))), cfg, device="cpu"),
        optimizer.AdamWConfig())


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    ref = _reference_state(1)
    fp = r_ckpt.config_fingerprint(r_registry.get_smoke_config("smollm-360m"))
    r_ckpt.save(tmp_path, 5, ref, fingerprint=fp)
    like = _port_like()
    got, step = ckpt.restore(tmp_path, like, expect_fingerprint=ckpt.
                             config_fingerprint(registry.get_smoke_config(
                                 "smollm-360m")))
    assert step == 5 and type(got) is type(like)
    assert list(got.params["layers"]) == list(like.params["layers"])
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
        np.testing.assert_array_equal(_at(got, path).numpy(),
                                      np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))
        assert _at(got, path).numpy().dtype == np.asarray(leaf).dtype


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    ref = _reference_state(2)
    port = _port_like()
    # the reference's values in the port's tree, every leaf by its path
    values = {jax.tree_util.keystr(p): np.array(v) for p, v in
              jax.tree_util.tree_flatten_with_path(ref)[0]}
    for path, _ in jax.tree_util.tree_flatten_with_path(ref)[0]:
        _at(port, path).copy_(torch.as_tensor(values[
            jax.tree_util.keystr(path)]))
    ckpt.save(tmp_path, 3, port, fingerprint="fp")
    got, step = r_ckpt.restore(tmp_path, _reference_state(3),
                               expect_fingerprint="fp")
    assert step == 3
    for path, leaf in jax.tree_util.tree_flatten_with_path(got)[0]:
        np.testing.assert_array_equal(np.asarray(leaf),
                                      values[jax.tree_util.keystr(path)])


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_config_fingerprint_matches_the_reference(arch, smoke):
    get, r_get = ((registry.get_smoke_config, r_registry.get_smoke_config)
                  if smoke else (registry.get_config, r_registry.get_config))
    assert ckpt.config_fingerprint(get(arch)) == \
        r_ckpt.config_fingerprint(r_get(arch))


# ------------------------------------------------------- grad compression

def test_bf16_compression_bound(rng):
    g = {"w": torch.as_tensor(rng.randn(128, 64).astype(np.float32))}
    c, aux = compress_tree(g, "bf16")
    d = decompress_tree(c, aux, "bf16")
    rel = (d["w"] - g["w"]).abs() / (g["w"].abs() + 1e-9)
    assert float(rel.max()) < 1e-2
    assert c["w"].dtype == torch.bfloat16 and d["w"].dtype == torch.float32


def test_int8_compression_unbiased(rng):
    """Stochastic rounding: E[deq(q(g))] == g (bias shrinks with n trials)."""
    w = rng.randn(32, 16).astype(np.float32)
    g = {"w": torch.as_tensor(w)}
    acc = np.zeros((32, 16), np.float64)
    trials = 200
    for i in range(trials):
        c, aux = compress_tree(g, "int8",
                               generator=torch.Generator().manual_seed(i))
        acc += decompress_tree(c, aux, "int8")["w"].numpy()
    mean = acc / trials
    scale = np.abs(w).max() / 127.0
    bias = np.abs(mean - w)
    assert bias.max() < 4 * scale / np.sqrt(trials) + 1e-6


def test_int8_compression_error_bound(rng):
    w = rng.randn(64, 64).astype(np.float32)
    g = {"w": torch.as_tensor(w)}
    c, aux = compress_tree(g, "int8",
                           generator=torch.Generator().manual_seed(0))
    d = decompress_tree(c, aux, "int8")
    scale = np.abs(w).max() / 127.0
    err = np.abs(d["w"].numpy() - w)
    assert err.max() <= scale + 1e-6
    assert c["w"].dtype == torch.int8
    with pytest.raises(ValueError, match="generator or uniforms"):
        compress_tree(g, "int8")
    with pytest.raises(ValueError):
        compress_tree(g, "fp4")


def _grads(seed):
    r = np.random.RandomState(seed)
    return {"layers": {"w_q": r.randn(2, 12, 8).astype(np.float32) * 3,
                       "ln": r.randn(2, 12).astype(np.float32) * 1e-3},
            "embed": r.randn(40, 12).astype(np.float32),
            "zero": np.zeros((5,), np.float32)}


def test_bf16_compression_equals_the_reference_bit_for_bit():
    g = _grads(0)
    g["embed"][0, :4] = [1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -9), 3e38]
    ref, _ = r_comp.compress_tree(jax.tree_util.tree_map(jnp.asarray, g),
                                  "bf16")
    got, _ = compress_tree({k: compression_input(v) for k, v in g.items()},
                           "bf16")
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
        np.testing.assert_array_equal(
            _at(got, path).view(torch.int16).numpy(),
            np.asarray(leaf).view(np.int16))


def compression_input(v):
    return ({k: torch.as_tensor(x) for k, x in v.items()}
            if isinstance(v, dict) else torch.as_tensor(v))


def test_int8_compression_equals_the_reference_under_its_uniforms():
    """The reference's per-leaf keys (``jax.random.split`` in its leaf
    order) replayed as ``uniforms=``: q and scale bit for bit."""
    g = _grads(1)
    key = jax.random.PRNGKey(7)
    jg = jax.tree_util.tree_map(jnp.asarray, g)
    ref_q, ref_s = r_comp.compress_tree(jg, "int8", key=key)
    leaves, treedef = jax.tree_util.tree_flatten(jg)
    keys = jax.random.split(key, len(leaves))
    uniforms = jax.tree_util.tree_unflatten(treedef, [
        np.array(jax.random.uniform(k, leaf.shape))
        for leaf, k in zip(leaves, keys)])
    tg = {k: compression_input(v) for k, v in g.items()}
    q, s = compress_tree(tg, "int8",
                         uniforms=jax.tree_util.tree_map(torch.as_tensor,
                                                         uniforms))
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref_q)[0]:
        np.testing.assert_array_equal(_at(q, path).numpy(), np.asarray(leaf))
        assert _at(q, path).dtype == torch.int8
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref_s)[0]:
        np.testing.assert_array_equal(_at(s, path).numpy(), np.asarray(leaf))
    deq = decompress_tree(q, s, "int8")
    ref_deq = r_comp.decompress_tree(ref_q, ref_s, "int8")
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref_deq)[0]:
        np.testing.assert_array_equal(_at(deq, path).numpy(),
                                      np.asarray(leaf))
    with pytest.raises(ValueError, match="shape"):
        compression.int8_compress(tg["embed"],
                                  uniforms=torch.zeros(3))
