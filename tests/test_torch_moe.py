"""The port's MoE family against the reference on the CPU.

For the two MoE architectures' ``SMOKE`` configurations (deepseek-moe-16b:
8 routed experts of 32, top-2, one shared; mixtral-8x7b: 4 experts of 128,
top-2, window 16), the reference's ``init_lm`` weights are carried across
with ``lm_params_from_numpy``: ``_dispatch_indices`` equal to the
reference's as integers (capacity overflow included), ``moe_apply``'s
output and aux loss in float32 at ``2e-3`` (the LM tolerance), also with a
capacity factor low enough to drop assignments, the routers' top-k choices
equal, and ``lm_forward``, ``prefill`` and three ``decode_step``s at
``2e-3`` in float32 and ``0.15`` in bfloat16.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as r_registry
from repro.models import moe as r_moe
from repro.models import transformer as r_tf
from repro.serving import decode as r_decode
from repro_torch.configs import registry
from repro_torch.models import moe, transformer
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.serving import decode

TOL, BF16_TOL = 2e-3, 0.15
B, S, N_DECODE = 2, 24, 3
MOE = ("deepseek-moe-16b", "mixtral-8x7b")

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


class _Run:
    """One architecture's reference model and run, shared by its tests."""

    def __init__(self, arch, dtype, seed=0):
        self.rcfg = dataclasses.replace(r_registry.get_smoke_config(arch),
                                        dtype=dtype)
        self.cfg = dataclasses.replace(registry.get_smoke_config(arch),
                                       dtype=dtype)
        self.rparams = r_tf.init_lm(self.rcfg, jax.random.PRNGKey(seed))
        self.params = lm_params_from_numpy(_np(self.rparams), self.cfg,
                                           device="cpu")
        rng = np.random.RandomState(seed + 1)
        self.tokens = rng.randint(0, self.cfg.vocab_size,
                                  (B, S + N_DECODE)).astype(np.int32)
        jt = jnp.asarray(self.tokens)
        self.r_logits, self.r_state = r_decode.prefill(
            self.rparams, jt[:, :S], self.rcfg)
        self.r_steps = []
        state = self.r_state
        step = jax.jit(lambda p, t, s: r_decode.decode_step(p, t, s,
                                                            self.rcfg))
        for t in range(N_DECODE):
            logits, state = step(self.rparams, jt[:, S + t:S + t + 1], state)
            self.r_steps.append(logits)


_RUNS = {}


def _run(arch, dtype="float32"):
    if (arch, dtype) not in _RUNS:
        _RUNS[arch, dtype] = _Run(arch, dtype)
    return _RUNS[arch, dtype]


def _layer0_moe(run):
    return (jax.tree_util.tree_map(lambda a: a[0],
                                   run.rparams["layers"]["moe"]),
            transformer.layer_params(run.params["layers"], 0)["moe"])


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("t,capacity", [(16, 9), (16, 2), (37, 1), (5, 40)])
def test_dispatch_indices_match_reference(arch, t, capacity):
    """The slot table and its mask as integers; capacities 2 and 1 drop."""
    cfg = registry.get_smoke_config(arch)
    e, k = cfg.n_experts, cfg.experts_per_token
    rng = np.random.RandomState(t * capacity)
    top_i = np.stack([rng.choice(e, k, replace=False) for _ in range(t)])
    table, valid = moe._dispatch_indices(torch.as_tensor(top_i), e, capacity)
    r_table, r_valid = r_moe._dispatch_indices(jnp.asarray(top_i), e,
                                               capacity)
    np.testing.assert_array_equal(table.numpy(), np.asarray(r_table))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(r_valid))
    kept = int(valid.sum())
    assert kept == min(t * k, int(np.minimum(
        np.bincount(top_i.ravel(), minlength=e), capacity).sum()))


def _top_i(x, router, k):
    probs = torch.softmax(torch.as_tensor(x).reshape(-1, x.shape[-1])
                          @ router, dim=-1)
    return torch.topk(probs, k)[1]


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("capacity_factor", [None, 0.5])
def test_moe_apply_matches_reference(arch, capacity_factor):
    """Output and aux loss in float32; at capacity factor 0.5 assignments
    drop in both packages, and the same ones."""
    run = _run(arch)
    cfg, rcfg = run.cfg, run.rcfg
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
        rcfg = dataclasses.replace(rcfg, capacity_factor=capacity_factor)
    rl, tl = _layer0_moe(run)
    x = np.random.RandomState(3).randn(B, S, cfg.d_model).astype(np.float32)
    top_i = _top_i(x, tl["router"], cfg.experts_per_token)
    r_probs = jax.nn.softmax(jnp.asarray(x).reshape(-1, cfg.d_model)
                             @ rl["router"], axis=-1)
    np.testing.assert_array_equal(
        top_i.numpy(), np.asarray(jax.lax.top_k(r_probs,
                                                cfg.experts_per_token)[1]))
    capacity = int(cfg.capacity_factor * B * S * cfg.experts_per_token
                   / cfg.n_experts) + 1
    dropped = B * S * cfg.experts_per_token - int(
        moe._dispatch_indices(top_i, cfg.n_experts, capacity)[1].sum())
    assert (dropped > 0) == (capacity_factor is not None), dropped
    y, aux = moe.moe_apply(tl, torch.as_tensor(x), cfg, torch.float32)
    r_y, r_aux = r_moe.moe_apply(rl, jnp.asarray(x), rcfg, jnp.float32)
    assert y.shape == (B, S, cfg.d_model) and y.dtype == torch.float32
    _close(y, r_y)
    np.testing.assert_allclose(float(aux), float(r_aux), rtol=1e-5)


@pytest.mark.parametrize("arch", MOE)
def test_lm_forward_matches_reference(arch):
    run = _run(arch)
    got, aux = transformer.lm_forward(run.params, run.tokens[:, :S], run.cfg)
    want, r_aux = r_tf.lm_forward(run.rparams, jnp.asarray(run.tokens[:, :S]),
                                  run.rcfg)
    assert got.shape == (B, S, run.cfg.padded_vocab)
    _close(got, want)
    # the layers' load-balance losses, summed
    assert float(aux) > run.cfg.n_layers * 0.5
    np.testing.assert_allclose(float(aux), float(r_aux), rtol=1e-5)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(arch, dtype):
    run = _run(arch, dtype)
    tol = TOL if dtype == "float32" else BF16_TOL
    logits, state = decode.prefill(run.params, run.tokens[:, :S], run.cfg)
    assert logits.dtype == getattr(torch, dtype)
    _close(logits, run.r_logits, tol)
    _close(state.kv.k, run.r_state.kv.k, tol)
    _close(state.kv.v, run.r_state.kv.v, tol)
    assert state.kv.ring == run.r_state.kv.ring
    for t, r_logits in enumerate(run.r_steps):
        logits, state = decode.decode_step(
            run.params, run.tokens[:, S + t:S + t + 1], state, run.cfg)
        _close(logits, r_logits, tol)


@pytest.mark.parametrize("arch", MOE)
def test_configs_and_param_shapes_match_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        assert dataclasses.asdict(getattr(registry, get)(arch)) == \
            dataclasses.asdict(getattr(r_registry, get)(arch))
    assert registry.get_config(arch).family == "moe"
    assert arch in registry.ARCH_IDS and arch not in registry.NOT_PORTED
    run = _run(arch)
    flat = jax.tree_util.tree_flatten_with_path(run.rparams)[0]
    assert len(flat) == len(list(_leaves(run.params)))
    for path, leaf in flat:
        node = run.params
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def test_lm_params_from_numpy_checks_the_moe_tree():
    run = _run("deepseek-moe-16b")
    bad = _np(run.rparams)
    bad["layers"]["moe"]["w_up"] = bad["layers"]["moe"]["w_up"][:, :4]
    with pytest.raises(ValueError, match="w_up"):
        lm_params_from_numpy(bad, run.cfg, device="cpu")
    del bad["layers"]["moe"]["shared"]
    with pytest.raises(KeyError, match="keys"):
        lm_params_from_numpy(bad, run.cfg, device="cpu")


@pytest.mark.parametrize("arch", MOE)
def test_seeded_moe_init_has_the_reference_distributions(arch):
    """Stacked layer by layer, seeded, with the reference's scales."""
    cfg = dataclasses.replace(registry.get_smoke_config(arch), n_layers=3,
                              d_model=128)
    params = transformer.init_lm(cfg, 7, device="cpu")
    again = transformer.init_lm(cfg, 7, device="cpu")
    m = params["layers"]["moe"]
    assert torch.equal(m["w_gate"], again["layers"]["moe"]["w_gate"])
    assert not torch.equal(m["w_gate"][0], m["w_gate"][1])
    fe = cfg.moe_d_ff or cfg.d_ff
    assert m["w_gate"].shape == (3, cfg.n_experts, 128, fe)
    assert abs(float((m["w_gate"] * 128 ** 0.5).std()) - 1.0) < 0.02
    assert abs(float((m["w_down"] * fe ** 0.5).std()) - 1.0) < 0.05
    assert float(m["router"].abs().max()) <= 2.0 * 0.02
    assert ("shared" in m) == bool(cfg.n_shared_experts)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), params) == \
        jax.tree_util.tree_map(tuple, transformer.lm_param_shapes(cfg),
                               is_leaf=lambda v: isinstance(v, tuple))
    logits, aux = transformer.lm_forward(params, np.zeros((1, 4), np.int64),
                                         cfg)
    assert bool(torch.isfinite(logits.float()).all()) and float(aux) > 0
