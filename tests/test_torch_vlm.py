"""The port's vlm family against the reference on the CPU.

internvl2-1b's ``SMOKE`` configuration (2 layers, 7/1 heads of 8, 8 patch
embeddings), the reference's ``init_lm`` weights carried across with
``lm_params_from_numpy``, seeded numpy ``patches`` (B, P, D) prepended to the
tokens: ``lm_forward``, ``prefill`` (logits and KV cache) and three
``decode_step``s at ``2e-3`` in float32 and ``0.15`` in bfloat16, the LM
tolerances of ``test_torch_lm.py``; decode continues at position P + S.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as r_registry
from repro.models import transformer as r_tf
from repro.serving import decode as r_decode
from repro_torch.configs import registry
from repro_torch.models import transformer
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.serving import decode

TOL, BF16_TOL = 2e-3, 0.15
B, S, N_DECODE = 2, 16, 3
ARCH = "internvl2-1b"

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


class _Run:
    """The reference's model, prefill and decode steps in one dtype."""

    def __init__(self, dtype):
        self.rcfg = dataclasses.replace(r_registry.get_smoke_config(ARCH),
                                        dtype=dtype)
        self.cfg = dataclasses.replace(registry.get_smoke_config(ARCH),
                                       dtype=dtype)
        self.rparams = r_tf.init_lm(self.rcfg, jax.random.PRNGKey(0))
        self.params = lm_params_from_numpy(
            jax.tree_util.tree_map(np.asarray, self.rparams), self.cfg,
            device="cpu")
        rng = np.random.RandomState(1)
        self.tokens = rng.randint(0, self.cfg.vocab_size,
                                  (B, S + N_DECODE)).astype(np.int32)
        self.patches = rng.randn(B, self.cfg.n_patches,
                                 self.cfg.d_model).astype(np.float32)
        jt = jnp.asarray(self.tokens)
        self.r_logits, self.r_state = r_decode.prefill(
            self.rparams, jt[:, :S], self.rcfg,
            patches=jnp.asarray(self.patches))
        step = jax.jit(lambda p, t, s: r_decode.decode_step(p, t, s,
                                                            self.rcfg))
        self.r_steps, state = [], self.r_state
        for t in range(N_DECODE):
            logits, state = step(self.rparams, jt[:, S + t:S + t + 1], state)
            self.r_steps.append((logits, state))


_RUNS = {}


def _run(dtype="float32"):
    if dtype not in _RUNS:
        _RUNS[dtype] = _Run(dtype)
    return _RUNS[dtype]


def test_lm_forward_with_patches_matches_reference():
    run = _run()
    got, aux = transformer.lm_forward(run.params, run.tokens[:, :S], run.cfg,
                                      patches=run.patches)
    want, _ = r_tf.lm_forward(run.rparams, jnp.asarray(run.tokens[:, :S]),
                              run.rcfg, patches=jnp.asarray(run.patches))
    assert got.shape == (B, run.cfg.n_patches + S, run.cfg.padded_vocab)
    _close(got, want)
    assert float(aux) == 0.0
    # without patches the vlm is its dense backbone
    got, _ = transformer.lm_forward(run.params, run.tokens[:, :S], run.cfg)
    want, _ = r_tf.lm_forward(run.rparams, jnp.asarray(run.tokens[:, :S]),
                              run.rcfg)
    _close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_with_patches_and_decode_match_reference(dtype):
    run = _run(dtype)
    tol = TOL if dtype == "float32" else BF16_TOL
    logits, state = decode.prefill(run.params, run.tokens[:, :S], run.cfg,
                                   patches=run.patches)
    assert logits.dtype == getattr(torch, dtype)
    _close(logits, run.r_logits, tol)
    p = run.cfg.n_patches
    assert state.kv.k.shape == (run.cfg.n_layers, B,
                                p + S + decode.DECODE_SLACK,
                                run.cfg.n_kv_heads, run.cfg.head_dim_)
    _close(state.kv.k, run.r_state.kv.k, tol)
    _close(state.kv.v, run.r_state.kv.v, tol)
    for t, (r_logits, r_state) in enumerate(run.r_steps):
        logits, state = decode.decode_step(
            run.params, run.tokens[:, S + t:S + t + 1], state, run.cfg)
        _close(logits, r_logits, tol)
        np.testing.assert_array_equal(state.kv.pos.numpy(),
                                      np.asarray(r_state.kv.pos))
        assert int(state.kv.pos[0]) == p + S + t + 1
    _close(state.kv.k, r_state.kv.k, tol)


def test_decode_continues_after_the_patches():
    """Decode at position P + S against ``lm_forward`` on the patches and
    S + 1 tokens, within the port."""
    run = _run()
    logits, state = decode.prefill(run.params, run.tokens[:, :S], run.cfg,
                                   patches=run.patches)
    step, _ = decode.decode_step(run.params, run.tokens[:, S:S + 1], state,
                                 run.cfg)
    full, _ = transformer.lm_forward(run.params, run.tokens[:, :S + 1],
                                     run.cfg, patches=run.patches)
    _close(step, full[:, run.cfg.n_patches + S])
    _close(logits, full[:, run.cfg.n_patches + S - 1])


def test_init_state_matches_reference():
    state = decode.init_state(registry.get_smoke_config(ARCH), 3, 40,
                              device="cpu")
    r_state = r_decode.init_state(r_registry.get_smoke_config(ARCH), 3, 40)
    assert tuple(state.kv.k.shape) == r_state.kv.k.shape
    assert state.kv.ring == r_state.kv.ring is False
    assert state.ssm is None and state.shared_kv is None


def test_config_and_param_shapes_match_reference():
    for get in ("get_config", "get_smoke_config"):
        assert dataclasses.asdict(getattr(registry, get)(ARCH)) == \
            dataclasses.asdict(getattr(r_registry, get)(ARCH))
    assert registry.get_config(ARCH).family == "vlm"
    run = _run()
    flat = jax.tree_util.tree_flatten_with_path(run.rparams)[0]
    for path, leaf in flat:
        node = run.params
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
    bad = jax.tree_util.tree_map(np.asarray, run.rparams)
    bad["layers"]["attn"]["w_k"] = bad["layers"]["attn"]["w_k"][:, :, :4]
    with pytest.raises(ValueError, match="w_k"):
        lm_params_from_numpy(bad, run.cfg, device="cpu")
