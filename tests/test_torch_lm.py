"""The port's dense LM serving path against the reference on the CPU.

For each of the four dense architectures' ``SMOKE`` configurations, in
float32, the reference's ``init_lm`` weights are carried across with
``lm_params_from_numpy`` and both packages run the same numpy tokens through
``rms_norm``/``rope``/``mlp_apply``, ``attn_apply`` (the port's through K6's
plain version), ``lm_forward``, ``prefill`` (logits and KV cache) and three
``decode_step``s.  Tolerance ``rtol=atol=2e-3``, the reference's own
flash-attention-vs-model tolerance (``tests/test_kernels.py``).  smollm's
``SMOKE`` in its own bfloat16 is held at ``0.15``, the reference's own
prefill/decode tolerance (``tests/test_arch_smoke.py``): the two packages
round to bfloat16 at different places, and K6 computes in float32 where the
reference's attention rounds its scores and probabilities to bfloat16.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as r_registry
from repro.models import attention as r_attn
from repro.models import layers as r_layers
from repro.models import transformer as r_tf
from repro.serving import decode as r_decode
from repro_torch.configs import registry
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import attention, layers, transformer
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.serving import decode

TOL = 2e-3
BF16_TOL = 0.15
B, S, N_DECODE = 2, 32, 3

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

# the dense architectures; the MoE ones are in test_torch_moe.py
DENSE = tuple(a for a in registry.ARCH_IDS
              if registry.get_config(a).family == "dense")


def _f32(arch):
    return dataclasses.replace(r_registry.get_smoke_config(arch),
                               dtype="float32")


def _port_cfg(arch, **kw):
    return dataclasses.replace(registry.get_smoke_config(arch), **kw)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


class _Run:
    """One architecture's reference run, shared by the tests of that arch."""

    def __init__(self, arch, dtype="float32", seed=0):
        self.arch = arch
        self.rcfg = dataclasses.replace(r_registry.get_smoke_config(arch),
                                        dtype=dtype)
        self.cfg = _port_cfg(arch, dtype=dtype)
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
            self.r_steps.append((logits, state))


_RUNS = {}


def _run(arch, dtype="float32"):
    if (arch, dtype) not in _RUNS:
        _RUNS[arch, dtype] = _Run(arch, dtype)
    return _RUNS[arch, dtype]


def _layer0(run):
    return (jax.tree_util.tree_map(lambda a: a[0], run.rparams["layers"]),
            transformer.layer_params(run.params["layers"], 0))


@pytest.mark.parametrize("arch", DENSE)
def test_layers_match_reference(arch):
    run = _run(arch)
    rl, tl = _layer0(run)
    r = np.random.RandomState(3)
    d, hd = run.cfg.d_model, run.cfg.head_dim_
    x = r.randn(B, S, d).astype(np.float32)
    gamma = r.randn(d).astype(np.float32) * 0.1
    _close(layers.rms_norm(torch.as_tensor(x), torch.as_tensor(gamma), 1e-6),
           r_layers.rms_norm(jnp.asarray(x), jnp.asarray(gamma), 1e-6), 1e-5)
    q = r.randn(B, S, run.cfg.n_heads, hd).astype(np.float32)
    k = r.randn(B, S, run.cfg.n_kv_heads, hd).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None] + 5, (B, S)).astype(np.int32)
    got = layers.rope(torch.as_tensor(q), torch.as_tensor(k),
                      torch.as_tensor(pos), run.cfg.rope_theta)
    want = r_layers.rope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos),
                         run.rcfg.rope_theta)
    for g, w in zip(got, want):
        _close(g, w, 1e-4)
    _close(layers.mlp_apply(tl["mlp"], torch.as_tensor(x), torch.float32),
           r_layers.mlp_apply(rl["mlp"], jnp.asarray(x), jnp.float32), 1e-4)


@pytest.mark.parametrize("arch", DENSE)
def test_attn_apply_matches_reference(arch):
    """Every layer's window (gemma3's local layers take window 8 through K6),
    and one bidirectional call."""
    run = _run(arch)
    rl, tl = _layer0(run)
    x = np.random.RandomState(4).randn(B, S, run.cfg.d_model).astype(
        np.float32) * 2
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    jx, jpos = jnp.asarray(x), jnp.asarray(pos)
    tx, tpos = torch.as_tensor(x), torch.as_tensor(pos)
    for w in sorted(set(transformer.layer_windows(run.cfg))):
        _close(attention.attn_apply(tl["attn"], tx, run.cfg, tpos, window=w),
               r_attn.attn_apply(rl["attn"], jx, run.rcfg, jpos,
                                 window=jnp.int32(w)))
    _close(attention.attn_apply(tl["attn"], tx, run.cfg, tpos, causal=False),
           r_attn.attn_apply(rl["attn"], jx, run.rcfg, jpos, causal=False))
    src = x[:, :S // 2] * 0.5          # cross-attention keeps the einsum form
    _close(attention.attn_apply(tl["attn"], tx, run.cfg, tpos,
                                kv_x=torch.as_tensor(src)),
           r_attn.attn_apply(rl["attn"], jx, run.rcfg, jpos,
                             kv_x=jnp.asarray(src)))


@pytest.mark.parametrize("arch", DENSE)
def test_lm_forward_matches_reference(arch):
    run = _run(arch)
    got, aux = transformer.lm_forward(run.params, run.tokens[:, :S], run.cfg)
    want, r_aux = r_tf.lm_forward(run.rparams, jnp.asarray(run.tokens[:, :S]),
                                  run.rcfg)
    assert got.shape == (B, S, run.cfg.padded_vocab)
    _close(got, want)
    assert float(aux) == float(r_aux) == 0.0


def _close_state(state, r_state, tol=TOL):
    _close(state.kv.k, r_state.kv.k, tol)
    _close(state.kv.v, r_state.kv.v, tol)
    np.testing.assert_array_equal(state.kv.pos.numpy(),
                                  np.asarray(r_state.kv.pos))
    assert state.kv.ring == r_state.kv.ring


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_reference(arch):
    run = _run(arch)
    before = flash_attention.launches
    logits, state = decode.prefill(run.params, run.tokens[:, :S], run.cfg)
    assert flash_attention.launches == before   # CPU tensors: the plain walk
    _close(logits, run.r_logits)
    assert state.kv.k.shape == (run.cfg.n_layers, B, S + decode.DECODE_SLACK,
                                run.cfg.n_kv_heads, run.cfg.head_dim_)
    _close_state(state, run.r_state)
    for t, (r_logits, r_state) in enumerate(run.r_steps):
        logits, state = decode.decode_step(
            run.params, run.tokens[:, S + t:S + t + 1], state, run.cfg)
        _close(logits, r_logits)
        _close_state(state, r_state)


def test_bf16_prefill_and_decode_match_reference_and_forward():
    """smollm in its own bfloat16: against the reference, and the reference's
    consistency check inside the port (decode at position S vs the full
    forward on S + 1 tokens)."""
    run = _run("smollm-360m", "bfloat16")
    logits, state = decode.prefill(run.params, run.tokens[:, :S], run.cfg)
    assert logits.dtype == torch.bfloat16
    _close(logits, run.r_logits, BF16_TOL)
    _close_state(state, run.r_state, BF16_TOL)
    steps = []
    for t, (r_logits, _) in enumerate(run.r_steps):
        logits, state = decode.decode_step(
            run.params, run.tokens[:, S + t:S + t + 1], state, run.cfg)
        _close(logits, r_logits, BF16_TOL)
        steps.append(logits)
    full, _ = transformer.lm_forward(run.params, run.tokens[:, :S + 1],
                                     run.cfg)
    _close(steps[0], full[:, S].float().numpy(), BF16_TOL)


@pytest.mark.parametrize("s,window", [(12, 5), (10, 5), (3, 8)])
def test_finalize_kv_matches_reference(s, window):
    r = np.random.RandomState(s)
    ks, vs = (r.randn(2, 1, s, 1, 4).astype(np.float32) for _ in range(2))
    for ring in (True, False):
        got = decode._finalize_kv(torch.as_tensor(ks), torch.as_tensor(vs), s,
                                  ring, window)
        want = r_decode._finalize_kv(jnp.asarray(ks), jnp.asarray(vs), s,
                                     ring, window)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("pos", [3, 8, 13, 21])
@pytest.mark.parametrize("ring", [True, False])
def test_attn_decode_matches_reference(pos, ring):
    """The ring's and the linear cache's slot and validity rules (including
    ``min(pos, W - 1)`` on a full linear cache), with and without a window."""
    run = _run("smollm-360m")
    rl, tl = _layer0(run)
    cfg, rcfg = run.cfg, run.rcfg
    r = np.random.RandomState(pos)
    w_cache = 8 if ring else 16
    shape = (B, w_cache, cfg.n_kv_heads, cfg.head_dim_)
    k, v = (r.randn(*shape).astype(np.float32) for _ in range(2))
    x = r.randn(B, 1, cfg.d_model).astype(np.float32)
    for window in (None, 6):
        got, cache = attention.attn_decode(
            tl["attn"], torch.as_tensor(x), attention.KVCache(
                k=torch.as_tensor(k), v=torch.as_tensor(v),
                pos=torch.tensor(pos, dtype=torch.int32), ring=ring),
            cfg, window=window)
        want, r_cache = r_attn.attn_decode(
            rl["attn"], jnp.asarray(x), r_attn.KVCache(
                k=jnp.asarray(k), v=jnp.asarray(v), pos=jnp.int32(pos),
                ring=ring), rcfg,
            window=None if window is None else jnp.int32(window))
        _close(got, want, 1e-4)
        _close(cache.k, r_cache.k, 1e-5)
        _close(cache.v, r_cache.v, 1e-5)
        assert int(cache.pos) == int(r_cache.pos) == pos + 1


def test_ring_cache_prefill_and_decode_match_reference():
    """A pure sliding-window model serves from a ring that wraps around."""
    rcfg = dataclasses.replace(_f32("smollm-360m"), sliding_window=8)
    cfg = _port_cfg("smollm-360m", dtype="float32", sliding_window=8)
    rparams = r_tf.init_lm(rcfg, jax.random.PRNGKey(5))
    params = lm_params_from_numpy(_np(rparams), cfg, device="cpu")
    tokens = np.random.RandomState(6).randint(0, 512, (B, 20)).astype(np.int32)
    logits, state = decode.prefill(params, tokens[:, :12], cfg)
    r_logits, r_state = r_decode.prefill(rparams, jnp.asarray(tokens[:, :12]),
                                         rcfg)
    assert state.kv.ring and state.kv.k.shape[2] == 8
    _close(logits, r_logits)
    step = jax.jit(lambda p, t, s: r_decode.decode_step(p, t, s, rcfg))
    for t in range(12, 20):
        logits, state = decode.decode_step(params, tokens[:, t:t + 1], state,
                                           cfg)
        r_logits, r_state = step(rparams, jnp.asarray(tokens[:, t:t + 1]),
                                 r_state)
        _close(logits, r_logits)
    _close_state(state, r_state)


def test_init_state_matches_reference():
    cfg = _port_cfg("gemma3-1b")
    state = decode.init_state(cfg, 3, 40, device="cpu")
    r_state = r_decode.init_state(r_registry.get_smoke_config("gemma3-1b"),
                                  3, 40)
    assert state.kv.k.shape == r_state.kv.k.shape
    assert state.kv.k.dtype == torch.bfloat16 and not state.kv.k.any()
    np.testing.assert_array_equal(state.kv.pos.numpy(),
                                  np.asarray(r_state.kv.pos))
    assert state.kv.ring == r_state.kv.ring


@pytest.mark.parametrize("arch", DENSE)
def test_configs_are_copies_of_the_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        assert dataclasses.asdict(getattr(registry, get)(arch)) == \
            dataclasses.asdict(getattr(r_registry, get)(arch))
    assert transformer.layer_windows(registry.get_config(arch)) == \
        np.asarray(r_tf.layer_windows(r_registry.get_config(arch))).tolist()


@pytest.mark.parametrize("arch", DENSE)
def test_param_shapes_match_reference_init(arch):
    run = _run(arch)
    flat = jax.tree_util.tree_flatten_with_path(run.rparams)[0]
    for path, leaf in flat:
        node = run.params
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path


def test_seeded_init_has_the_reference_distributions():
    cfg = _port_cfg("internlm2-1.8b", n_layers=3, d_model=256, d_ff=512)
    params = transformer.init_lm(cfg, 7, device="cpu")
    again = transformer.init_lm(cfg, 7, device="cpu")
    assert torch.equal(params["layers"]["attn"]["w_q"],
                       again["layers"]["attn"]["w_q"])
    assert not torch.equal(params["layers"]["attn"]["w_q"],
                           transformer.init_lm(cfg, 8, device="cpu")
                           ["layers"]["attn"]["w_q"])
    wq = params["layers"]["attn"]["w_q"] * cfg.d_model ** 0.5
    assert float(wq.abs().max()) <= 2.0
    # a standard normal truncated to [-2, 2] has variance 0.774
    assert abs(float(wq.var()) - 0.774) < 0.02
    emb = params["embed"] * cfg.d_model ** 0.5
    assert abs(float(emb.std()) - 1.0) < 0.02
    assert not params["layers"]["ln1"].any()
    shapes = transformer.lm_param_shapes(cfg)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), params) == \
        jax.tree_util.tree_map(tuple, shapes,
                               is_leaf=lambda v: isinstance(v, tuple))
    logits, _ = transformer.lm_forward(params, np.zeros((1, 4), np.int64), cfg)
    assert bool(torch.isfinite(logits.float()).all())


def test_lm_params_from_numpy_checks_the_tree():
    run = _run("glm4-9b")
    bad = _np(run.rparams)
    bad["unembed"] = bad["unembed"][:, :8]
    with pytest.raises(ValueError, match="unembed"):
        lm_params_from_numpy(bad, run.cfg, device="cpu")
    del bad["unembed"]
    with pytest.raises(KeyError, match="keys"):
        lm_params_from_numpy(bad, run.cfg, device="cpu")


@pytest.mark.parametrize("family", ["diffusion"])
def test_other_families_name_their_roadmap_item(family):
    """Every family of the reference is ported (``NOT_PORTED`` is empty);
    a configuration of a family outside them is refused by every entry
    point, naming the ROADMAP queue of what is left."""
    assert registry.NOT_PORTED == ()
    assert set(registry.ARCH_IDS) == set(r_registry.ARCH_IDS)
    cfg = dataclasses.replace(registry.get_smoke_config("smollm-360m"),
                              family=family)
    for call in (lambda: transformer.lm_forward({}, np.zeros((1, 2),
                                                             np.int64), cfg),
                 lambda: decode.prefill({}, np.zeros((1, 2), np.int64), cfg),
                 lambda: transformer.init_lm(cfg, device="cpu"),
                 lambda: decode.init_state(cfg, 1, 4, device="cpu")):
        with pytest.raises(NotImplementedError,
                           match=f"{family!r} family is not ported.*"
                                 "ROADMAP Queue 1"):
            call()


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b",
                                  "internvl2-1b"])
def test_ssm_hybrid_and_vlm_architectures_resolve_and_serve(arch):
    """The architectures that named items 12c and 12d resolve to their
    family, and the entry points run them (their parity with the reference
    is in ``test_torch_ssm.py`` and ``test_torch_vlm.py``)."""
    cfg = registry.get_smoke_config(arch)
    assert arch in registry.ARCH_IDS and arch not in registry.NOT_PORTED
    assert cfg.family == r_registry.get_smoke_config(arch).family
    params = transformer.init_lm(cfg, 3, device="cpu")
    patches = (torch.zeros(1, cfg.n_patches, cfg.d_model)
               if cfg.family == "vlm" else None)
    tokens = np.arange(8, dtype=np.int64)[None]
    full, _ = transformer.lm_forward(params, tokens, cfg, patches=patches)
    logits, state = decode.prefill(params, tokens, cfg, patches=patches)
    logits, state = decode.decode_step(params, logits.argmax(-1)[:, None],
                                       state, cfg)
    assert full.shape == (1, 8 + cfg.n_patches, cfg.padded_vocab)
    assert logits.shape == (1, cfg.padded_vocab)
    assert bool(torch.isfinite(logits.float()).all())

