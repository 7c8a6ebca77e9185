"""The port's SSM and hybrid families against the reference on the CPU.

mamba2-130m's and zamba2-1.2b's ``SMOKE`` configurations (mamba2: 2 SSM
layers; zamba2: 4 SSM layers, the shared attention block after layers 1 and
3, window 16), the reference's ``init_lm`` weights carried across with
``lm_params_from_numpy``.  The Mamba2 pieces (``_segsum``, ``_causal_conv``,
``ssd_chunked`` with chunk < S and a non-zero initial state, ``ssm_apply``
and ``ssm_decode`` with their caches) at ``1e-4``; ``lm_forward``,
``prefill`` and three ``decode_step``s at ``2e-3`` in float32 and ``0.15`` in
bfloat16 (the LM tolerances of ``test_torch_lm.py``).  zamba2 is run with
the prompt longer than its window (S = 24) and shorter (S = 8): in the
second the reference's ring keeps S slots, so the first decoded token
evicts token 0 although the window covers it, and the port matches that
decode, eviction included.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as r_registry
from repro.models import ssm as r_ssm
from repro.models import transformer as r_tf
from repro.serving import decode as r_decode
from repro_torch.configs import registry
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import ssm, transformer
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.serving import decode

TOL, BF16_TOL, PIECE_TOL = 2e-3, 0.15, 1e-4
B, N_DECODE = 2, 3
SSM_ARCHS = ("mamba2-130m", "zamba2-1.2b")

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

# the reference's functions, jitted: one compile a shape, not one an op
r_ssd_chunked = jax.jit(r_ssm.ssd_chunked, static_argnames=("chunk",))
r_ssm_apply = jax.jit(r_ssm.ssm_apply, static_argnums=(2, 3),
                      static_argnames=("return_state",))
r_ssm_decode = jax.jit(r_ssm.ssm_decode, static_argnums=(3, 4))
r_lm_forward = jax.jit(r_tf.lm_forward, static_argnums=2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


def _cfgs(arch, **kw):
    return (dataclasses.replace(r_registry.get_smoke_config(arch), **kw),
            dataclasses.replace(registry.get_smoke_config(arch), **kw))


_PARAMS = {}


def _params(arch):
    """The reference's ``init_lm`` weights of ``arch``'s ``SMOKE`` (they do
    not depend on the dtype, the window or the chunk), and the port's copy."""
    if arch not in _PARAMS:
        rcfg, cfg = _cfgs(arch)
        rparams = jax.jit(r_tf.init_lm, static_argnums=0)(
            rcfg, jax.random.PRNGKey(0))
        _PARAMS[arch] = rparams, lm_params_from_numpy(_np(rparams), cfg,
                                                      device="cpu")
    return _PARAMS[arch]


class _Run:
    """One configuration's reference prefill and decode steps (both jitted:
    the reference's SSM prefill is a Python loop over layers)."""

    def __init__(self, arch, s, dtype="float32", seed=1, **kw):
        self.s = s
        self.rcfg, self.cfg = _cfgs(arch, dtype=dtype, **kw)
        self.rparams, self.params = _params(arch)
        self.tokens = np.random.RandomState(seed).randint(
            0, self.cfg.vocab_size, (B, s + N_DECODE)).astype(np.int32)
        jt = jnp.asarray(self.tokens)
        self.r_logits, self.r_state = jax.jit(
            lambda p, t: r_decode.prefill(p, t, self.rcfg))(
                self.rparams, jt[:, :s])
        self.r_steps = []
        state = self.r_state
        step = jax.jit(lambda p, t, st: r_decode.decode_step(p, t, st,
                                                             self.rcfg))
        for t in range(N_DECODE):
            logits, state = step(self.rparams, jt[:, s + t:s + t + 1], state)
            self.r_steps.append((logits, state))


_RUNS = {}


def _run(arch, s=24, dtype="float32", **kw):
    key = (arch, s, dtype, tuple(sorted(kw.items())))
    if key not in _RUNS:
        _RUNS[key] = _Run(arch, s, dtype, **kw)
    return _RUNS[key]


def _layer0_ssm(rparams, params):
    return (jax.tree_util.tree_map(lambda a: a[0], rparams["layers"]["ssm"]),
            transformer.layer_params(params["layers"], 0)["ssm"])


def _ssd_inputs(seed, b=2, s=24, h=8, p=4, g=2, n=4):
    r = np.random.RandomState(seed)
    return dict(x=r.randn(b, s, h, p), dt=np.log1p(np.exp(r.randn(b, s, h))),
                a=-np.exp(r.randn(h) * 0.5), bmat=r.randn(b, s, g, n),
                cmat=r.randn(b, s, g, n), h0=r.randn(b, h, p, n))


@pytest.mark.parametrize("chunk", [4, 8, 24])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_reference(chunk, with_h0):
    """Chunks shorter than S (the inter-chunk recurrence) and one chunk;
    two groups of four heads; a non-zero initial state."""
    args = {k: v.astype(np.float32) for k, v in _ssd_inputs(chunk).items()}
    h0 = args.pop("h0") if with_h0 else None
    args.pop("h0", None)
    y, final = ssm.ssd_chunked(**{k: torch.as_tensor(v)
                                  for k, v in args.items()}, chunk=chunk,
                               h0=None if h0 is None else torch.as_tensor(h0))
    r_y, r_final = r_ssd_chunked(
        **{k: jnp.asarray(v) for k, v in args.items()}, chunk=chunk,
        h0=None if h0 is None else jnp.asarray(h0))
    assert y.shape == (2, 24, 8, 4) and final.shape == (2, 8, 4, 4)
    _close(y, r_y, PIECE_TOL)
    _close(final, r_final, PIECE_TOL)


def test_ssd_chunked_raises_where_the_reference_asserts():
    args = {k: torch.as_tensor(v.astype(np.float32))
            for k, v in _ssd_inputs(0).items() if k != "h0"}
    with pytest.raises(ValueError, match="not a multiple of the chunk 5"):
        ssm.ssd_chunked(**args, chunk=5)
    with pytest.raises(AssertionError):
        r_ssm.ssd_chunked(**{k: jnp.asarray(v.numpy())
                             for k, v in args.items()}, chunk=5)


def test_segsum_and_causal_conv_match_reference():
    r = np.random.RandomState(5)
    a = -np.abs(r.randn(2, 3, 7)).astype(np.float32)
    got, want = ssm._segsum(torch.as_tensor(a)), r_ssm._segsum(jnp.asarray(a))
    np.testing.assert_array_equal(np.isinf(got.numpy()),
                                  np.isinf(np.asarray(want)))
    _close(torch.where(torch.isinf(got), 0.0, got),
           np.where(np.isinf(want), 0.0, want), PIECE_TOL)
    xbc = r.randn(2, 9, 6).astype(np.float32)
    w, bias = r.randn(4, 6).astype(np.float32), r.randn(6).astype(np.float32)
    _close(ssm._causal_conv(*map(torch.as_tensor, (xbc, w, bias))),
           r_ssm._causal_conv(*map(jnp.asarray, (xbc, w, bias))), PIECE_TOL)


@pytest.mark.parametrize("arch", SSM_ARCHS)
@pytest.mark.parametrize("chunk", [256, 8])
def test_ssm_apply_matches_reference(arch, chunk):
    """Output and final state, from a zero and a non-zero initial state;
    ``ssm_chunk`` 8 walks three chunks of S = 24."""
    rcfg, cfg = _cfgs(arch, dtype="float32", ssm_chunk=chunk)
    rl, tl = _layer0_ssm(*_params(arch))
    r = np.random.RandomState(6)
    x = r.randn(B, 24, cfg.d_model).astype(np.float32)
    h0 = r.randn(B, cfg.ssm_heads, cfg.ssm_head_dim,
                 cfg.ssm_state).astype(np.float32)
    outs = []
    for init in (None, h0):
        out, cache = ssm.ssm_apply(
            tl, torch.as_tensor(x), cfg, torch.float32,
            h0=None if init is None else torch.as_tensor(init),
            return_state=True)
        r_out, r_hf = r_ssm_apply(
            rl, jnp.asarray(x), rcfg, jnp.float32,
            h0=None if init is None else jnp.asarray(init),
            return_state=True)
        _close(out, r_out, PIECE_TOL)
        _close(cache.state, r_hf, PIECE_TOL)
        outs.append(r_out)
    # the conv cache: the last K - 1 pre-conv channel inputs
    proj = x @ np.asarray(rl["in_proj"])
    di, gn = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state
    _close(cache.conv, proj[:, -(cfg.ssm_conv - 1):, di:2 * di + 2 * gn],
           PIECE_TOL)
    _close(ssm.ssm_apply(tl, torch.as_tensor(x), cfg, torch.float32),
           outs[0], PIECE_TOL)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_decode_matches_reference(arch):
    """Output, conv cache and state over three steps from a non-zero cache."""
    rcfg, cfg = _cfgs(arch, dtype="float32")
    rl, tl = _layer0_ssm(*_params(arch))
    r = np.random.RandomState(7)
    conv_ch = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    conv = r.randn(B, cfg.ssm_conv - 1, conv_ch).astype(np.float32)
    state = r.randn(B, cfg.ssm_heads, cfg.ssm_head_dim,
                    cfg.ssm_state).astype(np.float32)
    cache = ssm.SSMCache(conv=torch.as_tensor(conv),
                         state=torch.as_tensor(state))
    r_cache = r_ssm.SSMCache(conv=jnp.asarray(conv), state=jnp.asarray(state))
    for t in range(3):
        x = r.randn(B, 1, cfg.d_model).astype(np.float32)
        out, cache = ssm.ssm_decode(tl, torch.as_tensor(x), cache, cfg,
                                    torch.float32)
        r_out, r_cache = r_ssm_decode(rl, jnp.asarray(x), r_cache, rcfg,
                                          jnp.float32)
        _close(out, r_out, PIECE_TOL)
        _close(cache.conv, r_cache.conv, PIECE_TOL)
        _close(cache.state, r_cache.state, PIECE_TOL)


@pytest.mark.parametrize("arch,s", [("mamba2-130m", 24), ("zamba2-1.2b", 24),
                                    ("zamba2-1.2b", 8)])
def test_lm_forward_matches_reference(arch, s):
    run = _run(arch, s)
    before = flash_attention.launches
    got, aux = transformer.lm_forward(run.params, run.tokens[:, :s], run.cfg)
    assert flash_attention.launches == before   # CPU tensors: the plain walk
    want, r_aux = r_lm_forward(run.rparams, jnp.asarray(run.tokens[:, :s]),
                                  run.rcfg)
    assert got.shape == (B, s, run.cfg.padded_vocab)
    _close(got, want)
    assert float(aux) == float(r_aux) == 0.0


def _close_state(state, r_state, tol):
    _close(state.ssm.conv, r_state.ssm.conv, tol)
    _close(state.ssm.state, r_state.ssm.state, tol)
    assert (state.shared_kv is None) == (r_state.shared_kv is None)
    if state.shared_kv is not None:
        _close(state.shared_kv.k, r_state.shared_kv.k, tol)
        _close(state.shared_kv.v, r_state.shared_kv.v, tol)
        np.testing.assert_array_equal(state.shared_kv.pos.numpy(),
                                      np.asarray(r_state.shared_kv.pos))
        assert state.shared_kv.ring == r_state.shared_kv.ring
    assert state.kv is None and r_state.kv is None


@pytest.mark.parametrize("arch,s,dtype", [
    ("mamba2-130m", 24, "float32"), ("mamba2-130m", 24, "bfloat16"),
    ("zamba2-1.2b", 24, "float32"), ("zamba2-1.2b", 24, "bfloat16"),
    ("zamba2-1.2b", 8, "float32")])
def test_prefill_and_decode_match_reference(arch, s, dtype):
    """zamba2 at S = 8 < window 16: the shared block's ring has 8 slots and
    the first decoded token evicts token 0, in both packages."""
    run = _run(arch, s, dtype)
    tol = TOL if dtype == "float32" else BF16_TOL
    logits, state = decode.prefill(run.params, run.tokens[:, :s], run.cfg)
    assert logits.dtype == getattr(torch, dtype)
    _close(logits, run.r_logits, tol)
    _close_state(state, run.r_state, tol)
    if run.cfg.family == "hybrid":
        assert state.shared_kv.k.shape[:3] == (2, B, min(s, 16))
    for t, (r_logits, r_state) in enumerate(run.r_steps):
        logits, state = decode.decode_step(
            run.params, run.tokens[:, s + t:s + t + 1], state, run.cfg)
        _close(logits, r_logits, tol)
        _close_state(state, r_state, tol)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_decode_continues_the_chunked_scan(arch):
    """Within the port: prefill on S = 15 tokens in chunks of 5 (zamba2's
    window set to S, so that its ring holds exactly one window), then decode
    token S, against ``lm_forward`` on S + 1 tokens in chunks of 8: the
    chunked scan and the recurrence agree."""
    s = 15
    _, params = _params(arch)
    cfg = _cfgs(arch, dtype="float32", ssm_chunk=5)[1]
    if arch == "zamba2-1.2b":
        cfg = dataclasses.replace(cfg, sliding_window=s)
    tokens = np.random.RandomState(4).randint(0, cfg.vocab_size, (B, s + 1))
    _, state = decode.prefill(params, tokens[:, :s], cfg)
    step, _ = decode.decode_step(params, tokens[:, s:], state, cfg)
    full, _ = transformer.lm_forward(params, tokens,
                                     dataclasses.replace(cfg, ssm_chunk=8))
    _close(step, full[:, s])


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_init_state_matches_reference(arch):
    cfg = registry.get_smoke_config(arch)
    state = decode.init_state(cfg, 3, 40, device="cpu")
    r_state = r_decode.init_state(r_registry.get_smoke_config(arch), 3, 40)
    for got, want in ((state.ssm.conv, r_state.ssm.conv),
                      (state.ssm.state, r_state.ssm.state)):
        assert tuple(got.shape) == want.shape and not got.any()
    assert state.ssm.conv.dtype == torch.bfloat16
    assert state.ssm.state.dtype == torch.float32
    if arch == "zamba2-1.2b":
        assert tuple(state.shared_kv.k.shape) == r_state.shared_kv.k.shape
        assert state.shared_kv.ring == r_state.shared_kv.ring
    else:
        assert state.shared_kv is None and r_state.shared_kv is None


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_configs_and_param_shapes_match_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        assert dataclasses.asdict(getattr(registry, get)(arch)) == \
            dataclasses.asdict(getattr(r_registry, get)(arch))
    assert transformer.attn_flags(registry.get_config(arch)) == \
        np.asarray(r_tf.attn_flags(r_registry.get_config(arch))).tolist()
    run = _run(arch)
    flat = jax.tree_util.tree_flatten_with_path(run.rparams)[0]
    for path, leaf in flat:
        node = run.params
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert ("shared_attn" in run.params) == (arch == "zamba2-1.2b")


def test_lm_params_from_numpy_checks_the_ssm_and_hybrid_trees():
    run = _run("zamba2-1.2b")
    bad = _np(run.rparams)
    bad["layers"]["ssm"]["conv_w"] = bad["layers"]["ssm"]["conv_w"][:, :2]
    with pytest.raises(ValueError, match="conv_w"):
        lm_params_from_numpy(bad, run.cfg, device="cpu")
    bad = _np(run.rparams)
    bad["shared_attn"]["attn"]["w_q"] = bad["shared_attn"]["attn"]["w_q"][
        :, :8]
    with pytest.raises(ValueError, match="w_q"):
        lm_params_from_numpy(bad, run.cfg, device="cpu")
    del bad["shared_attn"]
    with pytest.raises(KeyError, match="keys"):
        lm_params_from_numpy(bad, run.cfg, device="cpu")
    # mamba2 has no shared block, and its layers no attention
    with pytest.raises(KeyError, match="keys"):
        lm_params_from_numpy(_np(run.rparams), _run("mamba2-130m").cfg,
                             device="cpu")


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_seeded_ssm_init_has_the_reference_distributions(arch):
    cfg = dataclasses.replace(registry.get_smoke_config(arch), n_layers=3,
                              d_model=128)
    params = transformer.init_lm(cfg, 7, device="cpu")
    again = transformer.init_lm(cfg, 7, device="cpu")
    p = params["layers"]["ssm"]
    assert torch.equal(p["in_proj"], again["layers"]["ssm"]["in_proj"])
    assert not torch.equal(p["in_proj"][0], p["in_proj"][1])
    h, di = cfg.ssm_heads, cfg.d_inner
    k, conv_ch = p["conv_w"].shape[1:]
    assert abs(float((p["in_proj"] * 128 ** 0.5).std()) - 0.88) < 0.03
    assert abs(float((p["out_proj"] * di ** 0.5).std()) - 0.88) < 0.03
    assert abs(float((p["conv_w"] * (k * conv_ch) ** 0.5).std()) - 1) < 0.1
    torch.testing.assert_close(
        p["a_log"][0], torch.log(torch.arange(1.0, h + 1)))
    assert bool((p["d_skip"] == 1).all()) and not p["conv_b"].any()
    assert float(p["dt_bias"].min()) >= np.log(1e-3)
    assert float(p["dt_bias"].max()) <= np.log(1e-1)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), params) == \
        jax.tree_util.tree_map(tuple, transformer.lm_param_shapes(cfg),
                               is_leaf=lambda v: isinstance(v, tuple))
    logits, _ = transformer.lm_forward(params, np.zeros((1, 4), np.int64),
                                       cfg)
    assert bool(torch.isfinite(logits.float()).all())
