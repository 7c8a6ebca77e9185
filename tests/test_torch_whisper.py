"""The port's audio family (whisper) against the reference on the CPU.

whisper-medium's ``SMOKE`` configuration (2 + 2 layers, 4/4 heads of 16, 16
encoder frames), the reference's ``init_encdec`` weights carried across with
``lm_params_from_numpy``, seeded numpy frames (B, T_enc, D) and tokens:
``encoder_forward``, ``decoder_forward``, ``encdec_forward``, ``prefill``
(logits, the decoder's self-attention cache and the cross-attention K/V)
and three ``decode_step``s at ``2e-3`` in float32 and ``0.15`` in bfloat16,
the LM tolerances of ``test_torch_lm.py``.  The encoder runs K6's plain
version at ``causal=False`` over frames that do not fill its 64-key tile;
the reference's model masks nothing there either (its kernel would let the
padded keys in, ROADMAP Queue 3), so the port is held to the model.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as r_registry
from repro.models import whisper as r_whisper
from repro.serving import decode as r_decode
from repro_torch.configs import registry
from repro_torch.models import whisper
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.serving import decode

TOL, BF16_TOL = 2e-3, 0.15
B, S, N_DECODE = 2, 12, 3
ARCH = "whisper-medium"

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
        self.rparams = r_whisper.init_encdec(self.rcfg, jax.random.PRNGKey(0))
        self.params = lm_params_from_numpy(
            jax.tree_util.tree_map(np.asarray, self.rparams), self.cfg,
            device="cpu")
        rng = np.random.RandomState(1)
        self.tokens = rng.randint(0, self.cfg.vocab_size,
                                  (B, S + N_DECODE)).astype(np.int32)
        self.frames = rng.randn(B, self.cfg.encoder_frames,
                                self.cfg.d_model).astype(np.float32)
        jt, jf = jnp.asarray(self.tokens), jnp.asarray(self.frames)
        self.r_logits, self.r_state = r_decode.prefill(
            self.rparams, jt[:, :S], self.rcfg, frames=jf)
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


def test_encoder_decoder_and_encdec_forward_match_reference():
    run = _run()
    enc = whisper.encoder_forward(run.params, run.frames, run.cfg)
    r_enc = r_whisper.encoder_forward(run.rparams, jnp.asarray(run.frames),
                                      run.rcfg)
    assert enc.shape == (B, run.cfg.encoder_frames, run.cfg.d_model)
    _close(enc, r_enc)
    dec = whisper.decoder_forward(run.params, run.tokens[:, :S], enc,
                                  run.cfg)
    r_dec = r_whisper.decoder_forward(run.rparams,
                                      jnp.asarray(run.tokens[:, :S]), r_enc,
                                      run.rcfg)
    _close(dec, r_dec)
    logits, aux = whisper.encdec_forward(run.params, run.tokens, run.frames,
                                         run.cfg)
    r_logits, _ = r_whisper.encdec_forward(
        run.rparams, jnp.asarray(run.tokens), jnp.asarray(run.frames),
        run.rcfg)
    assert logits.shape == (B, S + N_DECODE, run.cfg.padded_vocab)
    _close(logits, r_logits)
    assert float(aux) == 0.0


def test_encoder_is_bidirectional_over_a_ragged_tile():
    """A change to the last frame moves the encoder's output at frame 0:
    every frame attends to every other, none past T_enc (16 < 64 keys)."""
    run = _run()
    frames = run.frames.copy()
    base = whisper.encoder_forward(run.params, frames, run.cfg)
    frames[:, -1] += 1.0
    moved = whisper.encoder_forward(run.params, frames, run.cfg)
    assert float((moved[:, 0] - base[:, 0]).abs().max()) > 1e-4
    r_moved = r_whisper.encoder_forward(run.rparams, jnp.asarray(frames),
                                        run.rcfg)
    _close(moved, r_moved)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype):
    run = _run(dtype)
    tol = TOL if dtype == "float32" else BF16_TOL
    cfg = run.cfg
    logits, state = decode.prefill(run.params, run.tokens[:, :S], cfg,
                                   frames=run.frames)
    assert logits.dtype == getattr(torch, dtype)
    _close(logits, run.r_logits, tol)
    assert state.kv.k.shape == (cfg.n_layers, B, S + decode.DECODE_SLACK,
                                cfg.n_kv_heads, cfg.head_dim_)
    assert state.cross_k.shape == (cfg.n_layers, B, cfg.encoder_frames,
                                   cfg.n_kv_heads, cfg.head_dim_)
    assert not state.kv.ring and state.ssm is None
    for got, want in ((state.kv.k, run.r_state.kv.k),
                      (state.kv.v, run.r_state.kv.v),
                      (state.cross_k, run.r_state.cross_k),
                      (state.cross_v, run.r_state.cross_v)):
        _close(got, want, tol)
    for t, (r_logits, r_state) in enumerate(run.r_steps):
        logits, state = decode.decode_step(
            run.params, run.tokens[:, S + t:S + t + 1], state, cfg)
        _close(logits, r_logits, tol)
        np.testing.assert_array_equal(state.kv.pos.numpy(),
                                      np.asarray(r_state.kv.pos))
        _close(state.kv.k, r_state.kv.k, tol)
        _close(state.kv.v, r_state.kv.v, tol)
        _close(state.cross_k, r_state.cross_k, tol)


def test_decode_matches_the_forward_one_position_further():
    """The reference's consistency check, within the port: prefill on S
    tokens and decode token S against ``encdec_forward`` on S + 1 tokens."""
    run = _run()
    logits, state = decode.prefill(run.params, run.tokens[:, :S], run.cfg,
                                   frames=run.frames)
    step, _ = decode.decode_step(run.params, run.tokens[:, S:S + 1], state,
                                 run.cfg)
    full, _ = whisper.encdec_forward(run.params, run.tokens[:, :S + 1],
                                     run.frames, run.cfg)
    _close(logits, full[:, S - 1])
    _close(step, full[:, S])


def test_init_state_matches_reference():
    cfg = registry.get_smoke_config(ARCH)
    state = decode.init_state(cfg, 3, 40, device="cpu")
    r_state = r_decode.init_state(r_registry.get_smoke_config(ARCH), 3, 40)
    for name in ("cross_k", "cross_v"):
        assert tuple(getattr(state, name).shape) == getattr(r_state,
                                                            name).shape
        assert not bool(getattr(state, name).any())
    assert tuple(state.kv.k.shape) == r_state.kv.k.shape
    assert state.kv.ring == r_state.kv.ring is False
    assert state.ssm is None and state.shared_kv is None


def test_config_params_and_registry_match_reference():
    for get in ("get_config", "get_smoke_config"):
        assert dataclasses.asdict(getattr(registry, get)(ARCH)) == \
            dataclasses.asdict(getattr(r_registry, get)(ARCH))
    assert registry.NOT_PORTED == ()
    assert set(registry.ARCH_IDS) == set(r_registry.ARCH_IDS)
    cfg = registry.get_config(ARCH)
    # test_full_config_metadata's row, and its parameter-count range
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
            cfg.vocab_size) == (24, 1024, 16, 16, 4096, 51865)
    assert cfg.family == "audio" and cfg.is_encoder_decoder
    assert cfg.n_encoder_layers == 24 and cfg.encoder_frames == 1500
    assert 0.8e9 < cfg.param_count() < 1.15e9
    run = _run()
    flat = jax.tree_util.tree_flatten_with_path(run.rparams)[0]
    for path, leaf in flat:
        node = run.params
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
    shapes = whisper.encdec_param_shapes(cfg)
    n = sum(int(np.prod(s)) for s in jax.tree_util.tree_leaves(
        shapes, is_leaf=lambda v: isinstance(v, tuple)))
    assert 0.8e9 < n < 1.15e9
    bad = jax.tree_util.tree_map(np.asarray, run.rparams)
    bad["layers"]["xattn"]["w_k"] = bad["layers"]["xattn"]["w_k"][:, :, :4]
    with pytest.raises(ValueError, match="w_k"):
        lm_params_from_numpy(bad, run.cfg, device="cpu")
    del bad["enc_pos"]
    with pytest.raises(KeyError, match="keys"):
        lm_params_from_numpy(bad, run.cfg, device="cpu")


def test_seeded_init_shapes_and_finite_forward():
    cfg = registry.get_smoke_config(ARCH)
    params = whisper.init_encdec(cfg, 3, device="cpu")
    shapes = whisper.encdec_param_shapes(cfg)
    got = jax.tree_util.tree_map(lambda t: tuple(t.shape), params)
    assert got == jax.tree_util.tree_map(
        tuple, shapes, is_leaf=lambda v: isinstance(v, tuple))
    again = whisper.init_encdec(cfg, 3, device="cpu")
    assert torch.equal(params["enc_pos"], again["enc_pos"])
    frames = np.random.RandomState(0).randn(
        1, cfg.encoder_frames, cfg.d_model).astype(np.float32)
    logits, _ = whisper.encdec_forward(params, np.zeros((1, 5), np.int64),
                                       frames, cfg)
    assert logits.shape == (1, 5, cfg.padded_vocab)
    assert bool(torch.isfinite(logits.float()).all())


def test_entry_points_refuse_the_other_family():
    """whisper's entry points take only the audio family; the decoder-only
    LM's refuse it."""
    from repro_torch.models import transformer

    dense = registry.get_smoke_config("smollm-360m")
    with pytest.raises(ValueError, match="decoder-only"):
        whisper.init_encdec(dense, device="cpu")
    audio = registry.get_smoke_config(ARCH)
    with pytest.raises(ValueError, match="encoder-decoder"):
        transformer.init_lm(audio, device="cpu")
    with pytest.raises(ValueError, match="encoder-decoder"):
        transformer.lm_forward({}, np.zeros((1, 2), np.int64), audio)
