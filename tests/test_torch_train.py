"""The port's training path against the reference on the CPU.

- K6's gradient (``ops.flash_attention`` as a ``torch.autograd.Function``,
  its forward the plain version here, its backward float32 torch ops)
  against ``jax.grad`` of the reference's model attention ``attn_apply``
  (a masked einsum) at causal, windowed, GQA and ``causal=False`` ragged S;
- ``warmup_cosine`` and ``adamw_update`` against the reference on a seeded
  tree;
- ``make_train_step`` (plain, ``chunked_ce``, ``n_microbatches=2``) on
  smollm-360m's ``SMOKE`` configuration against the reference's jitted step
  on the same weights and batch: loss, grad norm, every updated parameter
  and the first moment (the clipped gradient, scaled by ``1 - b1``);
- every family (smollm-360m, deepseek-moe-16b with its aux loss,
  mamba2-130m, zamba2-1.2b, internvl2-1b with patches, whisper-medium with
  frames): ``lm_loss.backward()`` reaches every floating parameter, and the
  loss and gradients match ``jax.value_and_grad`` of the reference's
  ``lm_loss``.

Tolerance ``2e-3`` in float32, the LM tolerance of ``test_torch_lm.py``;
gradients and moments relative to their tensor's largest magnitude;
smollm's bfloat16 step at ``0.15``.  The reference's steps are compiled once
per configuration (module-level cache).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as r_registry
from repro.models import attention as r_attn
from repro.models import transformer as r_tf
from repro.models import whisper as r_whisper
from repro.training import optimizer as r_opt
from repro.training import train_step as r_ts
from repro_torch.configs import registry
from repro_torch.kernels.flash_attention import flash_attention_plain, ops
from repro_torch.models import attention
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.models.transformer import leaves, lm_forward
from repro_torch.training import optimizer, train_step

TOL, BF16_TOL = 2e-3, 0.15
B, S = 2, 16
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)   # test_arch_smoke's


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


def _close_scaled(port, ref, tol=TOL):
    """Within ``tol`` of the reference tensor's largest magnitude."""
    ref = np.asarray(ref, np.float32)
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(port.detach().float().numpy(), ref,
                               rtol=tol, atol=tol * scale)


def _walk(port_tree, ref_tree, fn):
    """``fn(port_leaf, ref_leaf, path)`` over the reference tree's leaves."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref_tree)[0]:
        node = port_tree
        for key in path:
            node = node[key.key]
        fn(node, leaf, jax.tree_util.keystr(path))


# ---------------------------------------------------------------- K6 grad

@pytest.mark.parametrize("hq,hkv,s,causal,window", [
    (4, 4, 40, True, None),      # causal
    (4, 4, 40, True, 7),         # windowed
    (6, 2, 40, True, None),      # GQA
    (4, 2, 40, False, None),     # bidirectional, S not a multiple of 64
])
def test_k6_gradient_matches_jax_grad_of_the_model_attention(hq, hkv, s,
                                                             causal, window):
    cfg = dataclasses.replace(registry.get_smoke_config("smollm-360m"),
                              d_model=48, n_heads=hq, n_kv_heads=hkv,
                              dtype="float32")
    rcfg = dataclasses.replace(r_registry.get_smoke_config("smollm-360m"),
                               d_model=48, n_heads=hq, n_kv_heads=hkv,
                               dtype="float32")
    rng = np.random.RandomState(hq + s + (window or 0))
    hd = cfg.head_dim_
    w = {"w_q": rng.randn(48, hq * hd), "w_k": rng.randn(48, hkv * hd),
         "w_v": rng.randn(48, hkv * hd), "w_o": rng.randn(hq * hd, 48)}
    w = {k: (v * 48 ** -0.5).astype(np.float32) for k, v in w.items()}
    x = rng.randn(B, s, 48).astype(np.float32)
    ct = rng.randn(B, s, 48).astype(np.float32)
    pos = np.repeat(np.arange(s)[None], B, axis=0)

    def r_loss(p, x):
        out = r_attn.attn_apply(p, x, rcfg, jnp.asarray(pos), causal=causal,
                                window=window)
        return (out * ct).sum()

    r_val, (r_gp, r_gx) = jax.value_and_grad(r_loss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x))
    tw = {k: torch.tensor(v, requires_grad=True) for k, v in w.items()}
    tx = torch.tensor(x, requires_grad=True)
    out = attention.attn_apply(tw, tx, cfg, torch.as_tensor(pos),
                               causal=causal, window=window)
    val = (out * torch.as_tensor(ct)).sum()
    val.backward()
    np.testing.assert_allclose(val.item(), float(r_val), rtol=TOL)
    _close_scaled(tx.grad, r_gx)
    for k in w:
        _close_scaled(tw[k].grad, r_gp[k])


def test_k6_gradient_matches_float64_autograd_and_counts_only_forwards(
        monkeypatch):
    """The Function's backward against autograd through the dense float64
    softmax (``ref.py``'s form); the plain version taped directly refuses."""
    calls = []
    monkeypatch.setattr(ops, "flash_attention_plain",
                        lambda *a, **k: calls.append(1)
                        or flash_attention_plain(*a, **k))
    rng = np.random.RandomState(4)
    for hq, hkv, s, causal, window in ((6, 2, 70, True, 9),
                                       (3, 1, 40, False, 0),
                                       (2, 2, 65, False, 20)):
        q, k, v = (torch.tensor(rng.randn(2, h, s, 16), requires_grad=True)
                   for h in (hq, hkv, hkv))
        dout = torch.as_tensor(rng.randn(2, hq, s, 16))
        got = torch.autograd.grad(ops.flash_attention(q, k, v, causal,
                                                      window), (q, k, v),
                                  dout)
        rep = hq // hkv
        qi, kj = torch.arange(s)[:, None], torch.arange(s)[None, :]
        mask = torch.ones(s, s, dtype=torch.bool)
        if causal:
            mask &= kj <= qi
        if window:
            mask &= (qi - kj) < window
        logits = (q @ k.repeat_interleave(rep, 1).transpose(-1, -2)) / 4.0
        p = torch.softmax(logits.masked_fill(~mask, float("-inf")), -1)
        want = torch.autograd.grad(p @ v.repeat_interleave(rep, 1),
                                   (q, k, v), dout)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10)
    assert len(calls) == 3     # one forward each; the backward runs none
    q = torch.zeros(1, 1, 8, 64, requires_grad=True)
    with pytest.raises(RuntimeError, match="cannot be differentiated"):
        flash_attention_plain(q, q, q)


# -------------------------------------------------------------- optimizer

def _tree(rng, scale):
    return {"w": (rng.randn(7, 5) * scale).astype(np.float32),
            "layers": {"a": (rng.randn(3, 4, 2) * scale).astype(np.float32),
                       "b": (rng.randn(6) * scale).astype(np.float32)}}


def _t(tree):
    return jax.tree_util.tree_map(torch.as_tensor, tree)


@pytest.mark.parametrize("grad_scale", [10.0, 1e-3])   # clipped / not
def test_adamw_update_matches_reference(grad_scale):
    rng = np.random.RandomState(5)
    cfg = dict(lr=3e-3, warmup_steps=2, total_steps=6)
    r_cfg, cfg = r_opt.AdamWConfig(**cfg), optimizer.AdamWConfig(**cfg)
    params = _tree(rng, 1.0)
    r_params, r_state = jax.tree_util.tree_map(jnp.asarray, params), \
        r_opt.adamw_init(jax.tree_util.tree_map(jnp.asarray, params))
    t_params = _t(params)
    state = optimizer.adamw_init(t_params)
    for _ in range(4):
        grads = _tree(rng, grad_scale)
        r_params, r_state, r_m = r_opt.adamw_update(
            r_cfg, jax.tree_util.tree_map(jnp.asarray, grads), r_state,
            r_params)
        t_params, state, m = optimizer.adamw_update(cfg, _t(grads), state,
                                                    t_params)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(r_m["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(r_m["lr"]),
                                   rtol=1e-6)
        assert int(state.step) == int(r_state.step)
        for port, ref in ((t_params, r_params), (state.mu, r_state.mu),
                          (state.nu, r_state.nu)):
            _walk(port, ref, lambda p, r, path: np.testing.assert_allclose(
                p.numpy(), np.asarray(r), rtol=1e-5, atol=1e-7,
                err_msg=path))


def test_warmup_cosine_matches_reference():
    for kw in (dict(), dict(warmup_steps=3, total_steps=20),
               dict(warmup_steps=0, total_steps=1, min_lr_frac=0.5)):
        r_cfg, cfg = r_opt.AdamWConfig(**kw), optimizer.AdamWConfig(**kw)
        for step in (0, 1, 2, 3, 10, 19, 20, 50, 10_000, 20_000):
            np.testing.assert_allclose(
                float(optimizer.warmup_cosine(cfg, torch.tensor(step))),
                float(r_opt.warmup_cosine(r_cfg, jnp.asarray(step))),
                rtol=1e-6, atol=1e-12)


# ------------------------------------------------------------- train step

def _batch(cfg, seed, b=B, s=S):
    rng = np.random.RandomState(seed)
    batch = {"tokens": rng.randint(0, cfg.vocab_size,
                                   (b, s + 1)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.randn(b, cfg.n_patches,
                                     cfg.d_model).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.randn(b, cfg.encoder_frames,
                                    cfg.d_model).astype(np.float32)
    return batch


def _init(rcfg, seed):
    key = jax.random.PRNGKey(seed)
    if rcfg.family == "audio":
        return r_whisper.init_encdec(rcfg, key)
    return r_tf.init_lm(rcfg, key)


_STEPS = {}


def _ref_step(arch, dtype, **kw):
    """The reference's jitted step, its weights and its result, per case."""
    key = (arch, dtype, tuple(sorted(kw.items())))
    if key not in _STEPS:
        rcfg = dataclasses.replace(r_registry.get_smoke_config(arch),
                                   dtype=dtype)
        rparams = _init(rcfg, 1)
        batch = _batch(rcfg, 2, b=4)
        step = jax.jit(r_ts.make_train_step(rcfg, r_opt.AdamWConfig(**OPT),
                                            **kw))
        state, metrics = step(r_ts.init_train_state(
            rparams, r_opt.AdamWConfig(**OPT)),
            jax.tree_util.tree_map(jnp.asarray, batch))
        _STEPS[key] = rparams, batch, state, metrics
    return _STEPS[key]


@pytest.mark.parametrize("kw", [{}, {"chunked_ce": 4},
                                {"n_microbatches": 2}],
                         ids=["plain", "chunked_ce", "microbatches"])
def test_train_step_matches_reference(kw):
    arch = "smollm-360m"
    rparams, batch, r_state, r_metrics = _ref_step(arch, "float32", **kw)
    cfg = dataclasses.replace(registry.get_smoke_config(arch),
                              dtype="float32")
    params = lm_params_from_numpy(_np(rparams), cfg, device="cpu")
    opt_cfg = optimizer.AdamWConfig(**OPT)
    state = train_step.init_train_state(params, opt_cfg)
    new, metrics = train_step.make_train_step(cfg, opt_cfg, **kw)(state,
                                                                  batch)
    assert int(new.step) == 1 and int(new.opt.step) == 1
    for name in ("loss", "ce", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(float(metrics[name]),
                                   float(r_metrics[name]), rtol=TOL,
                                   atol=1e-6, err_msg=name)
    _walk(new.params, r_state.params, lambda p, r, path: _close(p, r))
    _walk(new.opt.mu, r_state.opt.mu,
          lambda p, r, path: _close_scaled(p, r))
    # the step changed the parameters and left its argument as it was
    assert any(not torch.equal(a, b) for a, b in zip(leaves(params),
                                                     leaves(new.params)))
    _walk(params, rparams, lambda p, r, path: np.testing.assert_array_equal(
        p.numpy(), np.asarray(r)))


def test_train_step_in_bfloat16_matches_reference():
    arch = "smollm-360m"
    rparams, batch, _, r_metrics = _ref_step(arch, "bfloat16")
    cfg = registry.get_smoke_config(arch)       # its own bfloat16
    params = lm_params_from_numpy(_np(rparams), cfg, device="cpu")
    opt_cfg = optimizer.AdamWConfig(**OPT)
    new, metrics = train_step.make_train_step(cfg, opt_cfg)(
        train_step.init_train_state(params, opt_cfg), batch)
    for name in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[name]),
                                   float(r_metrics[name]), rtol=BF16_TOL,
                                   err_msg=name)
    assert all(p.dtype == torch.float32 for p in leaves(new.params))


def test_microbatches_equal_one_step_on_the_whole_batch():
    """Within the port: two microbatches of 2 against one batch of 4."""
    cfg = dataclasses.replace(registry.get_smoke_config("zamba2-1.2b"),
                              dtype="float32")
    params = lm_params_from_numpy(_np(_init(r_registry.get_smoke_config(
        "zamba2-1.2b"), 3)), cfg, device="cpu")
    batch = _batch(cfg, 4, b=4)
    opt_cfg = optimizer.AdamWConfig(**OPT)
    state = train_step.init_train_state(params, opt_cfg)
    one, m1 = train_step.make_train_step(cfg, opt_cfg)(state, batch)
    two, m2 = train_step.make_train_step(cfg, opt_cfg, n_microbatches=2)(
        state, batch)
    # the reference's microbatched loss leaves out the aux term; zamba2 has
    # no MoE, so the two losses agree
    for name in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m2[name]), float(m1[name]),
                                   rtol=TOL)
    for a, b in zip(leaves(two.opt.mu), leaves(one.opt.mu)):
        _close_scaled(a, b.numpy())
    for a, b in zip(leaves(two.params), leaves(one.params)):
        _close(a, b.numpy())


def test_remat_recomputes_each_layer_and_changes_no_value(monkeypatch):
    """``cfg.remat`` checkpoints each layer of a forward that takes a
    gradient: the same loss and gradients, and K6's forward run again in
    the backward; a forward without a gradient runs each layer once."""
    calls = []
    monkeypatch.setattr(ops, "flash_attention_plain",
                        lambda *a, **k: calls.append(1)
                        or flash_attention_plain(*a, **k))
    arch = "smollm-360m"
    rcfg = dataclasses.replace(r_registry.get_smoke_config(arch),
                               dtype="float32")
    batch = _batch(rcfg, 6)
    grads = {}
    for remat in (False, True):
        cfg = dataclasses.replace(registry.get_smoke_config(arch),
                                  dtype="float32", remat=remat)
        params = lm_params_from_numpy(_np(_init(rcfg, 5)), cfg, device="cpu")
        for p in leaves(params):
            p.requires_grad_(True)
        calls.clear()
        loss, _ = train_step.lm_loss(params, batch, cfg)
        loss.backward()
        assert len(calls) == cfg.n_layers * (2 if remat else 1)
        grads[remat] = (loss.item(), [p.grad for p in leaves(params)])
        calls.clear()
        with torch.no_grad():
            lm_forward(params, batch["tokens"], cfg)
        assert len(calls) == cfg.n_layers
    assert grads[True][0] == pytest.approx(grads[False][0], rel=1e-6)
    for a, b in zip(grads[True][1], grads[False][1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------- families

_FAMILIES = ["smollm-360m", "deepseek-moe-16b", "mamba2-130m",
             "zamba2-1.2b", "internvl2-1b", "whisper-medium"]


@pytest.mark.parametrize("arch", _FAMILIES)
def test_every_family_back_propagates_to_every_parameter(arch):
    rcfg = dataclasses.replace(r_registry.get_smoke_config(arch),
                               dtype="float32")
    cfg = dataclasses.replace(registry.get_smoke_config(arch),
                              dtype="float32")
    rparams = _init(rcfg, 7)
    batch = _batch(cfg, 8)
    (r_loss, r_aux), r_grads = jax.jit(jax.value_and_grad(
        lambda p, b: r_ts.lm_loss(p, b, rcfg), has_aux=True))(
        rparams, jax.tree_util.tree_map(jnp.asarray, batch))
    params = lm_params_from_numpy(_np(rparams), cfg, device="cpu")
    for p in leaves(params):
        assert p.is_floating_point()
        p.requires_grad_(True)
    loss, aux = train_step.lm_loss(params, batch, cfg)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(r_loss), rtol=TOL)
    np.testing.assert_allclose(float(aux["aux"]), float(r_aux["aux"]),
                               rtol=TOL, atol=1e-6)
    if arch == "deepseek-moe-16b":
        assert float(aux["aux"]) > 0

    def check(p, r, path):
        assert p.grad is not None, path
        assert bool(torch.isfinite(p.grad).all()), path
        _close_scaled(p.grad, r)

    _walk(params, r_grads, check)
