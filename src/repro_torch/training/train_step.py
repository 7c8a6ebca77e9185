"""``repro_torch/training/train_step.py`` ↔ ``repro/training/train_step.py``.

The train step: next-token cross-entropy (optionally over sequence chunks),
microbatched gradient accumulation in float32, and the AdamW update.  The
reference differentiates its loss with ``jax.value_and_grad``; here
``torch.autograd.grad`` takes the gradient of every parameter, through K6's
backward for self-attention.  A parameter the loss does not reach gets a
zero gradient, as ``jax.grad`` gives it.  The compute dtype is the
configuration's; parameters, gradients and optimizer moments are float32.
With ``cfg.remat`` the forward checkpoints each layer and recomputes it in
the backward, which launches K6 a second time for each layer.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.transformer import leaves, lm_forward
from repro_torch.models.whisper import encdec_forward
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            adamw_init, adamw_update,
                                            tree_map)

__all__ = ["TrainState", "init_train_state", "lm_loss", "make_train_step"]


class TrainState(NamedTuple):
    params: dict
    opt: AdamWState
    step: torch.Tensor   # () int32


def init_train_state(params: dict, opt_cfg: AdamWConfig) -> TrainState:
    opt = adamw_init(params)
    return TrainState(params=params, opt=opt, step=torch.zeros_like(opt.step))


def _ce(logits: torch.Tensor, labels: torch.Tensor, vocab: int,
        chunked: int = 0) -> torch.Tensor:
    """Mean next-token CE.  ``chunked`` > 0 walks sequence chunks of that
    length, so the (B, S, V) float32 log-softmax is never formed at once;
    as in the reference, positions past the last whole chunk are not
    scored, and the sum is divided by B S."""
    if chunked:
        b, s, _ = logits.shape
        tot = torch.zeros((), dtype=torch.float32, device=logits.device)
        for i in range(s // chunked):
            sl = slice(i * chunked, (i + 1) * chunked)
            ls = torch.log_softmax(logits[:, sl].to(torch.float32), dim=-1)
            tot = tot - ls.gather(-1, labels[:, sl, None]).sum()
        return tot / (b * s)
    ls = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -ls.gather(-1, labels[..., None]).mean()


def lm_loss(params: dict, batch: dict, cfg, aux_weight: float = 0.01,
            chunked_ce: int = 0):
    """``batch``: {"tokens": (B, S + 1)} (+ "patches" for a vlm, "frames"
    for an audio model).  Returns ``(loss, {"ce", "aux"})``."""
    device = next(leaves(params)).device
    tokens = torch.as_tensor(batch["tokens"], device=device).long()
    inp, labels = tokens[:, :-1], tokens[:, 1:]
    if cfg.family == "audio":
        logits, aux = encdec_forward(params, inp, batch["frames"], cfg)
    elif cfg.family == "vlm":
        logits, aux = lm_forward(params, inp, cfg, patches=batch["patches"])
        logits = logits[:, cfg.n_patches:]          # score text positions
    else:
        logits, aux = lm_forward(params, inp, cfg)
    loss = _ce(logits, labels, cfg.padded_vocab, chunked=chunked_ce)
    return loss + aux_weight * aux, {"ce": loss, "aux": aux}


def _value_and_grad(loss_fn, params: dict, batch: dict):
    """``(loss, metrics), grads`` of ``loss_fn(params, batch)``; the
    gradients float32 tensors, detached."""
    leafs = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(leafs, batch)
        flat = list(leaves(leafs))
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    by_id = {id(p): (torch.zeros_like(p) if g is None else g)
             for p, g in zip(flat, grads)}
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            tree_map(lambda p: by_id[id(p)], leafs))


def _microbatch(batch: dict, n: int, i: int) -> dict:
    """Microbatch ``i`` of ``n``: rows ``i * B / n`` to ``(i + 1) * B / n``
    of every array."""
    def part(x):
        x = torch.as_tensor(x)
        m = x.shape[0] // n
        return x[i * m:(i + 1) * m]
    return {k: part(v) for k, v in batch.items()}


def make_train_step(cfg, opt_cfg: AdamWConfig, n_microbatches: int = 1,
                    chunked_ce: int = 0):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    With ``n_microbatches > 1`` the batch is split on its first axis, the
    microbatches' gradients are summed in float32 and divided by the count,
    and so is the loss; ``metrics["ce"]`` is then that mean loss and
    ``metrics["aux"]`` 0, as in the reference.
    """

    def loss_fn(params, batch):
        return lm_loss(params, batch, cfg, chunked_ce=chunked_ce)

    def train_step(state: TrainState, batch: dict):
        if n_microbatches == 1:
            (loss, metrics), grads = _value_and_grad(loss_fn, state.params,
                                                     batch)
        else:
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), state.params)
            loss = 0.0
            for i in range(n_microbatches):
                (l_i, _), g = _value_and_grad(
                    loss_fn, state.params,
                    _microbatch(batch, n_microbatches, i))
                grads = tree_map(lambda a, b: a.add_(b.to(torch.float32)),
                                 grads, g)
                loss = loss + l_i
                del g
            grads = tree_map(lambda g: g.div_(n_microbatches), grads)
            loss = loss / n_microbatches
            metrics = {"ce": loss, "aux": torch.zeros_like(loss)}
        params, opt, opt_metrics = adamw_update(opt_cfg, grads, state.opt,
                                                state.params)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return TrainState(params=params, opt=opt, step=state.step + 1), \
            metrics

    return train_step
