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

Sharded (parameters as DTensors, ``distributed/sharding.py::shard_params``;
the batch sharded over the data axes), the same code runs as DTensor ops.
The cross-entropy of vocabulary-sharded logits (``"btv"``) is an explicit
reduction in DTensor ops (``_ce_sharded``): each rank's log-sum-exp over
its vocabulary shard, the max and the sums reduced across shards, the
label's logit picked against a sharded vocabulary index, so the (B, S, V)
logits are never gathered.  Where every rank holds the whole vocabulary
(the launcher's ``(n, 1)`` data-parallel mesh, and one rank), each rank
takes the plain cross-entropy of its own rows instead (``_ce_rows``), a
``Partial`` sum over the data axes reduced explicitly: on one rank the
step is then the plain step bit for bit.  (``torch.distributed.tensor.parallel.
loss_parallel()`` takes a 1-D mesh only in the PyTorch the card runs.)
Its sums over the vocabulary shards are reduced by an explicit
redistribution before the ``log``: PyTorch 2.11 differentiates the
reduction DTensor would insert there itself wrongly (every gradient of a
step on more than one rank was off).  The loss is reduced to a replicated
scalar; an MoE model's aux loss is the global one.  Each gradient is
redistributed to its parameter's placements (an FSDP gradient's
``Partial`` sum reduce-scattered), so the optimizer's update, and the
global norm's sum over shards (a ``Partial`` DTensor reduced by DTensor),
run on each rank's shard.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch._device import is_dtensor
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
    if is_dtensor(logits):
        if _vocab_whole(logits, chunked):
            return _ce_rows(logits, labels, chunked)
        return _ce_sharded(logits, labels, chunked)
    if chunked:
        b, s, _ = logits.shape
        return _ce_sum(logits, labels, chunked) / (b * s)
    ls = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -ls.gather(-1, labels[..., None]).mean()


def _ce_sum(logits: torch.Tensor, labels: torch.Tensor,
            chunked: int) -> torch.Tensor:
    """The summed cross-entropy of the positions :func:`_ce` scores, of
    plain tensors."""
    if not chunked:
        ls = torch.log_softmax(logits.to(torch.float32), dim=-1)
        return -ls.gather(-1, labels[..., None]).sum()
    tot = torch.zeros((), dtype=torch.float32, device=logits.device)
    for i in range(logits.shape[1] // chunked):
        sl = slice(i * chunked, (i + 1) * chunked)
        ls = torch.log_softmax(logits[:, sl].to(torch.float32), dim=-1)
        tot = tot - ls.gather(-1, labels[:, sl, None]).sum()
    return tot


def _vocab_whole(logits, chunked: int) -> bool:
    """Whether each rank holds the whole vocabulary of its rows of the
    DTensor ``logits`` (no mesh dimension of more than one rank splits
    it, none holds a ``Partial`` sum), and, with ``chunked``, its whole
    sequence too (the chunks are the sequence's)."""
    mesh, last = logits.device_mesh, logits.ndim - 1
    split = {last, 1} if chunked else {last}
    return not any(p.is_partial() or (p.is_shard() and p.dim in split
                                      and mesh.size(i) > 1)
                   for i, p in enumerate(logits.placements))


def _ce_rows(logits, labels, chunked: int):
    """:func:`_ce` of DTensor logits whose vocabulary each rank holds
    whole: each rank's summed cross-entropy of its own rows (the labels
    laid out as the logits' rows), a ``Partial`` sum over the mesh
    dimensions that split the rows, reduced by an explicit redistribution
    and divided by B S."""
    from torch.distributed.tensor import (Partial, Replicate,
                                          distribute_tensor)
    from torch.distributed.tensor.experimental import local_map

    b, s, _ = logits.shape
    mesh = logits.device_mesh
    splits = [p.is_shard() and p.dim < 2 for p in logits.placements]
    rows = [p if cut else Replicate()
            for p, cut in zip(logits.placements, splits)]
    labels = labels.redistribute(mesh, rows) if is_dtensor(labels) else \
        distribute_tensor(labels, mesh, rows, src_data_rank=None)
    tot = local_map(lambda x, y: _ce_sum(x, y, chunked),
                    out_placements=[Partial() if cut else Replicate()
                                    for cut in splits])(logits, labels)
    return (tot / (b * s)).redistribute(mesh, [Replicate()] * mesh.ndim)


def _ce_sharded(logits, labels, chunked: int):
    """:func:`_ce` of DTensor logits (B, S, V), the vocabulary sharded:
    ``logsumexp - the label's logit`` from each rank's vocabulary shard,
    the max and the sums reduced across shards by DTensor; the label's
    logit picked by comparing the labels with a vocabulary index sharded
    as the logits are, so no rank forms the whole vocabulary."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    b, s, v = logits.shape
    mesh = logits.device_mesh
    vocab = distribute_tensor(
        torch.arange(v, device=logits.device), mesh,
        [Shard(0) if p.is_shard(logits.ndim - 1) else Replicate()
         for p in logits.placements], src_data_rank=None)
    parts = ([slice(i * chunked, (i + 1) * chunked)
              for i in range(s // chunked)] if chunked else [slice(None)])

    def reduced(t):
        # the sums over the vocabulary shards reduced by an explicit
        # redistribution: PyTorch 2.11 differentiates the reduction DTensor
        # inserts on its own before ``log`` wrongly (on more than one rank)
        return t.redistribute(mesh, [Replicate() if p.is_partial() else p
                                     for p in t.placements])

    tot = 0.0
    for sl in parts:
        x = logits[:, sl].to(torch.float32)
        z = x - x.detach().amax(dim=-1, keepdim=True)
        lse = reduced(z.exp().sum(dim=-1)).log()
        picked = reduced(torch.where(labels[:, sl, None] == vocab, z,
                                     0.0).sum(dim=-1))
        tot = tot + (lse - picked).sum()
    return (tot / (b * s)).redistribute(mesh, [Replicate()] * mesh.ndim)


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
    flat = list(leaves(leafs))
    sharded = is_dtensor(flat[0])
    with torch.enable_grad():
        loss, metrics = loss_fn(leafs, batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    by_id = {id(p): (torch.zeros_like(p) if g is None else
                     g.redistribute(p.device_mesh, p.placements) if sharded
                     else g)
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
