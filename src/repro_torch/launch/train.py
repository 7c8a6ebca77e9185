"""``repro_torch/launch/train.py`` ↔ ``repro/launch/train.py``.

Training launcher: the reference's loop with checkpoint/restart, preemption
handling and deterministic resumable data, data-parallel over every local
device::

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch smollm-360m --steps 100 --ckpt-dir /tmp/run1

``--device`` (default ``cuda``) picks the device type; without a card pass
``--device cpu`` (with ``--smoke`` for a CPU-sized configuration), or the
launcher raises.  ``--nproc`` is the number of ranks, one a device: by
default every visible card for ``cuda`` (the reference's
``make_local_mesh()`` takes every local device) and 1 for ``cpu``.  More
CUDA ranks than cards, or CUDA ranks without NCCL, raise: no rank moves to
the CPU by itself.  Under ``torchrun`` (its ``RANK`` / ``WORLD_SIZE`` in
the environment) the process is one rank of its launch::

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train ...

Restarting the same command resumes from the latest checkpoint, which may
have been written by the reference's launcher, or on another number of
ranks: both packages number the leaves in JAX's order, fingerprint the
configuration alike, and store whole arrays.  SIGTERM triggers a final
checkpoint and a clean exit (preemption-safe).

The same data (``TokenPipeline``, a pure function of the step), optimizer
schedule (``warmup_steps=max(steps // 20, 2)``, ``total_steps=steps``),
checkpoint cadence (``save_async`` every ``--ckpt-every`` steps, a
synchronous final save, a save on preemption), watchdog and printed lines as
the reference.

One rank (``--nproc 1``, no process group) runs in this process over a
one-device ``launch.mesh.LocalMesh``, where ``shard_act`` constrains
nothing.  With a process group (``--nproc`` > 1: ranks spawned through
``launch.mesh.spawn_ranks``, NCCL on ``cuda:rank`` or gloo on the CPU; or
``torchrun``) every rank runs the reference's SPMD step over a
``("data", "model")`` = ``(world_size, 1)`` ``DeviceMesh`` under
``ShardCtx(mesh, dp=("data",))``: the parameters, initialised from seed 0
alike on every rank, are laid out by ``param_shardings`` (``shard_params``;
the reference leaves the layout to GSPMD, and the values do not depend on
it), the optimizer state takes their placements, each step's whole batch
(a function of the step alone) is sharded over ``data``, and loss, grad
norm and lr are read as replicated values.  Only rank 0 prints.  The ranks
agree after every step whether any of them was asked to stop (an
all-reduce of each rank's ``GracefulShutdown``), so a SIGTERM to one rank,
or to the spawning process, which passes it on, stops them all after the
same step; checkpoints are gathered to rank 0, which writes them
(``runtime/checkpoint.py``), and a resume restores each rank's shards of
the step rank 0 read.  The reference jits the step with its state donated;
here the step returns a new state and the old one is freed when the loop
drops it.

Three repairs of the reference's loop: a preemption save first waits for
an async save in flight (the reference's can race it when the signal lands
in a checkpoint step, both renaming onto the same ``step_X`` while the
process exits under its daemon thread); a final or preemption save whose
step the async save just wrote is not written a second time (the same
state: the files are the same, one write of the whole state the less);
and :func:`main` stops its watchdog and puts back the signal handlers it
replaced, so that a caller that runs it in its own process keeps its
own.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import signal
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._device import is_dtensor, resolve_device
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.distributed.sharding import (ShardCtx, shard_batch,
                                              shard_params, use_ctx)
from repro_torch.launch.mesh import (all_reduce_int, backend_for,
                                     broadcast_int, env_process_group,
                                     local_process_group, make_local_mesh,
                                     make_local_device_mesh, spawn_ranks)
from repro_torch.models.transformer import init_lm
from repro_torch.models.whisper import init_encdec
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime.preemption import GracefulShutdown, Watchdog
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import init_train_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-feasible)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device type to train on (cpu without a card)")
    ap.add_argument("--nproc", type=int, default=None,
                    help="ranks, one a device (default: every card for "
                         "cuda, 1 for cpu; torchrun's world size under it)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:   # torchrun
        world = int(os.environ["WORLD_SIZE"])
        if args.nproc not in (None, world):
            raise ValueError(f"--nproc {args.nproc} under torchrun's world "
                             f"size {world}")
        with env_process_group(dev.type) as rank_dev:
            return _train(args, cfg, rank_dev, spmd=True)
    nproc = _nproc(args.nproc, dev)
    if nproc == 1:
        return _train(args, cfg, dev, spmd=False)
    backend_for(dev.type)   # raises before any rank starts
    spawn_ranks(_rank, nproc, args, cfg, dev.type)
    return 0


def _nproc(nproc, dev: torch.device) -> int:
    """The number of ranks: ``--nproc``, by default every visible card
    for ``cuda`` and one for the CPU; never more CUDA ranks than cards."""
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        n = cards if nproc is None else nproc
        if n > cards:
            raise ValueError(f"--nproc {n} asks for more CUDA ranks than "
                             f"the {cards} visible cards")
        if n > 1 and dev.index is not None:
            raise ValueError(f"--device {dev} names one card; {n} ranks "
                             "take cards 0 to n - 1 (pass --device cuda)")
    else:
        n = 1 if nproc is None else nproc
    if n < 1:
        raise ValueError(f"--nproc {n}: at least one rank")
    return n


def _rank(rank: int, world: int, store: str, args, cfg, device_type: str):
    """One spawned rank: its process group, then the loop."""
    with local_process_group(device_type, rank, world, store) as dev:
        _train(args, cfg, dev, spmd=True)


def _value(x) -> float:
    """A metric as a number: a DTensor's replicated value (a ``Partial``
    reduced first)."""
    return float(x.full_tensor() if is_dtensor(x) else x)


def _train(args, cfg, dev: torch.device, spmd: bool) -> int:
    """The loop on this process: one device (``spmd`` False), or one rank
    of the default process group over a ``(world_size, 1)`` mesh."""
    lead = not spmd or dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 2),
                          total_steps=args.steps)
    mesh = make_local_device_mesh(dev.type) if spmd else \
        make_local_mesh(devices=[dev])
    fingerprint = ckpt.config_fingerprint(cfg)

    ctx = ShardCtx(mesh=mesh, dp=("data",))
    init_fn = init_encdec if cfg.family == "audio" else init_lm
    params = init_fn(cfg, 0, device=dev)
    if spmd:
        params = shard_params(params, ctx,
                              expert_parallel=cfg.expert_parallel)
    state = init_train_state(params, opt_cfg)
    del params

    start_step = 0
    latest = ckpt.latest_step(args.ckpt_dir) if args.ckpt_dir else None
    if spmd:   # rank 0's reading, on every rank
        latest = broadcast_int(-1 if latest is None else latest)
        latest = None if latest < 0 else latest
    if latest is not None:
        state, start_step = ckpt.restore(args.ckpt_dir, state, step=latest,
                                         expect_fingerprint=fingerprint)
        say(f"resumed from step {start_step}", flush=True)

    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=args.seq,
                         global_batch=args.batch)

    raw_step = make_train_step(cfg, opt_cfg,
                               n_microbatches=args.microbatches)

    def train_step(state, batch):
        with use_ctx(ctx):
            return raw_step(state, batch)

    def placed(x):
        return shard_batch(x, ctx) if spmd else x

    with _handlers_restored(), _watchdog() as watchdog:
        shutdown = GracefulShutdown()
        losses, written = [], None   # written: the last save_async's step
        t0 = time.time()
        for step_i in range(start_step, args.steps):
            batch = {"tokens": placed(torch.as_tensor(pipe.batch(step_i),
                                                      device=dev))}
            if cfg.family == "vlm":
                batch["patches"] = placed(torch.zeros(
                    (args.batch, cfg.n_patches, cfg.d_model), device=dev))
            if cfg.family == "audio":
                batch["frames"] = placed(torch.zeros(
                    (args.batch, cfg.encoder_frames, cfg.d_model),
                    device=dev))
            state, metrics = train_step(state, batch)
            watchdog.beat()
            loss = _value(metrics["loss"])
            losses.append(loss)
            if step_i % args.log_every == 0 or step_i == args.steps - 1:
                dt = time.time() - t0
                tps = (step_i - start_step + 1) * args.batch * args.seq / max(dt, 1e-9)
                gnorm, lr = _value(metrics["grad_norm"]), _value(metrics["lr"])
                say(f"step {step_i:5d} loss {loss:.4f} gnorm {gnorm:.3f} "
                    f"lr {lr:.2e} tok/s {tps:.0f}", flush=True)
            if args.ckpt_dir and (step_i + 1) % args.ckpt_every == 0:
                ckpt.save_async(args.ckpt_dir, step_i + 1, state, fingerprint)
                written = step_i + 1
            stop = shutdown.requested
            if spmd:   # any rank's request stops every rank here
                stop = bool(all_reduce_int(stop))
            if stop:
                say("preemption requested: checkpointing and exiting",
                    flush=True)
                if args.ckpt_dir:
                    ckpt.wait_for_saves()
                    if written != step_i + 1:
                        ckpt.save(args.ckpt_dir, step_i + 1, state,
                                  fingerprint)
                return 0
        if args.ckpt_dir:
            ckpt.wait_for_saves()
            if written != args.steps:
                ckpt.save(args.ckpt_dir, args.steps, state, fingerprint)
        first = np.mean(losses[:5]) if len(losses) >= 5 else losses[0]
        last = np.mean(losses[-5:])
        say(f"done: loss {first:.4f} -> {last:.4f} "
            f"({'improved' if last < first else 'NOT improved'})", flush=True)
        return 0


@contextlib.contextmanager
def _handlers_restored(signals=(signal.SIGTERM, signal.SIGINT)):
    """Put back the signal handlers ``GracefulShutdown`` replaces, so that a
    caller of :func:`main` in its own process keeps its own."""
    prev = {s: signal.getsignal(s) for s in signals}
    try:
        yield
    finally:
        if threading.current_thread() is threading.main_thread():
            for s, handler in prev.items():
                signal.signal(s, handler)


@contextlib.contextmanager
def _watchdog():
    watchdog = Watchdog(timeout_s=600.0, on_stall=lambda dt: print(
        f"WATCHDOG: stalled {dt:.0f}s", flush=True)).start()
    try:
        yield watchdog
    finally:
        watchdog.stop()


if __name__ == "__main__":
    raise SystemExit(main())
