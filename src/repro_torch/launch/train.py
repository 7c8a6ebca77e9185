"""``repro_torch/launch/train.py`` ↔ ``repro/launch/train.py``.

Training launcher: the reference's loop with checkpoint/restart, preemption
handling and deterministic resumable data, on one device::

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch smollm-360m --steps 100 --ckpt-dir /tmp/run1

``--device`` (default ``cuda``) picks the device; without a card pass
``--device cpu`` (with ``--smoke`` for a CPU-sized configuration), or the
launcher raises.  Restarting the same command resumes from the latest
checkpoint, which may have been written by the reference's launcher: both
number the leaves in JAX's order and fingerprint the configuration alike.
SIGTERM triggers a final checkpoint and a clean exit (preemption-safe).

The same data (``TokenPipeline``, a pure function of the step), optimizer
schedule (``warmup_steps=max(steps // 20, 2)``, ``total_steps=steps``),
checkpoint cadence (``save_async`` every ``--ckpt-every`` steps, a
synchronous final save, a save on preemption), watchdog and printed lines as
the reference.  The step runs inside ``use_ctx(ShardCtx(...))`` over a
one-device ``launch.mesh.LocalMesh``, where ``shard_act`` constrains
nothing: the launcher drives one card.  (The dense LM runs sharded over a
``DeviceMesh``, ``distributed/sharding.py``; the launcher on several cards
is queued in ROADMAP.)  The reference jits the step with its state donated;
here the step returns a new state and the old one is freed when the loop
drops it.

Two repairs of the reference's loop: a preemption save first waits for an
async save in flight (the reference's can race it when the signal lands in
a checkpoint step, both renaming onto the same ``step_X`` while the process
exits under its daemon thread); and :func:`main` stops its watchdog and puts
back the signal handlers it replaced, so that a caller that runs it in its
own process keeps its own.
"""
from __future__ import annotations

import argparse
import contextlib
import signal
import threading
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.distributed.sharding import ShardCtx, use_ctx
from repro_torch.launch.mesh import make_local_mesh
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
                    help="torch device to train on (cpu without a card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 2),
                          total_steps=args.steps)
    mesh = make_local_mesh(devices=[dev])
    fingerprint = ckpt.config_fingerprint(cfg)

    ctx = ShardCtx(mesh=mesh, dp=("data",))
    init_fn = init_encdec if cfg.family == "audio" else init_lm
    params = init_fn(cfg, 0, device=dev)
    state = init_train_state(params, opt_cfg)
    del params

    start_step = 0
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        state, start_step = ckpt.restore(args.ckpt_dir, state,
                                         expect_fingerprint=fingerprint)
        print(f"resumed from step {start_step}", flush=True)

    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=args.seq,
                         global_batch=args.batch)

    raw_step = make_train_step(cfg, opt_cfg,
                               n_microbatches=args.microbatches)

    def train_step(state, batch):
        with use_ctx(ctx):
            return raw_step(state, batch)

    with _handlers_restored(), _watchdog() as watchdog:
        shutdown = GracefulShutdown()
        losses = []
        t0 = time.time()
        for step_i in range(start_step, args.steps):
            batch = {"tokens": torch.as_tensor(pipe.batch(step_i), device=dev)}
            if cfg.family == "vlm":
                batch["patches"] = torch.zeros(
                    (args.batch, cfg.n_patches, cfg.d_model), device=dev)
            if cfg.family == "audio":
                batch["frames"] = torch.zeros(
                    (args.batch, cfg.encoder_frames, cfg.d_model), device=dev)
            state, metrics = train_step(state, batch)
            watchdog.beat()
            loss = float(metrics["loss"])
            losses.append(loss)
            if step_i % args.log_every == 0 or step_i == args.steps - 1:
                dt = time.time() - t0
                tps = (step_i - start_step + 1) * args.batch * args.seq / max(dt, 1e-9)
                print(f"step {step_i:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"lr {float(metrics['lr']):.2e} tok/s {tps:.0f}", flush=True)
            if args.ckpt_dir and (step_i + 1) % args.ckpt_every == 0:
                ckpt.save_async(args.ckpt_dir, step_i + 1, state, fingerprint)
            if shutdown.requested:
                print("preemption requested: checkpointing and exiting",
                      flush=True)
                if args.ckpt_dir:
                    ckpt.wait_for_saves()
                    ckpt.save(args.ckpt_dir, step_i + 1, state, fingerprint)
                return 0
        if args.ckpt_dir:
            ckpt.wait_for_saves()
            ckpt.save(args.ckpt_dir, args.steps, state, fingerprint)
        first = np.mean(losses[:5]) if len(losses) >= 5 else losses[0]
        last = np.mean(losses[-5:])
        print(f"done: loss {first:.4f} -> {last:.4f} "
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
