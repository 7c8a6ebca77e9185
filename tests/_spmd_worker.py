"""The port's dense LM sharded over a 2 x 2 ("data", "model") gloo mesh, run
by ``tests/test_torch_spmd.py`` in a subprocess:

    python tests/_spmd_worker.py OUT_DIR ARCH [ARCH ...]

For each architecture it reads ``OUT_DIR/{arch}_inputs.npz`` (the
reference's float32 parameters as ``p/<path>`` arrays, ``tokens`` (B, S + 1)
and ``decode`` (B, N) tokens), starts four ranks (``torch.multiprocessing``,
spawn), and on each rank runs the train step, the prefill and ``N`` decode
steps with the parameters as DTensors (``shard_params``) and the inputs
sharded by batch, under ``use_ctx(ShardCtx(mesh))``; rank 0 also runs them
on plain tensors.  Rank 0 writes ``OUT_DIR/{arch}_out.npz``: the sharded
(``spmd/...``) and plain (``plain/...``) loss, grad norm, updated
parameters, prefill logits and each decode step's logits, and the K/V
cache's placements as text.
"""
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

SRC = Path(__file__).resolve().parents[1] / "src"
sys.path.insert(0, str(SRC))

WORLD, MESH = 4, (2, 2)
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-4)


def _unflatten(npz) -> dict:
    tree = {}
    for key in npz.files:
        if not key.startswith("p/"):
            continue
        node, parts = tree, key[2:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = npz[key]
    return tree


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def _full(t):
    from repro_torch._device import is_dtensor

    t = t.full_tensor() if is_dtensor(t) else t
    return t.detach().float().numpy()


def _run(params, inputs, cfg, ctx):
    """Train step, prefill and decode steps; numpy results by name."""
    import warnings

    from repro_torch.distributed.sharding import (shard_batch, shard_params,
                                                  use_ctx)
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        from repro_torch.serving.decode import decode_step, prefill

    tokens = torch.as_tensor(inputs["tokens"]).long()
    decode = torch.as_tensor(inputs["decode"]).long()
    if ctx is not None:
        params = shard_params(params, ctx)
        tokens = shard_batch(tokens, ctx)
        decode = shard_batch(decode, ctx)
    out = {}
    opt = AdamWConfig(**OPT)
    with use_ctx(ctx):
        state, metrics = make_train_step(cfg, opt)(
            init_train_state(params, opt), {"tokens": tokens})
        for k in ("loss", "grad_norm"):
            out[k] = _full(metrics[k])
        for path, leaf in _flat(state.params):
            out[f"param/{path}"] = _full(leaf)
        for path, leaf in _flat(state.opt.mu):
            out[f"mu/{path}"] = _full(leaf)
        logits, dstate = prefill(params, tokens[:, :-1], cfg)
        out["prefill"] = _full(logits)
        if ctx is not None:
            out["cache_placements"] = np.array(str(dstate.kv.k.placements))
        for i in range(decode.shape[1]):
            logits, dstate = decode_step(params, decode[:, i:i + 1], dstate,
                                         cfg)
            out[f"decode/{i}"] = _full(logits)
    return out


def _rank(rank: int, out_dir: str, archs: list, store: str):
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.distributed.sharding import ShardCtx
    from repro_torch.launch.mesh import device_mesh, file_process_group
    from repro_torch.models.convert import lm_params_from_numpy

    torch.manual_seed(0)
    with file_process_group("gloo", rank, WORLD, store):
        mesh = device_mesh(MESH, ("data", "model"), "cpu")
        for arch in archs:
            cfg = dataclasses.replace(registry.get_smoke_config(arch),
                                      dtype="float32")
            with np.load(Path(out_dir) / f"{arch}_inputs.npz") as npz:
                inputs = {k: npz[k] for k in ("tokens", "decode")}
                params = lm_params_from_numpy(_unflatten(npz), cfg,
                                              device="cpu")
            got = {f"spmd/{k}": v for k, v in
                   _run(params, inputs, cfg, ShardCtx(mesh=mesh)).items()}
            if rank == 0:
                got.update({f"plain/{k}": v for k, v in
                            _run(params, inputs, cfg, None).items()})
                np.savez(Path(out_dir) / f"{arch}_out.npz", **got)


def main(argv):
    import torch.multiprocessing as mp

    out_dir, archs = argv[0], argv[1:]
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank, args=(out_dir, archs,
                                        os.path.join(tmp, "store")),
                           nprocs=WORLD, start_method="spawn")


if __name__ == "__main__":
    main(sys.argv[1:])
