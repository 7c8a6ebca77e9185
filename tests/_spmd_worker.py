"""The port's LM sharded over a 2 x 2 ("data", "model") gloo mesh, run by
``tests/test_torch_spmd.py`` in a subprocess:

    python tests/_spmd_worker.py OUT_DIR CASE [CASE ...]

For each case (an architecture's ``SMOKE`` configuration, or a variant of
one, ``arch@name``, either with a ``#switches`` suffix) it reads
``OUT_DIR/{case}_inputs.npz`` (the reference's float32 parameters as
``p/<path>`` arrays, ``tokens`` (B, S + 1) and ``decode`` (B, N) tokens,
``overrides``, the configuration's changed fields as JSON, and optionally
``ctx``, the ``ShardCtx`` switches as JSON (``seq_shard``,
``attn_seq_shard``); a vlm's ``patches`` (B, P, D) and an audio model's
``frames`` (B, T_enc, D), where the case has them), starts four ranks
(``torch.multiprocessing``, spawn), and on each rank runs the train step,
the prefill and ``N`` decode steps with the parameters as DTensors
(``shard_params``, experts over ``model`` where the configuration is
expert-parallel) and the inputs sharded by batch, under
``use_ctx(ShardCtx(mesh, **switches))`` (the decode steps with
``seq_shard`` off, as the reference's dry run decodes); rank 0 also runs
them on plain tensors.
Rank 0 writes ``OUT_DIR/{case}_out.npz``: the sharded (``spmd/...``) and
plain (``plain/...``) loss, grad norm, updated parameters, prefill logits
and each decode step's logits; each decode-cache leaf's placements as text
(``spmd/placements/...``, whisper's cross-attention K/V among them); and for an MoE model the first layer's dispatch
table of the prefill's normed embeddings (``.../table``).
"""
import json
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
    import dataclasses
    import warnings

    from repro_torch.distributed.sharding import (shard_batch, shard_params,
                                                  use_ctx)
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        from repro_torch.serving.decode import decode_step, prefill

    from repro_torch.models.layers import rms_norm
    from repro_torch.models.moe import moe_dispatch_table
    from repro_torch.models.transformer import embed_inputs, layer_params

    tokens = torch.as_tensor(inputs["tokens"]).long()
    decode = torch.as_tensor(inputs["decode"]).long()
    extras = {k: torch.as_tensor(inputs[k]) for k in ("patches", "frames")
              if k in inputs}
    if ctx is not None:
        params = shard_params(params, ctx,
                              expert_parallel=cfg.expert_parallel)
        tokens = shard_batch(tokens, ctx)
        decode = shard_batch(decode, ctx)
        extras = {k: shard_batch(v, ctx) for k, v in extras.items()}
    out = {}
    opt = AdamWConfig(**OPT)
    with use_ctx(ctx):
        state, metrics = make_train_step(cfg, opt)(
            init_train_state(params, opt), {"tokens": tokens, **extras})
        for k in ("loss", "grad_norm"):
            out[k] = _full(metrics[k])
        for path, leaf in _flat(state.params):
            out[f"param/{path}"] = _full(leaf)
        for path, leaf in _flat(state.opt.mu):
            out[f"mu/{path}"] = _full(leaf)
        if cfg.n_experts:
            lp = layer_params(params["layers"], 0)
            h = rms_norm(embed_inputs(params, tokens[:, :-1], cfg),
                         lp["ln2"], cfg.norm_eps)
            out["table"] = _full(moe_dispatch_table(lp["moe"], h, cfg))
        logits, dstate = prefill(params, tokens[:, :-1], cfg, **extras)
        out["prefill"] = _full(logits)
        if ctx is not None:
            out.update(_cache_placements(dstate))
    dec_ctx = None if ctx is None else dataclasses.replace(ctx,
                                                           seq_shard=False)
    with use_ctx(dec_ctx):
        for i in range(decode.shape[1]):
            logits, dstate = decode_step(params, decode[:, i:i + 1], dstate,
                                         cfg)
            out[f"decode/{i}"] = _full(logits)
    return out


def _cache_placements(dstate) -> dict:
    """Each decode-cache leaf's placements, as text, by ``field/leaf``."""
    import dataclasses

    out = {}
    for f in dataclasses.fields(dstate):
        cache = getattr(dstate, f.name)
        if isinstance(cache, torch.Tensor):
            out[f"placements/{f.name}"] = np.array(str(cache.placements))
        if cache is None or isinstance(cache, torch.Tensor):
            continue
        for g in dataclasses.fields(cache):
            t = getattr(cache, g.name)
            if isinstance(t, torch.Tensor) and t.dim() > 1:
                out[f"placements/{f.name}/{g.name}"] = np.array(
                    str(t.placements))
    return out


def _rank(rank: int, out_dir: str, cases: list, store: str):
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.distributed.sharding import ShardCtx
    from repro_torch.launch.mesh import device_mesh, file_process_group
    from repro_torch.models.convert import lm_params_from_numpy

    torch.manual_seed(0)
    with file_process_group("gloo", rank, WORLD, store):
        mesh = device_mesh(MESH, ("data", "model"), "cpu")
        for case in cases:
            with np.load(Path(out_dir) / f"{case}_inputs.npz") as npz:
                arch = case.split("#")[0].split("@")[0]
                cfg = dataclasses.replace(
                    registry.get_smoke_config(arch),
                    dtype="float32", **json.loads(str(npz["overrides"])))
                inputs = {k: npz[k] for k in ("tokens", "decode",
                                              "patches", "frames")
                          if k in npz.files}
                switches = json.loads(str(npz["ctx"])) \
                    if "ctx" in npz.files else {}
                params = lm_params_from_numpy(_unflatten(npz), cfg,
                                              device="cpu")
            got = {f"spmd/{k}": v for k, v in _run(
                params, inputs, cfg,
                ShardCtx(mesh=mesh, **switches)).items()}
            if rank == 0:
                got.update({f"plain/{k}": v for k, v in
                            _run(params, inputs, cfg, None).items()})
                np.savez(Path(out_dir) / f"{case}_out.npz", **got)


def main(argv):
    import torch.multiprocessing as mp

    out_dir, cases = argv[0], argv[1:]
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank, args=(out_dir, cases,
                                        os.path.join(tmp, "store")),
                           nprocs=WORLD, start_method="spawn")


if __name__ == "__main__":
    main(sys.argv[1:])
