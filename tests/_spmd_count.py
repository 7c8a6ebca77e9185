"""The port's sharded train step of a ``test_torch_spmd.py`` case counted
per device on meta tensors under a fake process group of a 2 x 2 ("data",
"model") mesh: its collectives by kind (``launch/roofline.py``'s
``collective_bytes`` of ``launch/dryrun.py::count_sharded``'s records).
Imports nothing of JAX, so the card's tests count with it too."""
import dataclasses

import torch
from test_torch_spmd import OPT, OVERRIDES
from torch.distributed.tensor import distribute_tensor

from repro_torch.configs import registry
from repro_torch.distributed.sharding import (ShardCtx, placements,
                                              shard_params, use_ctx)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import device_mesh, fake_process_group
from repro_torch.launch.roofline import collective_bytes
from repro_torch.models.transformer import init_lm
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import init_train_state, make_train_step


def step_fn(case, shape, remat=False):
    """``(fn, state, tokens)`` of the port's float32 step (AdamW) of
    ``case``'s SMOKE configuration at ``shape`` = (B, S) on a 2 x 2 mesh of
    a fake group of 4 (to be called inside one), on meta."""
    mesh = device_mesh((2, 2), ("data", "model"), "cuda")
    cfg = dataclasses.replace(registry.get_smoke_config(case.split("@")[0]),
                              dtype="float32", remat=remat,
                              **OVERRIDES.get(case, {}))
    ctx = ShardCtx(mesh=mesh)
    params = shard_params(init_lm(cfg, 0, device="meta"), ctx,
                          expert_parallel=cfg.expert_parallel)
    opt = AdamWConfig(**OPT)
    tokens = distribute_tensor(
        torch.empty((shape[0], shape[1] + 1), dtype=torch.int64,
                    device="meta"), mesh, placements(("data", None), mesh),
        src_data_rank=None)
    step = make_train_step(cfg, opt)

    def fn(state, tokens):
        with use_ctx(ctx):
            return step(state, {"tokens": tokens})

    return fn, init_train_state(params, opt), tokens


def port_bytes(case, shape, remat=False) -> dict:
    """``collective_bytes`` of one device's collectives in the step."""
    with fake_process_group(4):
        fn, *args = step_fn(case, shape, remat)
        return collective_bytes(dryrun.count_sharded(fn, *args).collectives)
