"""``repro_torch/configs/shapes.py`` ↔ ``repro/configs/shapes.py``.

Assigned input-shape sets and input stand-ins per cell.

Shapes (LM family — seq_len x global_batch):
  train_4k     seq=4096    batch=256   -> train_step
  prefill_32k  seq=32768   batch=32    -> serve prefill
  decode_32k   seq=32768   batch=128   -> serve_step (1 token, cache=seq)
  long_500k    seq=524288  batch=1     -> serve_step; requires sub-quadratic
                                          sequence mixing (SSM/hybrid/SWA)

The reference's stand-ins are ``jax.ShapeDtypeStruct``s; the port's are
tensors on ``device``, by default ``meta``: shapes and types without
storage, on which the dry run counts a step's work.  ``meta`` stands for a
shape here, not for a device that computes; a caller that runs the cell
passes ``"cuda"`` (the tensors are then empty: fill them before use).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["SHAPES", "ShapeSpec", "input_specs", "cell_is_applicable"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def cell_is_applicable(cfg, shape: ShapeSpec) -> tuple[bool, str]:
    """long_500k requires sub-quadratic attention (DESIGN.md §5)."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, (
            f"{cfg.name} is a full-attention arch; 500k decode requires "
            "sub-quadratic sequence mixing — skipped per assignment rules"
        )
    return True, ""


def input_specs(cfg, shape: ShapeSpec, batch_override: Optional[int] = None,
                device="meta"):
    """Stand-ins on ``device`` for every model input of this cell.

    Returns (kwargs dict for the step function, metadata).  Frontends for
    vlm/audio are stubs: precomputed patch/frame embeddings.
    """
    b = batch_override or shape.global_batch
    s = shape.seq_len
    dev = torch.device(device)

    def spec(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device=dev)

    extras = {}
    if cfg.family == "vlm":
        text = s - cfg.n_patches
        extras["patches"] = spec((b, cfg.n_patches, cfg.d_model),
                                 torch.float32)
    else:
        text = s
    if cfg.family == "audio":
        extras["frames"] = spec((b, cfg.encoder_frames, cfg.d_model),
                                torch.float32)

    if shape.kind == "train":
        batch = {"tokens": spec((b, text + 1), torch.int32), **extras}
        return {"batch": batch}, {"tokens_per_step": b * s}
    if shape.kind == "prefill":
        return ({"tokens": spec((b, text), torch.int32), **extras},
                {"tokens_per_step": b * s})
    # decode: one token against a cache of length s
    from repro_torch.serving.decode import DECODE_SLACK, init_state

    state = init_state(cfg, b, s + DECODE_SLACK, device=dev)
    return ({"token": spec((b, 1), torch.int32), "state": state},
            {"tokens_per_step": b})
