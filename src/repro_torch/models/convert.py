"""``repro_torch/models/convert.py`` (new): the reference's LM parameters
carried across.

:func:`lm_params_from_numpy` takes the pytree of the reference's ``init_lm``
as numpy arrays (layers stacked on axis 0, as its ``jax.vmap`` init leaves
them; an MoE layer's ``router``, its experts' ``w_gate``/``w_up``/``w_down``
as ``(L, E, ., .)`` and its ``shared`` experts; an SSM or hybrid layer's
``ln`` and ``ssm``; a hybrid's unstacked ``shared_attn``), or the tree of
the reference's ``init_encdec`` for the audio family (``enc_pos``,
``enc_final_ln``, the stacked ``enc_layers``, the decoder layers' ``ln_x``
and ``xattn``), and returns the port's parameters, so that both packages
compute with the same weights.  Every key and shape is checked against
``lm_param_shapes`` or ``whisper.encdec_param_shapes``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.models.transformer import lm_param_shapes
from repro_torch.models.whisper import encdec_param_shapes

__all__ = ["lm_params_from_numpy"]


def lm_params_from_numpy(params: dict, cfg, *, device) -> dict:
    """The port's float32 parameters on ``device`` from the reference's."""
    dev = resolve_device(device)

    def convert(tree, shapes, path):
        if set(tree) != set(shapes):
            raise KeyError(f"parameters{path}: keys {sorted(tree)} are not "
                           f"{sorted(shapes)}")
        out = {}
        for key, shape in shapes.items():
            if isinstance(shape, dict):
                out[key] = convert(tree[key], shape, f"{path}[{key!r}]")
                continue
            a = np.array(tree[key], np.float32)  # a writable copy
            if a.shape != tuple(shape):
                raise ValueError(f"parameters{path}[{key!r}] has shape "
                                 f"{a.shape}, {cfg.name} wants {shape}")
            out[key] = torch.as_tensor(a, device=dev)
        return out

    shapes = (encdec_param_shapes(cfg) if cfg.family == "audio" else
              lm_param_shapes(cfg))
    return convert(params, shapes, "")
