"""``repro_torch/configs/registry.py`` ↔ ``repro/configs/registry.py``.

Resolves an architecture id to its configuration.  The port runs the dense,
MoE, SSM, hybrid and vlm families: ``ARCH_IDS`` lists the four dense
architectures, the two MoE ones, mamba2-130m, zamba2-1.2b and internvl2-1b;
the audio id the reference knows (whisper-medium) raises
``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

import importlib

__all__ = ["ARCH_IDS", "NOT_PORTED", "get_config", "get_smoke_config"]

_MODULES = {
    "gemma3-1b": "gemma3_1b",
    "internlm2-1.8b": "internlm2_1_8b",
    "glm4-9b": "glm4_9b",
    "smollm-360m": "smollm_360m",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "mixtral-8x7b": "mixtral_8x7b",
    "mamba2-130m": "mamba2_130m",
    "zamba2-1.2b": "zamba2_1_2b",
    "internvl2-1b": "internvl2_1b",
}

ARCH_IDS = tuple(_MODULES)

# the reference's other architecture: audio
NOT_PORTED = ("whisper-medium",)


def _module(arch_id: str):
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"{arch_id!r} is not ported yet: the port runs the architectures "
            f"{sorted(_MODULES)}; the audio family is ROADMAP Queue 1 item "
            "12e")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str):
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str):
    return _module(arch_id).SMOKE
