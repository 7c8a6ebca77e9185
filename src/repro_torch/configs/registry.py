"""``repro_torch/configs/registry.py`` ↔ ``repro/configs/registry.py``.

Resolves an architecture id to its configuration.  The port runs every
family of the reference: ``ARCH_IDS`` lists the four dense architectures, the
two MoE ones, mamba2-130m, zamba2-1.2b, internvl2-1b and the audio
encoder-decoder whisper-medium, all ten of the reference's ids;
``NOT_PORTED`` is empty.
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
    "whisper-medium": "whisper_medium",
}

ARCH_IDS = tuple(_MODULES)

# the reference's architectures the port does not run: none
NOT_PORTED = ()


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str):
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str):
    return _module(arch_id).SMOKE
