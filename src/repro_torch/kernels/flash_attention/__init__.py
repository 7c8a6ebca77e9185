"""``repro_torch/kernels/flash_attention`` ↔ ``repro/kernels/flash_attention``:
K6, causal / sliding-window GQA attention (two CUDA kernels + the
plain-torch tile walk), and the naive oracle."""
from repro_torch.kernels.flash_attention.flash_attention import (
    KV_TILE, flash_attention_plain)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

__all__ = ["KV_TILE", "flash_attention", "flash_attention_plain",
           "flash_attention_ref"]
