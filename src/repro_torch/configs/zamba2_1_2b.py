"""``repro_torch/configs/zamba2_1_2b.py`` ↔ ``repro/configs/zamba2_1_2b.py`` (a copy).

zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; hf]"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab_size=32_000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, attn_every=6,
    sliding_window=4096,   # shared block runs SWA (long-context safe)
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=512, ssm_state=16, ssm_head_dim=16, attn_every=2,
    sliding_window=16, remat=False,
)
