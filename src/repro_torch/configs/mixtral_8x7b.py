"""``repro_torch/configs/mixtral_8x7b.py`` ↔ ``repro/configs/mixtral_8x7b.py`` (a copy).

mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14_336,
    vocab_size=32_000,
    n_experts=8, experts_per_token=2, sliding_window=4096,
    expert_parallel=False,   # 8 experts < 16-way model axis -> expert TP
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, n_experts=4, experts_per_token=2, sliding_window=16,
    remat=False, capacity_factor=4.0,
)
