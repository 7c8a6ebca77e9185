"""``repro_torch/configs/deepseek_moe_16b.py`` ↔ ``repro/configs/deepseek_moe_16b.py`` (a copy).

deepseek-moe-16b [moe] — 2 shared + 64 routed experts, top-6,
fine-grained; expert-parallel. [arXiv:2401.06066; hf]"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab_size=102_400,
    n_experts=64, n_shared_experts=2, experts_per_token=6, moe_d_ff=1408,
    expert_parallel=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=32,
    vocab_size=512, n_experts=8, n_shared_experts=1, experts_per_token=2,
    moe_d_ff=32, remat=False, capacity_factor=8.0,
)
