"""``repro_torch/configs/mamba2_130m.py`` ↔ ``repro/configs/mamba2_130m.py`` (a copy).

mamba2-130m [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=12, n_kv_heads=12, d_ff=0,
    vocab_size=50_280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    vocab_size=512, ssm_state=16, ssm_head_dim=16, remat=False,
)
