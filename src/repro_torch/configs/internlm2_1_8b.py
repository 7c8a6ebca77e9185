"""``repro_torch/configs/internlm2_1_8b.py`` ↔ ``repro/configs/internlm2_1_8b.py`` (a copy).

internlm2-1.8b [dense] — GQA kv=8. [arXiv:2403.17297; hf]"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b", family="dense",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, d_ff=8192,
    vocab_size=92_544,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, remat=False,
)
