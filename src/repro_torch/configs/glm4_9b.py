"""``repro_torch/configs/glm4_9b.py`` ↔ ``repro/configs/glm4_9b.py`` (a copy).

glm4-9b [dense] — RoPE, GQA kv=2. [hf:THUDM/glm-4-9b; hf]"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2, d_ff=13_696,
    vocab_size=151_552,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, remat=False,
)
