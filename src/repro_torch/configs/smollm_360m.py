"""``repro_torch/configs/smollm_360m.py`` ↔ ``repro/configs/smollm_360m.py`` (a copy).

smollm-360m [dense] — llama-arch small, GQA kv=5.
[hf:HuggingFaceTB/SmolLM-360M; hf]"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, d_ff=2560,
    vocab_size=49_152,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=60, n_heads=3, n_kv_heads=1, d_ff=128,
    vocab_size=512, remat=False,
)
