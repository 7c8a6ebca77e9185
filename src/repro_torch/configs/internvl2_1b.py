"""``repro_torch/configs/internvl2_1b.py`` ↔ ``repro/configs/internvl2_1b.py`` (a copy).

internvl2-1b [vlm] — InternViT patch stub + qwen2-style LM backbone.
[arXiv:2404.16821; hf]"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_ff=4864,
    vocab_size=151_655, n_patches=256,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=56, n_heads=7, n_kv_heads=1, d_ff=112,
    vocab_size=512, n_patches=8, remat=False,
)
