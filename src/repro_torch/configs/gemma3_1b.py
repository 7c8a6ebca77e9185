"""``repro_torch/configs/gemma3_1b.py`` ↔ ``repro/configs/gemma3_1b.py`` (a copy).

gemma3-1b [dense] — 5:1 local:global sliding-window GQA, 262k vocab.
[hf:google/gemma-3-1b-pt; unverified]"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, d_ff=6912,
    vocab_size=262_144, head_dim=256,
    sliding_window=1024, local_global_ratio=5, rope_theta=1_000_000.0,
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
    vocab_size=512, head_dim=16, sliding_window=8, local_global_ratio=2,
    remat=False,
)
