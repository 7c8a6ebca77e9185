"""``repro_torch/configs/whisper_medium.py`` ↔ ``repro/configs/whisper_medium.py`` (a copy).

whisper-medium [audio] — enc-dec backbone; conv/mel frontend is a stub
(input_specs provides precomputed frame embeddings). [arXiv:2212.04356]"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab_size=51_865,
    is_encoder_decoder=True, n_encoder_layers=24, encoder_frames=1500,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=512, n_encoder_layers=2, encoder_frames=16, remat=False,
)
