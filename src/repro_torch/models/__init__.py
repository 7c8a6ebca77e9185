"""``repro_torch/models`` ↔ ``repro/models``: the decoder-only LMs of the
dense, MoE, SSM, hybrid and vlm families (configuration, layers, attention
through K6, the MoE layer, the Mamba2 SSD block, the transformer stack), the
audio family's encoder-decoder (whisper) and the conversion of the
reference's parameters."""
from repro_torch.models.attention import (KVCache, attn_apply, attn_decode,
                                          attn_init, init_cache)
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.models.ssm import (SSMCache, init_ssm_cache, ssm_apply,
                                    ssm_decode, ssm_init)
from repro_torch.models.transformer import (HUGE_WINDOW, init_lm,
                                            layer_windows, lm_forward)
from repro_torch.models.whisper import (decoder_forward, encdec_forward,
                                        encoder_forward, init_encdec)

__all__ = ["HUGE_WINDOW", "KVCache", "ModelConfig", "SSMCache", "attn_apply",
           "attn_decode", "attn_init", "decoder_forward", "encdec_forward",
           "encoder_forward", "init_cache", "init_encdec", "init_lm",
           "init_ssm_cache", "layer_windows", "lm_forward",
           "lm_params_from_numpy", "ssm_apply", "ssm_decode", "ssm_init"]
