"""``repro_torch/models/config.py`` ↔ ``repro/models/config.py``: a copy of
``ModelConfig`` (pure Python), so that the port imports nothing of the
reference.  It keeps every field, including those of the families the port
does not run yet (ROADMAP Queue 1)."""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ModelConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None  # default d_model // n_heads

    # --- attention pattern -------------------------------------------------
    sliding_window: Optional[int] = None   # SWA width (mixtral, gemma3 local)
    local_global_ratio: int = 0            # gemma3: 5 local : 1 global
    rope_theta: float = 10_000.0

    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: Optional[int] = None         # routed-expert hidden width
    capacity_factor: float = 1.25
    expert_parallel: bool = False          # EP (shard experts) vs expert-TP

    # --- SSM (Mamba2 / SSD) --------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_conv: int = 4
    ssm_groups: int = 1

    # --- hybrid (zamba2): shared attention block every k ssm layers ----------
    attn_every: int = 0

    # --- encoder-decoder (whisper) -------------------------------------------
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_frames: int = 1500             # stub frontend sequence length

    # --- vlm (internvl): stub patch embeddings prepended ---------------------
    n_patches: int = 0

    # --- numerics / compile --------------------------------------------------
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    remat: bool = True
    vocab_pad_to: int = 256
    tie_embeddings: bool = False
    # unroll the layer scan — identical math/HLO semantics, but XLA's cost
    # analysis counts while-loop bodies once; the dry-run compiles an
    # unrolled twin of each cell to obtain trip-count-true FLOPs/bytes.
    scan_unroll: bool = False

    # ------------------------------------------------------------------ props
    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return (self.vocab_size + p - 1) // p * p

    @property
    def d_inner(self) -> int:  # ssm inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing: SSM, hybrid, or pure sliding-window."""
        if self.family in ("ssm", "hybrid"):
            return True
        # pure SWA (no global layers): mixtral
        return self.sliding_window is not None and self.local_global_ratio == 0

    @property
    def has_decode(self) -> bool:
        return True  # all assigned archs have an autoregressive side

    def layer_is_global(self, i: int) -> bool:
        """gemma3-style local:global interleave — every (ratio+1)-th global."""
        if self.local_global_ratio <= 0:
            return self.sliding_window is None
        return (i + 1) % (self.local_global_ratio + 1) == 0

    def layer_is_attn(self, i: int) -> bool:
        """hybrid: which layers run the shared attention block."""
        return self.attn_every > 0 and (i + 1) % self.attn_every == 0

    def param_count(self) -> int:
        """Approximate parameter count (embeddings included)."""
        d, f, v = self.d_model, self.d_ff, self.padded_vocab
        hd, hq, hkv = self.head_dim_, self.n_heads, self.n_kv_heads
        n = v * d * (1 if self.tie_embeddings else 2)
        if self.family in ("ssm", "hybrid"):
            di, ns = self.d_inner, self.ssm_state
            g = self.ssm_groups
            per = (d * (2 * di + 2 * g * ns + self.ssm_heads)
                   + di * d + 3 * self.ssm_heads
                   + self.ssm_conv * (di + 2 * g * ns))
            n += self.n_layers * per
            if self.attn_every:
                n += (d * hd * (hq + 2 * hkv) + hq * hd * d) + 3 * d * f
        else:
            attn = d * hd * (hq + 2 * hkv) + hq * hd * d
            if self.n_experts:
                fe = self.moe_d_ff or f
                mlp = (self.n_experts + self.n_shared_experts) * 3 * d * fe
                mlp += d * self.n_experts  # router
            else:
                mlp = 3 * d * f
            n += self.n_layers * (attn + mlp)
            if self.is_encoder_decoder:
                n += self.n_encoder_layers * (attn + 3 * d * f)
                n += self.n_layers * attn  # cross attention
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed-active experts)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        fe = self.moe_d_ff or self.d_ff
        inactive = (self.n_experts - self.experts_per_token) * 3 * d * fe
        return self.param_count() - self.n_layers * inactive
