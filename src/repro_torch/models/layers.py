"""``repro_torch/models/layers.py`` ↔ ``repro/models/layers.py``.

Common neural layers: RMSNorm, RoPE, the gated MLP and the initializers.
Parameters are dicts of tensors stored in float32 and cast to the compute
dtype (``cfg.dtype``) at use, as in the reference.  Random init draws from
an explicit ``torch.Generator``; it does not give the reference's
``jax.random`` numbers (tests carry the reference's weights across with
``models.convert.lm_params_from_numpy``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import gather_seq

__all__ = ["Dtypes", "dense_init", "mlp_apply", "mlp_init", "rms_norm",
           "rope"]


class Dtypes:
    @staticmethod
    def compute(cfg) -> torch.dtype:
        return getattr(torch, cfg.dtype)


def truncated_normal(shape, generator: torch.Generator, device,
                     lo: float = -2.0, hi: float = 2.0) -> torch.Tensor:
    """Standard normal truncated to ``[lo, hi]``, float32, by the inverse CDF
    (the method of ``jax.random.truncated_normal``)."""
    cdf_lo = 0.5 * (1.0 + math.erf(lo / math.sqrt(2.0)))
    cdf_hi = 0.5 * (1.0 + math.erf(hi / math.sqrt(2.0)))
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    u = cdf_lo + u * (cdf_hi - cdf_lo)
    z = math.sqrt(2.0) * torch.special.erfinv(2.0 * u - 1.0)
    return z.clamp_(lo, hi)


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               scale: float | None = None, *, device) -> torch.Tensor:
    """Truncated-normal fan-in init, stored f32."""
    s = scale if scale is not None else d_in ** -0.5
    return truncated_normal((d_in, d_out), generator, device).mul_(s)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in f32 for stability, cast back to the input dtype."""
    x32 = x.to(torch.float32)
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + gamma.to(torch.float32))
    return out.to(x.dtype)


def rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
         theta: float):
    """Rotary embeddings, half-split rotation.  q: (B,S,Hq,D), k: (B,S,Hk,D),
    positions: (B,S)."""
    half = q.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=q.device) / half)
    ang = positions[..., None].to(torch.float32) * freq        # (B,S,half)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]

    def rot(x):
        x1, x2 = x[..., :half], x[..., half:]
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
        return out.to(x.dtype)

    return rot(q), rot(k)


def mlp_init(generator: torch.Generator, d_model: int, d_ff: int, *,
             device) -> dict:
    return {
        "w_gate": dense_init(generator, d_model, d_ff, device=device),
        "w_up": dense_init(generator, d_model, d_ff, device=device),
        "w_down": dense_init(generator, d_ff, d_model, scale=d_ff ** -0.5,
                             device=device),
    }


def mlp_apply(params: dict, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Gated SiLU MLP (llama-style); a sequence-sharded ``x`` is gathered
    first (``sharding.gather_seq``)."""
    x = gather_seq(x)
    wg = params["w_gate"].to(compute_dtype)
    wu = params["w_up"].to(compute_dtype)
    wd = params["w_down"].to(compute_dtype)
    return (F.silu(x @ wg) * (x @ wu)) @ wd
