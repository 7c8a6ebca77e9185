"""``repro_torch/launch/roofline.py`` ↔ ``repro/launch/roofline.py``.

Roofline terms of one step from its counted work:

    compute term    = FLOPs / (chips * peak FLOP/s)
    memory term     = bytes / (chips * HBM bandwidth)
    collective term = collective bytes / (chips * link bandwidth)

The reference reads FLOPs and bytes from XLA's ``compiled.cost_analysis()``
and collective bytes from the optimized HLO text, at TPU v5e constants.
PyTorch eager has no compiled program: the port counts FLOPs and bytes by
running the step on ``meta`` tensors (``launch/dryrun.py::count_work``) and
prices them at the NVIDIA H100 SXM's constants (:class:`HW`).  One process
drives one card, so there are no collectives to count: ``collective_bytes``
(an HLO parser) is not ported and ``coll_bytes`` is 0.

:func:`bound` is the yardstick ``chip_smoke.py`` holds every kernel's time
against, so the smoke and the dry run share one.  A kernel's own work (K6's
unmasked pairs: ``kernels/flash_attention/flash_attention.py::
attention_work``) is counted beside the kernel; this module only prices it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

__all__ = ["HW", "roofline_terms", "Roofline"]


class HW:
    """NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit."""
    PEAK_FLOPS = 989e12        # bf16 on the tensor cores
    PEAK_TF32_FLOPS = 495e12   # TF32 on the tensor cores
    PEAK_FP32_FLOPS = 67e12    # float32 outside the tensor cores
    HBM_BW = 3.35e12           # bytes/s
    # NVLink 4: 18 links x 25 GB/s each way; the rate out of one card
    LINK_BW = 450e9


@dataclasses.dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    coll_bytes: float
    n_chips: int
    tokens_per_step: int = 0
    model_flops: float = 0.0

    @property
    def t_compute(self) -> float:
        return self.flops / (self.n_chips * HW.PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / (self.n_chips * HW.HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / (self.n_chips * HW.LINK_BW)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Optimistic perfectly-overlapped step time: max of the terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline step time."""
        if self.model_flops and self.step_time > 0:
            return self.model_flops / (
                self.n_chips * HW.PEAK_FLOPS * self.step_time)
        return 0.0

    @property
    def useful_flops_frac(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes,
            "n_chips": self.n_chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "step_time_s": self.step_time,
            "model_flops": self.model_flops,
            "useful_flops_frac": self.useful_flops_frac,
            "mfu_at_roofline": self.mfu,
            "tokens_per_step": self.tokens_per_step,
        }


def roofline_terms(cost: dict, coll: Dict[str, int], n_chips: int,
                   model_flops: float = 0.0,
                   tokens_per_step: int = 0) -> Roofline:
    """``cost``: ``{"flops", "bytes accessed"}`` of the whole step (all
    chips); ``coll``: ``{"total": bytes}`` or ``{}``."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    return Roofline(
        flops=flops, hbm_bytes=byts, coll_bytes=float(coll.get("total", 0)),
        n_chips=n_chips, model_flops=model_flops,
        tokens_per_step=tokens_per_step,
    )


def bound(flops: float, nbytes: float,
          peak: float = HW.PEAK_FP32_FLOPS) -> tuple[float, str]:
    """Least time on one card in ms for ``flops`` at ``peak`` and ``nbytes``
    at the HBM rate, and what sets it (``"operations"`` or ``"bytes"``)."""
    t_ops, t_bytes = flops / peak, nbytes / HW.HBM_BW
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes \
        else "bytes"
