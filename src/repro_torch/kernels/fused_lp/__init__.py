"""``repro_torch/kernels/fused_lp`` ↔ ``repro/kernels/fused_lp``: the exact
transition matrix applied in one fused pass.  K1 (the folded eq.-15 step),
K2 (``P @ Y``) and K3 (the per-batch-recompute step) are CUDA kernels, each
beside its plain-torch version, with the reference's ops, scans and dense
oracles around them."""
from repro_torch.kernels.fused_lp.batched import (alpha_row, folded_step_plain,
                                                  step_batched_perbatch_plain)
from repro_torch.kernels.fused_lp.fused_lp import (NEG_BIG, matvec_plain,
                                                   stream_tile_update)
from repro_torch.kernels.fused_lp.ops import (folded_step, fused_lp_matvec,
                                              fused_lp_matvec_batched,
                                              fused_lp_scan_batched,
                                              fused_lp_scan_batched_resume,
                                              fused_lp_scan_folded,
                                              fused_lp_scan_folded_resume,
                                              fused_lp_step_batched,
                                              fused_lp_step_folded,
                                              kernel_library, matvec_step,
                                              perbatch_step)
from repro_torch.kernels.fused_lp.ref import (dense_transition_ref,
                                              fused_lp_scan_batched_ref)

__all__ = ["NEG_BIG", "alpha_row", "dense_transition_ref", "folded_step",
           "folded_step_plain", "fused_lp_matvec", "fused_lp_matvec_batched",
           "fused_lp_scan_batched", "fused_lp_scan_batched_ref",
           "fused_lp_scan_batched_resume", "fused_lp_scan_folded",
           "fused_lp_scan_folded_resume", "fused_lp_step_batched",
           "fused_lp_step_folded", "kernel_library", "matvec_plain",
           "matvec_step", "perbatch_step", "step_batched_perbatch_plain",
           "stream_tile_update"]
