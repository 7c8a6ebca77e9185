"""``repro_torch/kernels/fused_lp`` ↔ ``repro/kernels/fused_lp``: K1, the fused
exact label-propagation step (CUDA kernel + plain-torch version), its scans
and dense oracles."""
from repro_torch.kernels.fused_lp.batched import alpha_row, folded_step_plain
from repro_torch.kernels.fused_lp.fused_lp import NEG_BIG, stream_tile_update
from repro_torch.kernels.fused_lp.ops import (folded_step,
                                              fused_lp_scan_batched,
                                              fused_lp_scan_batched_resume,
                                              fused_lp_scan_folded,
                                              fused_lp_scan_folded_resume,
                                              kernel_library)
from repro_torch.kernels.fused_lp.ref import (dense_transition_ref,
                                              fused_lp_scan_batched_ref)

__all__ = ["NEG_BIG", "alpha_row", "dense_transition_ref", "folded_step",
           "folded_step_plain", "fused_lp_scan_batched",
           "fused_lp_scan_batched_ref", "fused_lp_scan_batched_resume",
           "fused_lp_scan_folded", "fused_lp_scan_folded_resume",
           "kernel_library", "stream_tile_update"]
