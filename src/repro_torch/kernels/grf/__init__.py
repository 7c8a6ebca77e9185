"""``repro_torch/kernels/grf`` ↔ ``repro/kernels/grf``: K5, the GRF
walker-mean feature product (CUDA kernel + plain-torch version), the
terminating random walks, and the dense oracles."""
from repro_torch.kernels.grf.grf import grf_feature_plain
from repro_torch.kernels.grf.ops import grf_feature_matvec
from repro_torch.kernels.grf.ref import (dense_lp_ref, dense_power_action_ref,
                                         grf_feature_matvec_ref)
from repro_torch.kernels.grf.walkers import (default_draw, sample_walks,
                                             walk_step)

__all__ = ["default_draw", "dense_lp_ref", "dense_power_action_ref",
           "grf_feature_matvec", "grf_feature_matvec_ref",
           "grf_feature_plain", "sample_walks", "walk_step"]
