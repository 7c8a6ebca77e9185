"""``repro_torch/kernels/pairwise`` ↔ ``repro/kernels/pairwise``: K4, tiled
pairwise squared distances (CUDA kernel + plain-torch version) and the
direct-difference oracle."""
from repro_torch.kernels.pairwise.ops import pairwise_sq_dists
from repro_torch.kernels.pairwise.pairwise import pairwise_sq_dists_plain
from repro_torch.kernels.pairwise.ref import pairwise_sq_dists_ref

__all__ = ["pairwise_sq_dists", "pairwise_sq_dists_plain",
           "pairwise_sq_dists_ref"]
