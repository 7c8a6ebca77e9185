"""``repro_torch/kernels/block_combine``: the VDT walk's block combine over a
CSR of the active blocks sorted by data node (CUDA kernel + plain-torch
version); it replaces no Pallas kernel of ``repro``."""
from repro_torch.kernels.block_combine.ops import (CHUNK, BlockCsr,
                                                   block_combine, block_csr)
from repro_torch.kernels.block_combine.ref import block_combine_plain

__all__ = ["CHUNK", "BlockCsr", "block_combine", "block_combine_plain",
           "block_csr"]
