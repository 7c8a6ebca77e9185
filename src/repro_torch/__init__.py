"""``repro_torch`` ↔ ``repro``: the PyTorch/CUDA port of the variational
dual-tree transition-matrix approximation, for an NVIDIA H100.

The JAX package ``repro`` is the reference; this package never imports it or
JAX.  Its layout mirrors ``src/repro/`` file for file and each module names
its reference.

Device: entry points (``VariationalDualTree.fit`` and everything that reads a
model's device) run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card they raise instead of falling back (``_device.py``).

Precision: float32 throughout, as in the reference.  Resolving a device sets
``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False``, and the hand-written K1 kernel
(``kernels/fused_lp/csrc/folded_lp.cu``) uses plain FP32 FMA: the distance
cross-term ``|x|^2 + |y|^2 - 2 x.y`` cannot take TF32's rounding.
"""
from repro_torch.core.convert import vdt_from_numpy
from repro_torch.core.label_prop import ccr, one_hot_labels
from repro_torch.core.vdt import VariationalDualTree, VdtStats

__all__ = ["VariationalDualTree", "VdtStats", "ccr", "one_hot_labels",
           "vdt_from_numpy"]
