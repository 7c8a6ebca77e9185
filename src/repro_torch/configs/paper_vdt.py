"""``repro_torch/configs/paper_vdt.py`` ↔ ``repro/configs/paper_vdt.py``.

paper-vdt — the paper's own workload as a dry-run cell: distributed
Label-Propagation step over a variational dual-tree transition matrix.

N = 2^18 points (~ half the Table-2 'alpha' run), C = 8 classes, |B| = 4N blocks
(the paper's kNN-equivalence point k = |B|/N = 4).  The reference names the
cell ``lp_1m``; the port keeps the id, though N is 2^18.
"""
from repro_torch.core.distributed import vdt_input_specs

NAME = "paper-vdt"
N_POINTS = 1 << 18
N_CLASSES = 8
BLOCKS_PER_POINT = 4
ALPHA = 0.01


def input_specs():
    return vdt_input_specs(N_POINTS, N_CLASSES, BLOCKS_PER_POINT)
