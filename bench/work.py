"""Work counts of label propagation and the H100's peaks, the yardstick that
the roofline shares (``k1_roofline``, ``serve_mfu``) are priced with.

Counts come from the algorithm's shapes only: N points of d features, |B|
active blocks, the real label columns of the requests (never the padding an
engine adds) and the iterations.  Each count is a lower bound that no
correct implementation undercuts, so a share can never pass 100 % because
an implementation fuses, reorders or keeps something:

* every input byte is read once and every output byte written once, per
  call, whatever an implementation reads again;
* FLOPs are priced at the fastest rate that computes them exactly enough:
  TF32 on the tensor cores (no float32-accurate product on this card is
  faster), and int8 where the points are small integers under the squared
  Euclidean distance (SecStr's 0/1 features give exact distances on the
  int8 tensor cores); a ``kl`` or ``itakura_saito`` cross term multiplies
  x by log x or 1 / x, which no int8 product computes, so it takes TF32;
* a walk over the exact matrix (eq. 3) must, every iteration, either compute
  the N^2 distances from the points or read them back, at one byte a pair at
  the least; :func:`exact_pairs_seconds` prices the cheapest mix of the two.

The peaks are NVIDIA's H100 SXM data sheet (dense, at the 700 W limit), as
``repro_torch/launch/roofline.py::HW`` has them, copied so that a program
change cannot move them.
"""
from __future__ import annotations

import dataclasses

__all__ = ["F32", "HBM_BYTES_PER_S", "PEAK_OPS", "Work", "exact_distances",
           "exact_pairs_seconds", "exact_product", "vdt_blocks",
           "vdt_columns"]

PEAK_OPS = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12
F32 = 4          # bytes of a float32 label, point coordinate or q
INDEX = 4        # bytes of a node id (|nodes| < 2^31)


@dataclasses.dataclass(frozen=True)
class Work:
    """Operations by the peak they run at, and HBM bytes."""

    ops: tuple = ()          # ((peak name, count), ...)
    bytes: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        ops = dict(self.ops)
        for k, v in other.ops:
            ops[k] = ops.get(k, 0.0) + v
        return Work(tuple(sorted(ops.items())), self.bytes + other.bytes)

    def __mul__(self, times: float) -> "Work":
        return Work(tuple((k, v * times) for k, v in self.ops),
                    self.bytes * times)

    __rmul__ = __mul__

    def seconds(self) -> float:
        """The least time on one H100: the operations, which share the
        tensor cores, at their peaks, or the bytes at HBM bandwidth,
        whichever is longer."""
        compute = sum(v / PEAK_OPS[k] for k, v in self.ops)
        return max(compute, self.bytes / HBM_BYTES_PER_S)


def exact_distances(n: int, d: int, integer_points: bool) -> Work:
    """The N^2 squared distances of eq. 3 from the points: 2·N²·d operations
    (the cross term; the norms are O(N·d)), the points read once."""
    return Work(((("int8" if integer_points else "tf32"), 2.0 * n * n * d),),
                F32 * n * d)


def exact_product(n: int, columns: int) -> Work:
    """``P @ Y`` of one eq.-15 step over ``columns`` label columns: 2·N²·K
    operations; Y and Y0 read, the new Y written."""
    return Work((("tf32", 2.0 * n * n * columns),), 3.0 * F32 * n * columns)


def exact_pairs_seconds(n: int, d: int, integer_points: bool,
                        steps: int) -> float:
    """Least time for ``steps`` eq.-15 steps' worth of transition entries.

    Each step either computes the pairs (c seconds, tensor cores) or reads
    them back (b seconds at one byte a pair, HBM).  With m of M steps
    computing, the time is at least max(m·c, (M - m)·b), which is smallest,
    M·b·c / (b + c), where both sides are equal.
    """
    c = exact_distances(n, d, integer_points).seconds()
    b = n * n / HBM_BYTES_PER_S
    return steps * b * c / (b + c)


def vdt_blocks(n_blocks: int) -> Work:
    """The block list of one VDT step: two node ids and q a block, read."""
    return Work((), n_blocks * (2 * INDEX + F32))


def vdt_columns(n: int, n_blocks: int, columns: int) -> Work:
    """One VDT step's per-column work: a multiply-add a block and column
    (q_AB · T_B), and Y and Y0 read and the new Y written, N rows each."""
    return Work((("tf32", 2.0 * n_blocks * columns),),
                3.0 * F32 * n * columns)
