"""The VDT walk's block combine on the card (no counterpart in ``repro``).

:func:`block_csr` lays a fitted partition's active blocks out as a CSR sorted
by their data node, once per fitted tree, with the work items the kernel
takes.  :func:`block_combine` is the wrapper of the hand-written CUDA kernel
``csrc/block_combine.cu``,

    c_node[n, :] = sum over the blocks k of row n of q[k] * t[b[k], :],

which launches the kernel on CUDA tensors, counting each call in
``block_combine.launches``, and runs the plain version
``ref.block_combine_plain`` on CPU tensors.  The reference's counterpart is
``segment_sum`` over every capacity slot (``repro/core/matvec.py``).
"""
from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path

import torch

from repro_torch.kernels._build import (check_operand, launch, load_library,
                                        on_card)
from repro_torch.kernels.block_combine.ref import block_combine_plain

__all__ = ["CHUNK", "KERNEL_SOURCE", "BlockCsr", "block_combine", "block_csr",
           "kernel_library"]

KERNEL_SOURCE = Path(__file__).resolve().parent / "csrc" / "block_combine.cu"

# blocks one warp sums at most: a longer row is cut into chunks whose partial
# rows a second pass adds in a fixed order, so a shallow node that holds
# thousands of blocks does not hold up one warp for the whole launch
CHUNK = 32


@dataclasses.dataclass(frozen=True)
class BlockCsr:
    """The active blocks sorted by data node, and the kernel's work items.

    Row ``n`` is blocks ``row_ptr[n] .. row_ptr[n + 1] - 1``, in slot order;
    ``b`` (int32) and ``q`` (float32) are their kernel node ids and weights.
    Item ``i`` sums blocks ``item_ptr[i] .. item_ptr[i + 1] - 1`` (at most
    :data:`CHUNK`) of row ``item_row[i]``, into that row of the output when
    ``item_part[i]`` is -1, else into partial row ``item_part[i]``; output
    row ``fin_row[r]`` is partial rows ``fin_ptr[r] .. fin_ptr[r + 1] - 1``
    added in a fixed order.  Every index is int32.
    """

    row_ptr: torch.Tensor
    b: torch.Tensor
    q: torch.Tensor
    item_ptr: torch.Tensor
    item_row: torch.Tensor
    item_part: torch.Tensor
    fin_row: torch.Tensor
    fin_ptr: torch.Tensor
    n_partials: int

    @property
    def n_nodes(self) -> int:
        return self.row_ptr.shape[0] - 1

    @property
    def n_blocks(self) -> int:
        """Blocks the combine walks: the partition's active slots."""
        return self.b.shape[0]


def _offsets(counts: torch.Tensor) -> torch.Tensor:
    """``[0, c0, c0 + c1, ...]``: the CSR pointer of ``counts``."""
    out = torch.zeros(counts.shape[0] + 1, dtype=torch.int64,
                      device=counts.device)
    out[1:] = torch.cumsum(counts, 0)
    return out


def block_csr(a: torch.Tensor, b: torch.Tensor, q: torch.Tensor,
              active: torch.Tensor, n_nodes: int) -> BlockCsr:
    """The CSR of the ``active`` slots of ``(a, b, q)``, on their device.

    Inactive slots (refined parents, all-ghost blocks, capacity padding) add
    exactly 0 to the combine, so leaving them out changes no value.  The
    kept slots are sorted by ``a`` stably, so a row keeps slot order.
    """
    dev = a.device
    keep = torch.nonzero(active).flatten()
    sel = keep[torch.sort(a[keep], stable=True).indices]
    counts = torch.bincount(a[sel], minlength=n_nodes)
    row_ptr = _offsets(counts)
    # an empty row is one item of no blocks: the kernel writes its zeros
    chunks = torch.clamp((counts + CHUNK - 1) // CHUNK, min=1)
    item_row = torch.repeat_interleave(
        torch.arange(n_nodes, device=dev), chunks)
    first_item = _offsets(chunks)[:-1]
    chunk = torch.arange(item_row.shape[0], device=dev) - first_item[item_row]
    item_ptr = torch.cat([row_ptr[item_row] + chunk * CHUNK, row_ptr[-1:]])
    split = chunks[item_row] > 1
    item_part = torch.where(split, torch.cumsum(split, 0) - 1, -1)
    fin_row = torch.nonzero(chunks > 1).flatten()
    i32 = dict(dtype=torch.int32)
    return BlockCsr(
        row_ptr=row_ptr.to(**i32), b=b[sel].to(**i32).contiguous(),
        q=q[sel].to(torch.float32).contiguous(), item_ptr=item_ptr.to(**i32),
        item_row=item_row.to(**i32), item_part=item_part.to(**i32),
        fin_row=fin_row.to(**i32), fin_ptr=_offsets(chunks[fin_row]).to(**i32),
        n_partials=int(split.sum()))


def kernel_library():
    """Build (at first use) and load the combine; a ``_build.BuiltLibrary``."""
    built = load_library(KERNEL_SOURCE)
    fn = built.lib.block_combine
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return built


def block_combine(t: torch.Tensor, csr: BlockCsr) -> torch.Tensor:
    """``c_node`` (..., n_nodes, C) from node sums ``t`` (..., n_nodes, C).

    Leading dims ride along: on the card they fold into the columns of one
    launch.  ``t`` is float32 on the card; ``csr`` lies on its device.
    """
    if not on_card("block_combine", t):
        return block_combine_plain(t, csr.row_ptr, csr.b, csr.q)
    if t.ndim != 2:
        n, c = t.shape[-2:]
        folded = t.movedim(-2, 0).reshape(n, -1)
        out = block_combine(folded, csr)
        return out.reshape(n, *t.shape[:-2], c).movedim(0, -2)
    t = t.contiguous()
    n, k = t.shape
    if n != csr.n_nodes:
        raise ValueError(f"t has {n} node rows, the CSR {csr.n_nodes}")
    if csr.b.device != t.device:
        raise ValueError(f"the CSR lies on {csr.b.device}, t on {t.device}")
    check_operand("t", t, (n, k), t.device)
    out = torch.empty_like(t)
    part = torch.empty((csr.n_partials, k), dtype=torch.float32,
                       device=t.device)
    launch(kernel_library(), "block_combine", t.device,
           csr.item_ptr.data_ptr(), csr.item_row.data_ptr(),
           csr.item_part.data_ptr(), csr.fin_row.data_ptr(),
           csr.fin_ptr.data_ptr(), csr.b.data_ptr(), csr.q.data_ptr(),
           t.data_ptr(), out.data_ptr(), part.data_ptr(),
           csr.item_row.shape[0], csr.fin_row.shape[0], k)
    block_combine.launches += 1
    return out


block_combine.launches = 0  # kernel calls; the CPU path does not count
