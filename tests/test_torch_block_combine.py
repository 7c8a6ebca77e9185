"""The block combine's CSR and plain version (``kernels/block_combine``), on
the CPU.

The CSR keeps a partition's active slots only, sorted by data node in slot
order, with a pointer over every node and work items of at most ``CHUNK``
blocks; it is rebuilt with the dispatch buffers after ``refine`` and in a
new streaming epoch.  The plain version equals the walk's combine over the
whole slot list (``index_select``, the product by ``q``, ``index_add_``) bit
for bit, on fitted partitions and on a synthetic one with a row of several
hundred blocks.  The kernel itself runs on the card
(``tests/test_torch_gpu.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch import VariationalDualTree
from repro_torch.core.matvec import collect_up, prepare_q
from repro_torch.kernels.block_combine import (CHUNK, block_combine,
                                               block_combine_plain, block_csr)

WIDTHS = (1, 3, 8, 32, 256)
LONG_ROW = 400     # slots of the synthetic partition's busiest row


def _fitted(seed, n=300, d=8):
    x = np.random.RandomState(seed).randn(n, d).astype(np.float32)
    return VariationalDualTree.fit(x, max_blocks=4 * n, device="cpu")


@pytest.fixture(scope="module")
def fitted():
    return _fitted(5)


def _synthetic():
    """Slots over a 7-level heap: one node with ``LONG_ROW`` slots, nodes of
    the upper half with a few, about a fifth inactive, the lower half with
    none, and capacity padding at node 0."""
    rng = np.random.RandomState(9)
    L, cap, used = 6, 2_000, 1_300
    n_nodes = (2 << L) - 1
    a = np.zeros(cap, np.int64)
    b = np.zeros(cap, np.int64)
    a[:used] = rng.randint(1, n_nodes // 2, used)
    a[rng.choice(used, LONG_ROW, replace=False)] = 5
    b[:used] = rng.randint(0, n_nodes, used)
    active = np.zeros(cap, bool)
    active[:used] = rng.rand(used) < 0.8
    log_q = np.log(rng.rand(cap).astype(np.float32) + 0.01)
    a, b, active = (torch.as_tensor(v) for v in (a, b, active))
    return L, a, b, active, prepare_q(active, torch.as_tensor(log_q))


def _partition(name, fitted):
    """(L, a, b, active, q) of a fitted model or of the synthetic slots."""
    if name == "synthetic":
        return _synthetic()
    a, b, active, q, _ = fitted._dispatch_buffers()
    return fitted.tree.L, a, b, active, q


PARTITIONS = ["fitted", "synthetic"]


@pytest.mark.parametrize("name", PARTITIONS)
def test_block_csr_keeps_the_active_slots_sorted_by_data_node(name, fitted):
    L, a, b, active, q = _partition(name, fitted)
    n_nodes = (2 << L) - 1
    csr = (fitted._block_csr() if name == "fitted"
           else block_csr(a, b, q, active, n_nodes))
    keep = np.flatnonzero(active.numpy())
    order = keep[np.argsort(a.numpy()[keep], kind="stable")]
    assert csr.n_blocks == keep.size < a.shape[0]
    np.testing.assert_array_equal(csr.b.numpy(), b.numpy()[order])
    np.testing.assert_array_equal(csr.q.numpy(), q.numpy()[order])
    assert csr.b.dtype == csr.row_ptr.dtype == torch.int32
    assert csr.q.dtype == torch.float32
    # the pointer covers every node, those with no blocks too
    counts = np.bincount(a.numpy()[keep], minlength=n_nodes)
    assert csr.row_ptr.shape == (n_nodes + 1,) and int(csr.row_ptr[0]) == 0
    np.testing.assert_array_equal(np.diff(csr.row_ptr.numpy()), counts)
    assert counts[0] == 0 and (counts == 0).sum() > 1
    if name == "fitted":
        assert csr.n_blocks == fitted.bp.n_active == fitted.n_blocks
        assert fitted.bp.refined.any()


@pytest.mark.parametrize("name", PARTITIONS)
def test_block_csr_work_items_cut_rows_into_chunks(name, fitted):
    """Each row is its items in order, each at most ``CHUNK`` blocks; the
    items of a longer row write partial rows that add up to the row."""
    L, a, b, active, q = _partition(name, fitted)
    n_nodes = (2 << L) - 1
    csr = block_csr(a, b, q, active, n_nodes)
    ptr, rows = csr.item_ptr.long(), csr.item_row.long()
    sizes = ptr.diff()
    assert int(ptr[0]) == 0 and int(ptr[-1]) == csr.n_blocks
    assert bool((sizes >= 0).all()) and int(sizes.max()) <= CHUNK
    np.testing.assert_array_equal(np.unique(rows.numpy()), np.arange(n_nodes))
    row_ptr = csr.row_ptr.long()
    first = torch.ones_like(rows, dtype=torch.bool)
    first[1:] = rows[1:] != rows[:-1]
    torch.testing.assert_close(ptr[:-1][first], row_ptr[:-1])
    split = csr.item_part >= 0
    assert int(split.sum()) == csr.n_partials
    if name == "synthetic":
        assert csr.fin_row.tolist() == [5]
        long_row = int(csr.row_ptr[6] - csr.row_ptr[5])
        assert long_row > LONG_ROW // 2
        assert int(csr.fin_ptr[-1]) == csr.n_partials == -(-long_row // CHUNK)
    # the items' sums, then each long row's partial rows, as the kernel
    t = collect_up(torch.randn((1 << L), 8), L)
    part = torch.zeros((csr.n_partials, 8))
    out = torch.full((n_nodes, 8), float("nan"))
    for i in range(rows.shape[0]):
        j = slice(int(ptr[i]), int(ptr[i + 1]))
        s = (csr.q[j, None] * t[csr.b[j].long()]).sum(0)
        if split[i]:
            part[int(csr.item_part[i])] = s
        else:
            out[int(rows[i])] = s
    for r, p0, p1 in zip(csr.fin_row.tolist(), csr.fin_ptr[:-1].tolist(),
                         csr.fin_ptr[1:].tolist()):
        out[r] = part[p0:p1].sum(0)
    torch.testing.assert_close(out, block_combine_plain(
        t, csr.row_ptr, csr.b, csr.q), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("k", WIDTHS)
@pytest.mark.parametrize("name", PARTITIONS)
def test_block_combine_plain_equals_the_slot_list_combine(name, k, fitted):
    L, a, b, active, q = _partition(name, fitted)
    csr = block_csr(a, b, q, active, (2 << L) - 1)
    y_leaf = torch.as_tensor(
        np.random.RandomState(k).randn(1 << L, k).astype(np.float32))
    t = collect_up(y_leaf, L)
    want = torch.zeros_like(t).index_add_(0, a, q[:, None] * t.index_select(
        0, b))
    torch.testing.assert_close(block_combine(t, csr), want, rtol=0, atol=0)


@pytest.mark.parametrize("change", ["refine", "stream"])
def test_block_csr_is_rebuilt_after_refine_and_in_a_new_epoch(change):
    x = np.random.RandomState(21).randn(120, 4).astype(np.float32)
    vdt = VariationalDualTree.fit(x, max_blocks=240, capacity=160,
                                  device="cpu")
    old = vdt._block_csr()
    if change == "refine":
        vdt.refine(max_blocks=360)
        new_vdt = vdt
    else:
        x_new = np.random.RandomState(22).randn(9, 4).astype(np.float32)
        new_vdt = vdt.insert_points(x_new).vdt
        assert vdt._block_csr() is old   # the old epoch keeps its own
    new = new_vdt._block_csr()
    assert new is not old
    assert new.n_blocks == new_vdt.bp.n_active
    a, b, active, q, _ = new_vdt._dispatch_buffers()
    want = block_csr(a, b, q, active, new_vdt.tree.n_nodes)
    for field in ("row_ptr", "b", "q", "item_ptr"):
        assert torch.equal(getattr(new, field), getattr(want, field))
    if change == "refine":
        assert new.n_blocks > old.n_blocks
