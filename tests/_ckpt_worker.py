"""Checkpoints of a DTensor tree on gloo ranks on the CPU, run by
``tests/test_torch_runtime.py`` in a subprocess:

    python tests/_ckpt_worker.py OUT_DIR

Four phases, each a fresh set of spawned ranks (``launch.mesh.
spawn_ranks``) over a 1-D mesh of all of them and a 2-D one of
``(2, n / 2)``:

1. 8 ranks build the tree of :func:`whole` as DTensors (``Shard(0)``,
   ``Shard(1)``, ``Replicate``, an int32 shard, a 0-dim replicated leaf, a
   2-D mesh leaf, and a plain 0-dim int32 step) and save it with
   ``ckpt.save`` into ``OUT_DIR/save8`` and with ``ckpt.save_async`` into
   ``OUT_DIR/async8``;
2. 4 ranks restore ``save8`` onto their own tree's layout, then save it
   into ``save4``;
3. 8 ranks restore ``save4``;
4. 2 ranks restore ``save8``.

Each rank of each phase writes ``OUT_DIR/{phase}_rank{r}.json``: how many
times it called ``np.savez`` (only the writing rank should) and, for a
restore, each leaf's type, placements and whether its local tensor equals
its slice of the whole array bit for bit.
"""
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch._device import is_dtensor  # noqa: E402
from repro_torch._tree import flatten  # noqa: E402
from repro_torch.launch.mesh import (device_mesh,  # noqa: E402
                                     local_process_group, spawn_ranks)
from repro_torch.runtime import checkpoint as ckpt  # noqa: E402


def whole() -> dict:
    """The tree's whole values (the same on every rank)."""
    r = np.random.RandomState(0)
    return {"s0": r.randn(16, 6).astype(np.float32),
            "s1": r.randn(6, 16).astype(np.float32),
            "rep": r.randn(5, 3).astype(np.float32),
            "ints": r.randint(-9, 9, 8).astype(np.int32),
            "scalar": np.float32(r.randn()),
            "grid": r.randn(8, 8).astype(np.float32),
            "step": np.int32(7)}


def sharded(values: dict) -> dict:
    """``values`` laid out on this rank's meshes (every rank keeps its own
    shard: ``distribute_tensor`` with no source rank)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    n = torch.distributed.get_world_size()
    line = device_mesh((n,), ("x",), "cpu")
    grid = device_mesh((2, n // 2), ("a", "b"), "cpu")
    layout = {"s0": (line, [Shard(0)]), "s1": (line, [Shard(1)]),
              "rep": (line, [Replicate()]), "ints": (line, [Shard(0)]),
              "scalar": (line, [Replicate()]),
              "grid": (grid, [Shard(0), Shard(1)])}
    out = {"step": torch.as_tensor(values["step"])}
    for k, (mesh, pl) in layout.items():
        out[k] = distribute_tensor(torch.as_tensor(values[k]), mesh, pl,
                                   src_data_rank=None)
    return out


def _rank(rank, world, store, out_dir, phase, src, dst):
    calls = []
    real_savez = ckpt.np.savez

    def counted(*args, **kwargs):
        calls.append(1)
        return real_savez(*args, **kwargs)

    ckpt.np.savez = counted
    out = Path(out_dir)
    with local_process_group("cpu", rank, world, store):
        want = whole()
        record = {}
        if src is None:
            tree = sharded(want)
            ckpt.save(out / dst, 2, tree, fingerprint="dt")
            ckpt.save_async(out / "async8", 2, tree, fingerprint="dt")
            ckpt.wait_for_saves()
        else:
            like = sharded({k: np.zeros_like(v) for k, v in want.items()})
            tree, step = ckpt.restore(out / src, like,
                                      expect_fingerprint="dt")
            assert step == 2
            cuts = sharded(want)   # this rank's slices of the whole arrays
            for k, leaf in tree.items():
                ref, cut = like[k], cuts[k]
                local, mine = (t.to_local() if is_dtensor(t) else t
                               for t in (leaf, ref))
                cut = cut.to_local() if is_dtensor(cut) else cut
                record[k] = dict(
                    dtensor=is_dtensor(leaf),
                    placements=str(getattr(leaf, "placements", None)),
                    like_placements=str(getattr(ref, "placements", None)),
                    shape=list(local.shape), like_shape=list(mine.shape),
                    equal=bool(local.dtype == cut.dtype
                               and torch.equal(local, cut)))
            if dst:
                ckpt.save(out / dst, 2, tree, fingerprint="dt")
        n_leaves = len(flatten(tree)[0])
    (out / f"{phase}_rank{rank}.json").write_text(json.dumps(
        dict(savez=len(calls), leaves=record, n_leaves=n_leaves)))


PHASES = (("p8", 8, None, "save8"), ("p4", 4, "save8", "save4"),
          ("p8b", 8, "save4", None), ("p2", 2, "save8", None))


def main(out_dir: str):
    for phase, n, src, dst in PHASES:
        spawn_ranks(_rank, n, out_dir, phase, src, dst)


if __name__ == "__main__":
    main(sys.argv[1])
