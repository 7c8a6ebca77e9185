"""The paper's LP step (``core/distributed.py::lp_step_leaforder``) as a
row-sharded SPMD program over a 2 x 2 ("data", "model") gloo mesh, run by
``tests/test_torch_spmd_paper.py`` in a subprocess:

    python tests/_spmd_paper_worker.py OUT_DIR CASE [CASE ...]

For each case it reads ``OUT_DIR/{case}_inputs.npz`` (``y``, ``y0`` (Np, C)
in leaf order, ``a``, ``b`` (nb,) block node ids, ``q`` (nb,) block
weights, ``L``, ``alpha`` and ``n_iters``), starts four ranks
(``torch.multiprocessing``, spawn), and on each rank runs one step with
float32 and one with bfloat16 carriers, and a scan of ``n_iters`` steps,
every input split by rows over the whole mesh (``shard_rows``); rank 0
also runs them on plain tensors.  Rank 0 writes ``OUT_DIR/{case}_out.npz``:
the sharded (``spmd/...``) and plain (``plain/...``) results, and the
sharded results' placements as text (``placements/...``).
"""
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

SRC = Path(__file__).resolve().parents[1] / "src"
sys.path.insert(0, str(SRC))

WORLD, MESH = 4, (2, 2)


def _run(inputs: dict, mesh) -> dict:
    from repro_torch.core.distributed import (label_propagate_distributed,
                                              lp_step_leaforder, shard_rows)

    names = ("y", "y0", "a", "b", "q")
    args = [torch.as_tensor(inputs[k]) for k in names]
    if mesh is not None:
        args = [shard_rows(t, mesh) for t in args]
    y, y0, a, b, q = args
    alpha, L = float(inputs["alpha"]), int(inputs["L"])
    out = {"step": lp_step_leaforder(y, y0, a, b, q, alpha, L),
           "step_bf16": lp_step_leaforder(y, y0, a, b, q, alpha, L,
                                          carrier_dtype=torch.bfloat16),
           "scan": label_propagate_distributed(y0, a, b, q, alpha, L,
                                               int(inputs["n_iters"]))}
    res = {}
    for k, t in out.items():
        if mesh is not None:
            res[f"placements/{k}"] = np.array(str(tuple(t.placements)))
            t = t.full_tensor()
        res[k] = t.numpy()
    return res


def _rank(rank: int, out_dir: str, cases: list, store: str):
    from repro_torch.launch.mesh import device_mesh, file_process_group

    with file_process_group("gloo", rank, WORLD, store):
        mesh = device_mesh(MESH, ("data", "model"), "cpu")
        for case in cases:
            with np.load(Path(out_dir) / f"{case}_inputs.npz") as npz:
                inputs = {k: npz[k] for k in npz.files}
            got = {f"spmd/{k}": v for k, v in _run(inputs, mesh).items()}
            if rank == 0:
                got.update({f"plain/{k}": v for k, v in
                            _run(inputs, None).items()})
                np.savez(Path(out_dir) / f"{case}_out.npz", **got)


def main(argv):
    import torch.multiprocessing as mp

    out_dir, cases = argv[0], argv[1:]
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank, args=(out_dir, cases,
                                        os.path.join(tmp, "store")),
                           nprocs=WORLD, start_method="spawn")


if __name__ == "__main__":
    main(sys.argv[1:])
