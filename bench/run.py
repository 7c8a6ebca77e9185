"""Run one cell of the benchmark on one CUDA card and print its result.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and ``checks`` last); the numbers compared, each beside its
limit, are the last lines of standard error.  Without a CUDA card, or if JAX
or the JAX package ``repro`` got loaded, it prints no result and exits 2 or
3.  Kernels build once into ``build/`` inside the checkout.
"""
from __future__ import annotations

import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / "build" / sub)
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]   # not bench/ itself


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from bench import harness
    from bench.layout import Layout

    layout = Layout(ROOT)
    chips = layout.cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: needs {chips} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              "; no result", file=sys.stderr)
        return 2
    result, checks = harness.run_cell(layout, args.workload, args.seed,
                                      args.seconds, bool(args.trace), "cuda",
                                      t_proc=T_PROC)
    foreign = harness.foreign_modules()
    if foreign:
        print(f"bench: JAX or its package was loaded: {foreign}; no result",
              file=sys.stderr)
        return 3
    for name, (value, limit) in checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
