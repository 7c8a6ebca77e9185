"""Readings that the limits of ``limits/<workload>.json`` are set from:
per seed, the program's ``answer_err`` and ``sigma_err`` from a run of the
cell, and the control's, the plain reference in the next precision below
float32 put in the program's place on the same requests
(``reference/<backend>.py``'s ``CONTROL``; bfloat16 for eq. 12).  With
``--fit-only``, the fit alone and its ``sigma_err``, the program's and the
control's, and with ``--no-refit`` also that of a fault: the fit run again
with its sigma never refitted during refinement.  Not run by the
benchmark's own runs.

    python3 bench/control.py --workload secstr.vdt_r55 --seeds 11,12,13 --seconds 30
    python3 bench/control.py --workload secstr.vdt_r55 --seeds 11,12,13 --fit-only --no-refit
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]   # not bench/ itself


@contextlib.contextmanager
def no_sigma_refit():
    """The fault: refinement keeps the bandwidth of the coarsest partition."""
    import repro_torch.core.refine as refine_mod

    refine = refine_mod.refine_to_budget

    def kept(*args, **kwargs):
        kwargs["refit_sigma"] = False
        return refine(*args, **kwargs)

    refine_mod.refine_to_budget = kept
    try:
        yield
    finally:
        refine_mod.refine_to_budget = refine


def fit_readings(layout, workload: str, seed: int, device,
                 no_refit: bool) -> dict:
    """``sigma_err`` of the program's fit, of the control and (with
    ``no_refit``) of the fault, on the cell's data ordered by ``seed``."""
    import torch

    from bench import harness

    cell = layout.cell(workload)
    device = torch.device(device)
    ref = layout.module("reference", cell.mix["backend"])
    x = harness.points(layout, cell.config, seed, device)
    vdt, fit_s = harness.fit_model(cell.config, x, device)
    fitted = harness.followed(vdt, device)
    del vdt
    out = {"workload": workload, "seed": seed, "fit_s": fit_s,
           "sigma": fitted["sigma"],
           "program": ref.checks(x, fitted, cell.config)["sigma_err"],
           "control": ref.control_sigma_err(x, fitted, cell.config)}
    if no_refit:
        with no_sigma_refit():
            vdt, _ = harness.fit_model(cell.config, x, device)
        fault = harness.followed(vdt, device)
        del vdt
        out["fault_sigma"] = fault["sigma"]
        out["no_refit"] = ref.checks(x, fault, cell.config)["sigma_err"]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--fit-only", action="store_true")
    p.add_argument("--no-refit", action="store_true")
    args = p.parse_args(argv)

    from bench import harness
    from bench.layout import Layout

    layout = Layout(ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.fit_only:
            print(json.dumps({"sigma_err": fit_readings(
                layout, args.workload, seed, args.device, args.no_refit)}),
                flush=True)
            continue
        result, checks = harness.run_cell(layout, args.workload, seed,
                                          args.seconds, False, args.device,
                                          control=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": {k: v for k, (v, _) in checks.items()},
                          "control": result["control"],
                          "limits": {k: lim for k, (_, lim) in
                                     checks.items()},
                          "correct": result["correct"],
                          "metrics": result["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
