"""``repro_torch/launch/summarize.py`` ↔ ``repro/launch/summarize.py``.

Aggregate dry-run artifacts into the EXPERIMENTS.md summary tables.

    PYTHONPATH=src python -m repro_torch.launch.summarize
writes artifacts/roofline_torch.md and artifacts/summary_torch.json (beside
the reference's roofline.md and summary.json) from the port's records
(``artifacts/dryrun_torch``), and prints the headline counts.  The port's
records have no collectives (one controller): their column reads 0.  They
are counted on meta (``"counted": "meta"``), with no compile: their compile
column reads ``-``, and a record with a roofline shows it even at 0 FLOPs
(the paper cell counts no products), where the reference's ``(scanned-only)``
marks XLA's cost analysis missing a scan's body.  Records in the reference's
format give the reference's table.
"""
from __future__ import annotations

import json
from pathlib import Path

ART = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"


def load_cells():
    cells = []
    for f in sorted(ART.glob("*.json")):
        try:
            cells.append(json.loads(f.read_text()))
        except (OSError, ValueError):   # a record being written, or torn
            pass
    return cells


def _coll_gb(c) -> float:
    return c.get("collectives", {}).get("total", 0) / 1e9


def main():
    cells = load_cells()
    base = [c for c in cells if len(c["cell"].split("__")) == 3]
    variants = [c for c in cells if len(c["cell"].split("__")) > 3]

    ok = [c for c in base if c["status"] == "ok"]
    skipped = [c for c in base if c["status"] == "skipped"]
    errors = [c for c in base if c["status"] == "error"]

    md = ["# Roofline table (single-pod baseline; multi-pod = compile proof)",
          "",
          "| cell | compile (s) | t_comp (s) | t_mem (s) | t_coll (s) | "
          "bottleneck | useful FLOPs | MFU@roofline | coll GB |",
          "|---|---|---|---|---|---|---|---|---|"]
    for c in sorted(ok, key=lambda c: c["cell"]):
        rl = c.get("roofline") or {}
        compile_s = "-" if c.get("counted") == "meta" else c.get("compile_s")
        if not rl or not (rl.get("flops") or c.get("counted") == "meta"):
            md.append(f"| {c['cell']} | {compile_s} | - | - | - | "
                      f"(scanned-only) | - | - | "
                      f"{_coll_gb(c):.2f} |")
            continue
        md.append(
            f"| {c['cell']} | {compile_s} | "
            f"{rl['t_compute_s']:.4g} | {rl['t_memory_s']:.4g} | "
            f"{rl['t_collective_s']:.4g} | {rl['bottleneck']} | "
            f"{rl['useful_flops_frac']:.3f} | {rl['mfu_at_roofline']:.2%} | "
            f"{_coll_gb(c):.2f} |")
    md.append("")
    md.append("## Skipped by design")
    for c in sorted(skipped, key=lambda c: c["cell"]):
        md.append(f"- {c['cell']}: {c.get('reason', '')[:120]}")
    if errors:
        md.append("")
        md.append("## Errors")
        for c in errors:
            md.append(f"- {c['cell']}: {c.get('error', '')[:200]}")
    if variants:
        md.append("")
        md.append("## §Perf variants")
        md.append("| variant cell | t_comp | t_mem | t_coll | bottleneck | "
                  "useful | coll GB |")
        md.append("|---|---|---|---|---|---|---|")
        for c in sorted(variants, key=lambda c: c["cell"]):
            rl = c.get("roofline") or {}
            if c["status"] != "ok" or not rl:
                md.append(f"| {c['cell']} | {c.get('status')} "
                          f"{c.get('error', '')[:80]} | | | | | |")
                continue
            md.append(
                f"| {c['cell']} | {rl['t_compute_s']:.4g} | "
                f"{rl['t_memory_s']:.4g} | {rl['t_collective_s']:.4g} | "
                f"{rl['bottleneck']} | {rl['useful_flops_frac']:.3f} | "
                f"{_coll_gb(c):.2f} |")

    out = ART.parent / "roofline_torch.md"
    out.write_text("\n".join(md) + "\n")
    summary = {
        "ok": len(ok), "skipped": len(skipped), "errors": len(errors),
        "variants": len(variants),
        "by_mesh": {
            m: sum(1 for c in ok if c["mesh"] == m)
            for m in ("single_pod", "multi_pod")
        },
    }
    (ART.parent / "summary_torch.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary, indent=1))
    for c in errors:
        print("ERROR", c["cell"], c.get("error", "")[:160])


if __name__ == "__main__":
    main()
