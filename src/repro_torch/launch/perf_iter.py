"""``repro_torch/launch/perf_iter.py`` ↔ ``repro/launch/perf_iter.py``.

§Perf hillclimb: re-counts a dry-run cell under named optimization
variants and records before/after roofline terms.

    PYTHONPATH=src python -m repro_torch.launch.perf_iter \\
        --cell smollm-360m:train_4k --variant chunked_ce

Variants (each is one hypothesis from the §Perf log):
  attn_seq_shard — shard the S^2 attention einsums over query-sequence when
                   n_heads %% tp != 0 (kills replicated compute)
  chunked_ce     — scan the CE loss over sequence chunks (peak-memory cut)
  noremat        — disable activation checkpointing (FLOPs down, memory up)
  all            — attn_seq_shard + chunked_ce

Counts are global and taken on ``meta`` tensors (``dryrun.count_work``).
One process drives the port, so its ``ShardCtx`` constrains nothing:
``attn_seq_shard`` changes no count here, and the output says so.
"""
import argparse
import dataclasses
import json

from repro_torch.configs.registry import get_config
from repro_torch.launch import dryrun

VARIANTS = {
    "attn_seq_shard": dict(ctx=dict(attn_seq_shard=True), cfg={}, train={}),
    "chunked_ce": dict(ctx={}, cfg={}, train=dict(chunked_ce=512)),
    "noremat": dict(ctx={}, cfg=dict(remat=False), train={}),
    "all": dict(ctx=dict(attn_seq_shard=True), cfg={},
                train=dict(chunked_ce=512)),
}

SEQ_SHARD_NOTE = ("attn_seq_shard changes no count on one controller: "
                  "ShardCtx is the identity there")


def run_variant(arch: str, shape: str, variant: str, force=False):
    v = VARIANTS[variant]
    dryrun.CTX_KW.clear()
    dryrun.CTX_KW.update(v["ctx"])
    dryrun.TRAIN_KW.clear()
    dryrun.TRAIN_KW.update(v["train"])
    cfg = get_config(arch)
    if v["cfg"]:
        cfg = dataclasses.replace(cfg, **v["cfg"])
    try:
        return dryrun.run_cell(arch, shape, multi_pod=False, force=force,
                               cfg_override=cfg, variant=variant)
    finally:
        dryrun.CTX_KW.clear()
        dryrun.TRAIN_KW.clear()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, help="arch:shape")
    ap.add_argument("--variant", required=True,
                    choices=list(VARIANTS) + ["baseline"])
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()
    arch, shape = args.cell.split(":")
    if args.variant == "baseline":
        rec = dryrun.run_cell(arch, shape, multi_pod=False, force=args.force)
    else:
        rec = run_variant(arch, shape, args.variant, force=args.force)
    out = {k: rec.get(k) for k in ("cell", "status", "counted", "wall_s",
                                   "error")}
    if rec.get("roofline"):
        out["roofline"] = rec["roofline"]
    if VARIANTS.get(args.variant, {}).get("ctx", {}).get("attn_seq_shard"):
        out["note"] = SEQ_SHARD_NOTE
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
