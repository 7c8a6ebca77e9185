"""Finds what ``BENCHMARK.json`` names: cells, configurations, mixes, their
generators, references, limits and metric readers, each in a file of its
own under ``<root>/bench``."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parents[1]


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: dict
    mix: dict
    limits: dict
    chips: int
    end_to_end: tuple      # BENCHMARK.json metric entries this cell reports
    per_layer: tuple


class Layout:
    """The benchmark rooted at ``root`` (the directory of BENCHMARK.json)."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.bench = self.root / "bench"

    def _json(self, *parts: str) -> dict:
        return json.loads(self.bench.joinpath(*parts).read_text())

    def module(self, kind: str, name: str) -> ModuleType:
        """``bench/<kind>/<name>.py``, loaded once per process.  A metric
        split by the end-to-end metric it moves (``engine.occupancy.rate``)
        is read by its stem's reader (``engine.occupancy.py``) unless it
        has one of its own."""
        path = self.bench / kind / f"{name}.py"
        if kind == "metrics" and not path.exists() and "." in name:
            path = self.bench / kind / f"{name.rsplit('.', 1)[0]}.py"
        key = f"bench_{kind}_{name}_{abs(hash(str(path)))}".replace(".", "_")
        if key not in sys.modules:
            spec = importlib.util.spec_from_file_location(key, path)
            if spec is None or not path.exists():
                raise FileNotFoundError(f"no {kind} module {path}")
            mod = importlib.util.module_from_spec(spec)
            sys.modules[key] = mod
            spec.loader.exec_module(mod)
        return sys.modules[key]

    def cell(self, workload: str) -> Cell:
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        w = cells[workload]
        configs = {c["name"]: c for c in self.spec["configs"]}
        config = json.loads((self.root / configs[w["config"]]["file"])
                            .read_text())
        e2e = tuple(m for m in self.spec["end_to_end"]
                    if "workloads" not in m or workload in m["workloads"])
        reported = {m["name"] for m in e2e}
        per_layer = tuple(
            m for m in self.spec["per_layer"]
            if workload in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in reported))
        return Cell(name=workload, config=config,
                    mix=self._json("traffic", f"{w['traffic']}.json"),
                    limits=self._json("limits", f"{workload}.json"),
                    chips=int(w["chips"]), end_to_end=e2e,
                    per_layer=per_layer)
