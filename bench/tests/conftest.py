"""A throw-away benchmark in a temporary directory: the real ``bench/``
copied beside a tiny configuration, tiny mixes and one extra metric, so that
the CPU tests drive whole runs at a size a test run holds."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
TINY_N, TINY_D = 600, 40

EXTRA_METRIC = '''"""Requests sent in the window (a throw-away metric)."""


def read(run):
    return len(run.records)
'''


def build_tiny(root: Path) -> dict:
    """Write the throw-away benchmark under ``root``; returns its spec."""
    shutil.copytree(REPO / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((REPO / "bench/configs/secstr.json").read_text())
    cfg["name"] = "tiny"
    cfg["data"].update(n=TINY_N, d=TINY_D)
    cfg["fit"]["refine_batch"] = 256
    (root / "bench/configs/tiny.json").write_text(json.dumps(cfg))
    spec["configs"].append({"name": "tiny", "source": "a test",
                            "file": "bench/configs/tiny.json",
                            "reduced": ["n", "d"], "why": "CPU tests"})
    (root / "bench/metrics/tiny.sent.py").write_text(EXTRA_METRIC)
    spec["per_layer"].append({"name": "tiny.sent", "unit": "requests",
                              "better": "higher", "source": "host_clock",
                              "layer": "serving engine",
                              "moves": "lp_requests_per_s",
                              "workloads": []})
    for mix_name, backend, cell in (("vdt_r55", "vdt", "secstr.vdt_r55"),
                                    ("exact_r20", "exact",
                                     "secstr.exact_r20")):
        mix = json.loads((REPO / f"bench/traffic/{mix_name}.json").read_text())
        mix.update(rate=40, n_iters=10, check_every=1)
        mix["engine"]["max_batch"] = 4
        (root / f"bench/traffic/tiny_{backend}.json").write_text(
            json.dumps(mix))
        name = f"tiny.{backend}"
        spec["workloads"].append({"name": name, "config": "tiny",
                                  "traffic": f"tiny_{backend}", "chips": 1,
                                  "why": "CPU tests"})
        shutil.copy(REPO / f"bench/limits/{cell}.json",
                    root / f"bench/limits/{name}.json")
        for m in spec["end_to_end"] + spec["per_layer"]:
            if m["name"] == "tiny.sent" or cell in m.get("workloads", [name]):
                m.setdefault("workloads", []).append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return spec


@pytest.fixture(scope="session")
def tiny_layout(tmp_path_factory):
    from bench.layout import Layout

    root = tmp_path_factory.mktemp("tinybench")
    build_tiny(root)
    return Layout(root)


@pytest.fixture(scope="session")
def tiny_runs(tiny_layout):
    """One untraced and one traced CPU run of each tiny cell."""
    from bench import harness

    return {(w, tr): harness.run_cell(tiny_layout, w, 2**33 + 5, 1.0, tr,
                                      "cpu")
            for w in ("tiny.vdt", "tiny.exact") for tr in (False, True)}
