"""A throw-away benchmark in a temporary directory: the real ``bench/``
copied beside tiny configurations (squared Euclidean on SecStr-like points;
``kl`` and ``itakura_saito`` on the same points made positive), tiny mixes
and one extra metric, so that the CPU tests drive whole runs at a size a
test run holds."""
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

POSITIVE_GENERATOR = '''"""SecStr-like 0/1 points plus ``shift``: every coordinate > 0, as the
``kl`` and ``itakura_saito`` divergences need (a throw-away generator)."""
import torch


def make(gen, device, n, d, p_on=(0.08, 0.12), shift=0.1):
    labels = torch.randint(0, 2, (n,), generator=gen, device=device)
    p = torch.tensor(p_on, dtype=torch.float32, device=device)[labels]
    u = torch.rand((n, d), generator=gen, device=device)
    return (u < p[:, None]).to(torch.float32) + shift
'''

# configuration -> (divergence, data generator); each runs both tiny mixes
TINY_CONFIGS = {"tiny": ("sqeuclidean", "secstr_like"),
                "tiny_kl": ("kl", "secstr_shifted"),
                "tiny_is": ("itakura_saito", "secstr_shifted")}


def build_tiny(root: Path) -> dict:
    """Write the throw-away benchmark under ``root``; returns its spec."""
    shutil.copytree(REPO / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    (root / "bench/data/secstr_shifted.py").write_text(POSITIVE_GENERATOR)
    for name, (divergence, generator) in TINY_CONFIGS.items():
        cfg = json.loads((REPO / "bench/configs/secstr.json").read_text())
        cfg["name"] = name
        cfg["data"].update(generator=generator, n=TINY_N, d=TINY_D)
        cfg["fit"].update(refine_batch=256, divergence=divergence)
        (root / f"bench/configs/{name}.json").write_text(json.dumps(cfg))
        spec["configs"].append({"name": name, "source": "a test",
                                "file": f"bench/configs/{name}.json",
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
        for config in TINY_CONFIGS:
            name = f"{config}.{backend}"
            spec["workloads"].append({"name": name, "config": config,
                                      "traffic": f"tiny_{backend}",
                                      "chips": 1, "why": "CPU tests"})
            shutil.copy(REPO / f"bench/limits/{cell}.json",
                        root / f"bench/limits/{name}.json")
            for m in spec["end_to_end"] + spec["per_layer"]:
                if m["name"] == "tiny.sent" or cell in m.get("workloads",
                                                             [name]):
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
