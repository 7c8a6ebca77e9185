"""Whole runs at a tiny size on the CPU: the result's keys, no JAX, and no
result without a card."""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

from bench import harness
from bench.tests.conftest import REPO

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload", ["tiny.vdt", "tiny.exact"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_keys(tiny_runs, workload, trace):
    result, checks = tiny_runs[(workload, trace)]
    keys = list(json.loads(json.dumps(result)))
    want = RESULT_KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert keys == want
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(result["checks"]) == set(checks)
    for name, (value, limit) in checks.items():
        assert result["checks"][name] == {"value": value, "limit": limit}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    names = set(result["metrics"])
    if not trace:
        assert names == {"setup_s", "lp_requests_per_s"}
    else:
        assert {"engine.occupancy.rate", "fit.total_s",
                "fit.refine_s"} <= names
        assert ("engine.latency_p95_ms" in names) == (workload == "tiny.vdt")


def test_foreign_modules_compares_whole_names(monkeypatch):
    assert harness.foreign_modules() == []
    monkeypatch.setitem(sys.modules, "repro", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.foreign_modules() == ["jax.numpy", "repro"]


def test_no_jax_or_repro_loaded_by_a_run(tmp_path):
    """A whole tiny run in a fresh process loads neither JAX nor ``repro``,
    and the reference side loads nothing of ``repro_torch``."""
    code = f"""
import sys
sys.path[:0] = [{str(REPO)!r}, {str(REPO / 'src')!r}]
import bench.compare, bench.work, bench.devtrace, bench.seeds
from bench.layout import Layout
lay = Layout({str(REPO)!r})
for kind, name in (("reference", "vdt"), ("reference", "exact"),
                   ("data", "secstr_like"), ("data", "alpha_like")):
    lay.module(kind, name)
assert not [m for m in sys.modules if m.split(".")[0].startswith("repro")], \\
    "the reference side loaded the program"
from bench.tests.conftest import build_tiny
from pathlib import Path
build_tiny(Path({str(tmp_path)!r}))
from bench import harness
harness.run_cell(Layout(Path({str(tmp_path)!r})), "tiny.vdt", 3, 0.5,
                 False, "cpu")
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "repro")))
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, str(REPO / "bench/run.py"),
                          "--workload", "secstr.vdt_r55", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120,
                         cwd=REPO)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def _imported_roots(path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            roots.add(node.module.split(".")[0])
    return roots


def test_sources_import_no_jax_and_the_reference_no_program():
    files = sorted((REPO / "bench").rglob("*.py"))
    assert len(files) > 20
    for path in files:
        bad = _imported_roots(path) & {"jax", "jaxlib", "flax", "repro"}
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"
    yardstick = [*(REPO / "bench/reference").glob("*.py"),
                 *(REPO / "bench/data").glob("*.py"),
                 *(REPO / "bench" / n for n in ("compare.py", "work.py",
                                                "seeds.py"))]
    for path in yardstick:
        assert "repro_torch" not in _imported_roots(path), path
