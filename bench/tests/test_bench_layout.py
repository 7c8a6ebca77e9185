"""BENCHMARK.json keeps to the contract, and the harness finds everything
it names, by name."""
from __future__ import annotations

import json
import re

import pytest

from bench.layout import Layout
from bench.tests.conftest import REPO

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert SPEC["paths"] == ["bench"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_names_and_units(section):
    names = [e["name"] for e in SPEC[section]]
    assert len(names) == len(set(names))
    for e in SPEC[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and section != "end_to_end":
                assert _line(e[key]), (e["name"], key)
        for key in ("config", "traffic", *e.get("reduced", ())):
            if key in e:
                assert NAME.match(str(e[key]) if key in ("config", "traffic")
                                  else key)


def test_metrics_and_bounds():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m["workloads"]) <= {w["name"] for w in SPEC["workloads"]}
        if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
            assert m["better"] == "higher"


def test_every_name_is_found():
    layout = Layout(REPO)
    configs = {c["name"] for c in SPEC["configs"]}
    for w in SPEC["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        cell = layout.cell(w["name"])
        assert cell.chips == w["chips"]
        data = cell.config["data"]
        layout.module("data", data["generator"])
        ref = layout.module("reference", cell.mix["backend"])
        assert hasattr(ref, "answers") and hasattr(ref, "CONTROL")
        layout.module("traffic", cell.mix["loop"])
        assert {m["name"] for m in cell.per_layer} and cell.end_to_end
        for m in cell.end_to_end + cell.per_layer:
            assert hasattr(layout.module("metrics", m["name"]), "read")
    for c in SPEC["configs"]:
        assert c["file"].startswith("bench/")
        assert json.loads((REPO / c["file"]).read_text())["name"] == c["name"]


def test_cells_report_their_metrics():
    """Each cell reports setup_s, one other end-to-end metric, and the
    per-layer metrics that move it (split by the metric they move)."""
    layout = Layout(REPO)
    got = {w["name"]: layout.cell(w["name"]) for w in SPEC["workloads"]}
    e2e = {k: {m["name"] for m in c.end_to_end} for k, c in got.items()}
    lay = {k: {m["name"] for m in c.per_layer} for k, c in got.items()}
    assert e2e["secstr.vdt_r55"] == e2e["alpha.vdt_r40"] == e2e[
        "secstr.exact_r20"] == {"lp_requests_per_s", "setup_s"}
    fit = {"fit.total_s", "fit.refine_s"}
    both = {"engine.occupancy", "engine.queue_wait_ms", "engine.serial_ms",
            "lp.column_fill", "device.idle_share", "serve_mfu"}
    vdt = both | {"vdt.iter_device_ms", "vdt.launches_per_iter"}
    assert lay["secstr.vdt_r55"] == fit | {f"{m}.rate" for m in vdt} | {
        "engine.latency_p95_ms"}
    assert lay["alpha.vdt_r40"] == fit | {f"{m}.rate" for m in vdt}
    assert lay["secstr.exact_r20"] == fit | {f"{m}.rate" for m in both} | {
        "k1_roofline"}
    for cell in got.values():
        moved = {m["name"] for m in cell.end_to_end}
        assert all(m["moves"] in moved for m in cell.per_layer)


def test_throwaway_config_mix_and_metric(tiny_layout, tiny_runs):
    """A configuration, a mix and a metric added as files plus entries in a
    temporary directory are found by name and run."""
    cell = tiny_layout.cell("tiny.vdt")
    assert cell.config["data"]["n"] < 1000 and cell.mix["rate"] == 40
    assert "tiny.sent" in {m["name"] for m in cell.per_layer}
    result, _ = tiny_runs[("tiny.vdt", True)]
    assert result["metrics"]["tiny.sent"]["value"] == result["attempted"]
    with pytest.raises(KeyError):
        tiny_layout.cell("no.such_cell")
