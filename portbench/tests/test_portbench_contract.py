"""BENCHMARK.json within its format's characters, keys and counts, and
each entry's files where the harness looks for them."""

from __future__ import annotations

import json
import re

import pytest

from portbench.tests.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert BENCH["paths"] == ["portbench"]
    assert all(TEXT.match(w) for w in BENCH["command"]) and len(BENCH["command"]) <= 32


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_configs(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and TEXT.match(entry["source"]) and TEXT.match(entry["why"])
    assert entry["file"].startswith("portbench/configs/") and (ROOT / entry["file"]).is_file()
    assert json.loads((ROOT / entry["file"]).read_text())["reduced"] == entry["reduced"] == []


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_workloads(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(entry["name"]) and NAME.match(entry["traffic"]) and TEXT.match(entry["why"])
    assert entry["config"] in {c["name"] for c in BENCH["configs"]} and entry["chips"] in (1, 4)
    assert (ROOT / "portbench" / "workloads" / f"{entry['name']}.json").is_file()


def test_metrics():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert TEXT.match(m["layer"]) and m["moves"] in e2e and set(m["workloads"]) <= cells
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
        reported = [e for e in BENCH["end_to_end"] if e["name"] == m["moves"]][0].get("workloads", cells)
        assert set(m["workloads"]) <= set(reported)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for cell in cells:
        assert any(cell in m["workloads"] for m in BENCH["per_layer"])
        assert any(cell in m.get("workloads", [cell]) and m["name"] != "setup_s" for m in BENCH["end_to_end"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(cells) // 4)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
