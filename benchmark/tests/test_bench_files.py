"""BENCHMARK.json against the contract, and every cell's files found by name."""

from __future__ import annotations

import json
import re

import pytest

from conftest import ROOT

from benchmark import registry

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_whys():
    names = [c["name"] for c in BENCH["configs"]] + CELLS
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for entry in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]


def test_configs_resolve_and_are_used():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert registry.load_config(c["name"])["source"] == c["source"]
        assert c["reduced"] == registry.load_config(c["name"])["reduced"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    resolved = registry.resolve(cell)
    c = resolved["cell"]
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert (c["config"], c["chips"], c["why"]) == (entry["config"], entry["chips"], entry["why"])
    assert entry["traffic"] == cell.rsplit(".", 1)[1]  # the traffic mix: after the last dot
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    pl = {m["name"]: m for m in BENCH["per_layer"]}
    assert "setup_s" in c["end_to_end"] and len(c["end_to_end"]) >= 2 and c["per_layer"]
    for name, mod in list(resolved["end_to_end"].items()) + list(resolved["per_layer"].items()):
        spec = e2e.get(name) or pl[name]
        assert mod.UNIT == spec["unit"], name
        assert cell in spec.get("workloads", [cell]), name
    for name, spec in list(e2e.items()) + list(pl.items()):
        if cell in spec.get("workloads", []):
            assert name in c["end_to_end"] + c["per_layer"], (cell, name)
    assert c["limits"], "a cell without limits can never be correct"


def test_bounds_and_per_layer_links():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = set()
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", CELLS)
        layers.add(m["layer"])
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert f"| {layer} |" in perf, layer


def test_unknown_cell_is_refused():
    with pytest.raises(registry.CellError):
        registry.resolve("no-such-model.batch8")
    with pytest.raises(registry.CellError):
        registry.resolve("../BENCHMARK")
