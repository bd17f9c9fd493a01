"""The manifest resolves to its files by name, and keeps the contract's
shape: names, units and keys."""

from __future__ import annotations

import json
import os
import re

import pytest

from benchmark import harness

ROOT = harness.ROOT
MANIFEST = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"][1].startswith(MANIFEST["paths"][0] + "/")
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    files = harness.resolve(MANIFEST, cell)
    assert os.path.exists(files["driver"])
    assert files["limits"], "a cell compares at least one number"
    cfg = files["config"]
    assert cfg["name"] == files["cell"]["config"]
    ends = harness.metrics_of(MANIFEST, cell, False)
    assert "setup_s" in {m["name"] for m in ends} and len(ends) >= 2
    layers = harness.metrics_of(MANIFEST, cell, True)
    assert layers
    moved = {m["name"] for m in ends}
    for m in layers:
        assert m["moves"] in moved, (m["name"], cell)
        harness.reader(m["name"])  # raises where no reader exists


def test_names_units_and_keys():
    names = set()
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and 1 <= len(c["source"]) <= 200
        assert c["file"].startswith(MANIFEST["paths"][0] + "/")
        assert harness.load_json(os.path.join(ROOT, c["file"]))[
            "reduced"] == c["reduced"]
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k])
    for key, required in (("end_to_end", {"bound"}), ("per_layer",
                                                        {"layer", "moves"})):
        for m in MANIFEST[key]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            assert m["name"] not in names
            names.add(m["name"])
            assert set(m) <= {"name", "unit", "better", "bound", "source",
                              "layer", "moves", "workloads"} and required <= set(m)
            for cell in m.get("workloads", []):
                assert cell in CELLS
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
