"""The manifest against the benchmark's contract, and the data-driven
layout: every name it gives leads to a file of its own.

    python -m pytest perfbench -q
"""
from __future__ import annotations

import json
import re

import pytest

from perfbench import harness

M = harness.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
CELLS = [w["name"] for w in M["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert (harness.CHECKOUT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert M["paths"] == ["perfbench"]
    assert 1 <= len(M["command"]) <= 32
    assert all(LINE.match(w) for w in M["command"])
    assert 1 <= M["run_seconds"] <= 51
    n = 24  # the most cells a later PR may bring
    full = 2 + 14 * n
    assert full * (M["run_seconds"] + 60) + n * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    entries = (M["configs"] + M["workloads"] + M["end_to_end"]
               + M["per_layer"])
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        assert "why" not in e or LINE.match(e["why"])
    for e in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(e["unit"]), e["unit"]
        assert e["better"] in ("lower", "higher")
    for c in M["configs"]:
        assert LINE.match(c["source"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in M["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    for m in M["per_layer"]:
        assert LINE.match(m["layer"])
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))


def test_entries_have_just_their_keys():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_leads_to_its_files(cell):
    c = harness.cell_from_manifest(M, cell)
    assert c.driver.Driver
    assert set(c.limits) and all(v > 0 for v in c.limits.values())
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert harness.metric_path(m["name"]).is_file()


def test_configs_are_used_and_state_their_cuts():
    used = {w["config"] for w in M["workloads"]}
    assert used == {c["name"] for c in M["configs"]}
    files = [c["file"] for c in M["configs"]]
    assert len(files) == len(set(files))
    for c in M["configs"]:
        data = json.loads((harness.CHECKOUT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"]
        assert c["file"].startswith("perfbench/")


def test_every_layer_metric_is_reported_with_what_it_moves():
    by_cell = {w: {m["name"] for m in M["end_to_end"]
                   if w in m.get("workloads", [w])} for w in CELLS}
    for m in M["per_layer"]:
        for w in m.get("workloads", CELLS):
            assert w in by_cell
            assert m["moves"] in by_cell[w], (m["name"], w)


def test_layers_are_named_alike():
    layers = {m["layer"] for m in M["per_layer"]}
    perf = (harness.CHECKOUT / "PERF.md").read_text()
    for layer in layers:
        assert layer in perf, layer
