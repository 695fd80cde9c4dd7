"""``BENCHMARK.json`` against the contract's rules that a file can show:
names, units and lengths, every file it names, and every per-layer
metric's cells reporting the end-to-end metric it moves."""

import json
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
MAN = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ALL = MAN["end_to_end"] + MAN["per_layer"]


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["paths"] == ["gnnbench"]
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for word in MAN["command"]:
        assert 1 <= len(word) <= 200 and not word.startswith("/") and ".." not in word


@pytest.mark.parametrize("entry", MAN["configs"] + MAN["workloads"] + ALL,
                         ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
            assert "\t" not in entry[key]


def test_unique_names():
    for group in (MAN["configs"], MAN["workloads"], ALL):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


def test_entry_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (REPO / c["file"]).is_file() and c["file"].startswith("gnnbench/")
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert (REPO / "gnnbench" / "workloads" / f"{w['name']}.json").is_file()
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                          "moves"}
        assert (REPO / "gnnbench" / "metrics" / f"{m['name']}.py").is_file()


def _cells(metric):
    return metric.get("workloads", [w["name"] for w in MAN["workloads"]])


def test_every_cell_reports_setup_another_and_a_layer():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "workloads" not in e2e["setup_s"]
    for w in MAN["workloads"]:
        name = w["name"]
        assert any(name in _cells(m) for m in MAN["end_to_end"] if m["name"] != "setup_s")
        assert any(name in _cells(m) for m in MAN["per_layer"])


def test_per_layer_cells_report_what_it_moves():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        assert set(_cells(m)) <= set(_cells(e2e[m["moves"]]))
    layers = {m["layer"] for m in MAN["per_layer"]}
    assert layers == {"model step", "device", "kernels", "host prep"}
