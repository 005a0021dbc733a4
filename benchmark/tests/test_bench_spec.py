"""BENCHMARK.json against the contract's shape, and every name found."""

import json
import os
import re

import pytest

import harness

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 << 10


def test_names_units_and_lines():
    entries = (SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"]
               + SPEC["per_layer"])
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
                assert "\t" not in e[key]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[kind]]
        assert len(names) == len(set(names))


def test_every_name_has_its_file():
    for c in SPEC["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in SPEC["workloads"]:
        assert os.path.isfile(os.path.join(BENCH, "workloads",
                                           w["traffic"] + ".json"))
        harness.load_cell(w["name"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(harness.load_metric(m["name"]).value)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_reports_enough(cell):
    e2e = {m["name"] for m in SPEC["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    per = [m for m in SPEC["per_layer"] if cell in m.get("workloads", [cell])]
    assert per
    for m in per:  # a per-layer metric moves an end-to-end metric of its cells
        assert m["moves"] in e2e


def test_bounds():
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
