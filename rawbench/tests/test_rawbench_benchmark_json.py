"""BENCHMARK.json keeps to the contract's shape and characters, and
every name in it finds its file: a configuration, a traffic mix, a
reference, a metric's reader."""

import json
import os
import re

import pytest

from rawbench import harness

ROOT = harness.ROOT
BENCH = harness.load_bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_sizes():
    assert set(BENCH) == KEYS["top"]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert set(e) - {"workloads"} == KEYS[group], e["name"]
    assert 1 <= len(BENCH["configs"]) <= 24
    assert 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_lines_use_the_allowed_characters():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert line(w["why"]) and w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert line(c["why"]) and line(c["source"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for m in BENCH["per_layer"]:
        assert line(m["layer"])
    assert all(line(w) for w in BENCH["command"])
    assert len(BENCH["command"]) <= 32
    assert all(PATH.match(p) for p in BENCH["paths"])


def test_sources_bounds_and_the_cells_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    cells = {w["name"] for w in BENCH["workloads"]}
    for w in cells:
        assert any(w in m.get("workloads", cells) for m in BENCH["per_layer"])
        assert any(w in m.get("workloads", cells) and m["name"] != "setup_s"
                   for m in BENCH["end_to_end"])


def test_the_check_budget_fits_at_24_cells():
    per_check = (2 + 14 * 24) * (BENCH["run_seconds"] + 60) \
        + 24 * 2 * 90 + 1200
    assert per_check <= 43200


def test_every_name_finds_its_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        path = os.path.join(ROOT, c["file"])
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        with open(path) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
        assert os.path.exists(os.path.join(ROOT, "rawbench", "reference",
                                           f"{c['name']}.py"))
        assert cfg["limits"]["max_gap"] is not None
    for w in BENCH["workloads"]:
        assert w["config"] in configs
        assert os.path.exists(os.path.join(ROOT, "rawbench", "traffic",
                                           f"{w['traffic']}.json"))
    for m in BENCH["per_layer"]:
        assert callable(harness.load_reader(m["name"]))
    assert BENCH["command"][1] == "rawbench/run.py"
    assert os.path.exists(os.path.join(ROOT, BENCH["command"][1]))


@pytest.mark.parametrize("group", ["configs", "workloads"])
def test_pairs_are_unique(group):
    if group == "workloads":
        pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
        assert len(pairs) == len(set(pairs))
    else:
        files = [c["file"] for c in BENCH["configs"]]
        assert len(files) == len(set(files))
