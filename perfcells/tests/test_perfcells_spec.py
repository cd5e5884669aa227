"""The benchmark's files: every cell, configuration, traffic mix and metric
loads by name, and BENCHMARK.json keeps to the contract's names and units."""

import ast
import json
import os
import re

import pytest

from perfcells import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def cells():
    return sorted(f[:-5] for f in os.listdir(os.path.join(harness.HERE, "cells")))


def test_benchmark_keys_and_paths():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["perfcells"] and b["command"] == ["python3", "perfcells/run.py"]
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("cell", cells())
def test_cell_loads_with_its_files(cell):
    spec = harness.load_cell(cell)
    assert spec["config"]["model"] and spec["traffic"]["data_dir"]
    assert os.path.exists(os.path.join(harness.HERE, "drivers", spec["cell"]["driver"] + ".py"))
    for name in spec["cell"]["per_layer"]:
        reader = harness.metric_reader(name)
        assert callable(reader.read) and UNIT.match(reader.UNIT)
    assert spec["cell"]["limits"]


def test_workloads_match_cells():
    b = bench()
    assert sorted(w["name"] for w in b["workloads"]) == cells()
    configs = {c["name"]: c for c in b["configs"]}
    for w in b["workloads"]:
        spec = harness.load_cell(w["name"])
        assert w["config"] == spec["cell"]["config"] and w["traffic"] == spec["cell"]["traffic"]
        assert w["chips"] == spec["cell"].get("chips", 1) == 1
        assert configs[w["config"]]["file"] == f"perfcells/configs/{w['config']}.json"
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]


def test_metrics_match_readers_and_cells():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    per = {m["name"]: m for m in b["per_layer"]}
    for w in b["workloads"]:
        cell = harness.load_cell(w["name"])["cell"]
        for name, unit in cell["end_to_end"].items():
            assert e2e[name]["unit"] == unit
            assert w["name"] in e2e[name].get("workloads", [w["name"]])
        for name in cell["per_layer"]:
            assert per[name]["unit"] == harness.metric_reader(name).UNIT
            assert w["name"] in per[name]["workloads"]
            assert per[name]["moves"] in cell["end_to_end"]
    assert e2e["setup_s"]["bound"] <= 0.25


def test_names_and_units_keep_to_the_contract():
    b = bench()
    for group in (b["configs"], b["workloads"], b["end_to_end"] + b["per_layer"]):
        assert len({x["name"] for x in group}) == len(group)
    names = [x["name"] for x in b["configs"] + b["workloads"] + b["end_to_end"] + b["per_layer"]]
    names += [w["traffic"] for w in b["workloads"]] + [w["config"] for w in b["workloads"]]
    for n in names:
        assert NAME.match(n), n
    for m in b["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for c in b["configs"]:
        assert 1 <= len(c["source"]) <= 200 and c["reduced"] == []
        assert c["source"] == harness.read_json("configs", c["name"])["source"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _sources(sub=""):
    base = os.path.join(harness.HERE, sub)
    for root, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_nothing_imports_jax_or_the_jax_package():
    for path in _sources():
        for mod in _imports(path):
            assert mod.split(".")[0] not in harness.FORBIDDEN, (path, mod)


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        for mod in _imports(path):
            assert mod.split(".")[0] in ("torch", "numpy", "math", "contextlib", "typing",
                                         "__future__", "perfcells"), (path, mod)
            assert not mod.startswith("perfcells") or mod.startswith("perfcells.reference")
