"""BENCHMARK.json against the benchmark's contract, the files it names,
and the harness's imports."""

from __future__ import annotations

import ast
import json
import os
import re

import pytest

from surfbench import manifest
from surfbench.tests.tiny import ROOT, benchmark

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
HERE = os.path.join(ROOT, "surfbench")


def test_top_level_keys_and_limits():
    b = benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["surfbench"]
    assert 1 <= len(b["command"]) <= 32
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    # a full check of 24 cells fits: 2 + 14 runs a cell at run_seconds + 60,
    # 2 x 90 s of compile a cell, 1200 s spare
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(b)) <= 64 * 1024


def test_names_units_and_entries():
    b = benchmark()
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("surfbench/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert w["config"] in {c["name"] for c in b["configs"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    assert len({w["name"] for w in b["workloads"]}) == len(b["workloads"])
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(b["workloads"])


def test_end_to_end_bounds_and_sources():
    b = benchmark()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def _reports(m, cell):
    return "workloads" not in m or cell in m["workloads"]


def test_every_cell_reports_enough_and_moves_are_reported():
    b = benchmark()
    cells = [w["name"] for w in b["workloads"]]
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        for c in m.get("workloads", cells):
            assert c in cells and _reports(e2e[m["moves"]], c)
    for c in cells:
        reported = [m["name"] for m in b["end_to_end"] if _reports(m, c)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(_reports(m, c) for m in b["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in benchmark()["workloads"]])
def test_cell_files_found_by_name(cell):
    c = manifest.cell(benchmark(), cell)
    assert c["workload"]["config"] == c["entry"]["config"]
    assert os.path.exists(os.path.join(HERE, "traffic", c["workload"]["traffic"] + ".py"))
    for m in c["per_layer"]:
        assert callable(manifest.module("metrics", m["name"]).read)
    assert {"model", "train", "inputs", "source", "reduced"} <= set(c["config"])


def test_config_files_hold_their_manifest_entries():
    b = benchmark()
    for c in b["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            data = json.load(f)
        assert data["source"] == c["source"] and data["reduced"] == c["reduced"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    bad = {"jax", "jaxlib", "flax", "surf_tpu"}
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                found = set(_imports(os.path.join(d, f))) & bad
                assert not found, f"{os.path.join(d, f)} imports {found}"


def test_reference_imports_nothing_of_the_program():
    for d, _, files in os.walk(os.path.join(HERE, "reference")):
        for f in files:
            if f.endswith(".py"):
                assert "surf_tpu_torch" not in set(_imports(os.path.join(d, f))), f


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import sys
    from surfbench import harness
    monkeypatch.setitem(sys.modules, "surf_tpu_torch_like", sys)
    assert "surf_tpu" not in harness.forbidden_modules() or "surf_tpu" in sys.modules
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.forbidden_modules()
