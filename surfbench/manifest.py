"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<name>`` of ``workloads`` is described by
``surfbench/workloads/<name>.json`` (its configuration's name, its
traffic kind and the traffic's parameters, and the limit of each number
its check compares); a configuration ``<config>`` by
``surfbench/configs/<config>.json``; a traffic kind ``<traffic>`` by the
module ``surfbench/traffic/<traffic>.py``; a per-layer metric ``<metric>``
by the module ``surfbench/metrics/<metric>.py`` (or that of the part of
its name before the first dot).
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def load_benchmark(root):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(kind, name):
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def module(kind, name):
    """The module ``surfbench/<kind>/<name>.py`` (a name may hold dots), or,
    where there is none, that of the name's part before its first dot: one
    reader serves a quantity split by the end-to-end metric it moves
    (``mfu.val`` and ``mfu.train`` read ``metrics/mfu.py``)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.exists(path):
        path = os.path.join(HERE, kind, name.split(".")[0] + ".py")
    spec = importlib.util.spec_from_file_location(f"surfbench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(bench, name):
    """Everything a run of cell ``name`` needs: its ``workloads`` entry,
    its workload and configuration files, and the end-to-end and
    per-layer metrics it reports."""
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise SystemExit(f"no cell named {name!r} in BENCHMARK.json")
    entry = entries[0]
    workload = _json("workloads", name)
    if workload["config"] != entry["config"] or workload["traffic"] != entry["traffic"]:
        raise SystemExit(f"surfbench/workloads/{name}.json disagrees with BENCHMARK.json")

    def reports(m):
        return "workloads" not in m or name in m["workloads"]
    return {"name": name, "entry": entry, "workload": workload,
            "config": _json("configs", entry["config"]),
            "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
            "per_layer": [m for m in bench["per_layer"] if reports(m)]}
