"""The port's phase timer (``surf_tpu_torch.utils.spans``): its records
while a profiler runs and only then, their parents, their cap, their clock
against the profiler's ranges; a validate's span timings and lattice
counts; ``profile_validate.report``'s busy share and phases."""

import collections
import json
import time

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from tiny_conf import TINY
from surf_tpu_torch import profile_validate
from surf_tpu_torch.config import ConfigFactory
from surf_tpu_torch.ops.sparse import occupied_blocks_host
from surf_tpu_torch.utils import spans
from surf_tpu_torch.utils.spans import span
from surf_tpu_torch.validate import TIMINGS, Validator

# one intra-op thread: the suite's xdist workers share the host's cores
torch.set_num_threads(1)

MESH_RES = 8


@pytest.fixture(autouse=True)
def _fresh_records():
    spans.clear()
    yield
    spans.clear()


def _nested():
    with span("outer"):
        with span("inner.a"):
            time.sleep(0.002)
        with span("inner.b"):
            with span("leaf"):
                time.sleep(0.003)


def test_nothing_is_recorded_without_a_profiler():
    with span("alone") as s:
        time.sleep(0.002)
    assert s.seconds >= 0.002
    assert spans.recorded() == []


def test_nesting_records_each_spans_parent():
    with profile(activities=[ProfilerActivity.CPU]):
        _nested()
    got = spans.recorded()
    # in the order the spans ended
    assert [(n, p) for n, p, _, _ in got] == [
        ("inner.a", "outer"), ("leaf", "inner.b"), ("inner.b", "outer"), ("outer", None)]
    by = {n: (a, b) for n, _, a, b in got}
    for child, parent in (("inner.a", "outer"), ("inner.b", "outer"), ("leaf", "inner.b")):
        assert by[parent][0] <= by[child][0] <= by[child][1] <= by[parent][1]
    # the profiler gone, nothing more is recorded
    _nested()
    assert len(spans.recorded()) == 4


def test_the_cap_drops_the_oldest_records(monkeypatch):
    assert spans.CAP == 100_000 and spans._records.maxlen == spans.CAP
    monkeypatch.setattr(spans, "_records", collections.deque(maxlen=3))
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with span(f"s{i}"):
                pass
    assert [r[0] for r in spans.recorded()] == ["s2", "s3", "s4"]


def test_records_share_the_profilers_clock():
    """Each span's start lies within 1 ms of its range's in the profile,
    and its seconds within 1 ms of the range's duration."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("warm"):                       # the profiler's first range
            pass
        _nested()
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU and e.name() in ("outer", "inner.a", "inner.b",
                                                             "leaf"):
            ranges[e.name()] = (e.start_ns(), e.duration_ns())
    got = [r for r in spans.recorded() if r[0] != "warm"]
    assert sorted(ranges) == sorted(n for n, _, _, _ in got)
    for name, _, a, b in got:
        start, duration = ranges[name]
        assert abs(a - start) < 1e6, (name, a - start)
        assert abs((b - a) - duration) < 1e6, (name, b - a - duration)


def test_span_seconds_match_the_range_duration():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("timed") as s:
            time.sleep(0.01)
    (duration,) = [e.duration_ns() for e in prof.profiler.kineto_results.events()
                   if e.name() == "timed" and e.device_type() == DeviceType.CPU]
    assert s.seconds >= 0.01
    assert abs(s.seconds - duration / 1e9) < 1e-3


@pytest.fixture(scope="module")
def validated(tmp_path_factory):
    spans.clear()
    v = Validator(ConfigFactory.parse_string(TINY), device="cpu", mesh_resolution=MESH_RES,
                  base_exp_dir=str(tmp_path_factory.mktemp("val")))
    with profile(activities=[ProfilerActivity.CPU]):
        (m,) = v.validate()
    return v, m, spans.recorded()


def test_validate_reports_each_span_and_the_lattice_counts(validated):
    v, m, _ = validated
    for k in TIMINGS:
        if k != "clean_mesh_s":
            assert m[k] >= 0, k
    assert m["mesh_lattice_s"] + m["mesh_fill_s"] + m["mesh_cubes_s"] <= m["mesh_s"]
    B = min(64, MESH_RES)
    blocks = occupied_blocks_host(v.last_scene["stages"][::-1], MESH_RES, B)
    assert m["lattice_blocks"] == [int(blocks.sum()), blocks.size]
    assert m["lattice_points"] == int(blocks.sum()) * B ** 3 > 0


def test_validate_spans_nest_as_the_phases_do(validated):
    _, m, got = validated
    parents = {n: p for n, p, _, _ in got}
    assert parents == {"upload": None, "build.fpn": "build", "build.cascade": "build",
                       "build": None, "mesh.lattice": "mesh", "mesh.fill": "mesh",
                       "mesh.cubes": "mesh", "mesh": None, "render": None, "write": None}
    seconds = {n: (b - a) / 1e9 for n, _, a, b in got}
    for name in ("upload", "build", "mesh", "mesh_lattice", "mesh_fill", "mesh_cubes", "write"):
        assert m[name + "_s"] == seconds[name.replace("_", ".")]


class _Event:
    def __init__(self, name, a, b, cuda, annotation=False):
        self._v = (name, a, b, cuda, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def device_type(self):
        return DeviceType.CUDA if self._v[3] else DeviceType.CPU

    def is_user_annotation(self):
        return self._v[4]


def test_report_takes_the_busy_share_from_the_union(monkeypatch, tmp_path, capsys):
    """Two overlapping operations count once; the phases are the given
    ranges and the recorded spans' names; a range's mirror on the device
    timeline is no operation."""
    events = [_Event("step", 0, 10_000_000, False), _Event("mesh.fill", 2_000_000, 6_000_000, False),
              _Event("mesh.fill", 2_000_000, 6_000_000, True, annotation=True),
              _Event("k1", 1_000_000, 4_000_000, True), _Event("k2", 3_000_000, 5_000_000, True),
              _Event("k1", 8_000_000, 9_000_000, True)]
    prof = type("P", (), {"profiler": type("K", (), {"kineto_results": type(
        "R", (), {"events": lambda self: events})()})()})()
    monkeypatch.setattr(spans, "recorded", lambda: [("mesh.fill", None, 0, 0)])
    profile_validate.report(prof, ("step",), 0.01, str(tmp_path), "card")
    lines = [json.loads(line.split(" ", 1)[1]) for line in capsys.readouterr().out.splitlines()]
    whole, step, fill = lines[:3]
    assert whole["busy_s"] == pytest.approx(0.005) and whole["device_s"] == pytest.approx(0.006)
    assert whole["busy_share"] == pytest.approx(0.5)
    assert step["phase"] == "step" and step["busy_share"] == pytest.approx(0.5)
    # k1 starts before the span, k2 inside it; the union covers 3 of its 4 ms
    assert fill["phase"] == "mesh.fill" and fill["count"] == 1
    assert fill["device_s"] == pytest.approx(0.002) and fill["busy_share"] == pytest.approx(0.75)
    assert [k["name"] for k in lines[3:]] == ["k1", "k2"]
    assert (tmp_path / "kernels.txt").read_text().splitlines()[2].split("\t")[:2] == ["k1", "2"]
    assert np.isclose(sum(k["share"] for k in lines[3:]), 1.0)
