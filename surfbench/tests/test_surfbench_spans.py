"""The readers of the program's spans: traced tiny runs of each kind of
cell on the CPU report them, and the idle reader's arithmetic on a
hand-made trace."""

from __future__ import annotations

import types

import pytest
import torch

from surfbench import harness, manifest
from surfbench.tests.tiny import tiny_cell
from surfbench.trace import Trace

VAL_SPANS = ["val_upload_s", "val_mesh_fill_s", "val_mesh_cubes_s",
             "val_lattice_points_per_s", "val_write_s"]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_traced_validate_run_reports_the_mesh_upload_and_write_spans():
    result, _ = harness.run(tiny_cell("dtu_val"), 2 ** 35 + 11, 0.1, 1, device="cpu")
    assert set(VAL_SPANS) <= set(result["metrics"])
    for name in VAL_SPANS:
        assert result["metrics"][name]["value"] >= 0, name
    assert result["metrics"]["val_lattice_points_per_s"]["value"] > 0


def test_traced_training_run_reports_the_forwards_idle_time_by_span(monkeypatch):
    """Each ``train_idle_ms.<part>`` is read, and is no more than the mean
    wall time a step of the window's ``train.<part>`` spans."""
    from surf_tpu_torch.utils import spans
    windows = []

    class Kept(harness.Trace):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            windows.append(self)
    monkeypatch.setattr(harness, "Trace", Kept)
    spans.clear()
    result, _ = harness.run(tiny_cell("dtu_train"), 2 ** 33 + 5, 0.1, 1, device="cpu")
    tr, steps = windows[0], result["attempted"]
    for part in ("fpn", "cascade", "render", "loss"):
        wall_ms = sum(b - a for n, _, a, b in spans.recorded()
                      if n == "train." + part and tr.t0 <= a and b <= tr.t1) / 1e6 / steps
        idle = result["metrics"][f"train_idle_ms.{part}"]
        assert idle["unit"] == "ms" and 0 < idle["value"] <= wall_ms, (part, idle, wall_ms)


def test_span_idle_reader_takes_each_spans_self_time(monkeypatch):
    """Worked by hand: the card busy over [2, 5] and [7, 8] ms of a window
    [0, 20]; ``train.render`` spans [1, 10] (idle 5 ms) holding a child
    ``inner`` over [6, 9] (idle 2 ms), and [12, 14] (idle 2 ms); two steps:
    (5 - 2 + 2) / 2 = 2.5 ms a step.  A span outside the window is not
    read."""
    from surf_tpu_torch.utils import spans
    ms = 1_000_000
    tr = Trace.__new__(Trace)
    tr.t0, tr.t1, tr.ranges = 0, 20 * ms, []
    tr.ops = [(2 * ms, 5 * ms, "k"), (3 * ms, 4 * ms, "k"), (7 * ms, 8 * ms, "k")]
    records = [("inner", "train.render", 6 * ms, 9 * ms), ("train.render", None, 1 * ms, 10 * ms),
               ("train.render", None, 12 * ms, 14 * ms), ("train.render", None, 19 * ms, 21 * ms),
               ("train.loss", None, 15 * ms, 16 * ms)]
    monkeypatch.setattr(spans, "recorded", lambda: records)
    ctx = types.SimpleNamespace(tr=tr, units=2, info={})
    got = {p: manifest.module("metrics", f"train_idle_ms.{p}").read(ctx)
           for p in ("render", "loss", "fpn")}
    assert got == {"render": 2.5, "loss": 0.5, "fpn": None}
