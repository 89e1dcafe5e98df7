"""A whole run of each cell's traffic at the tiny size on the CPU (the
look for a card skipped): the program against the reference, and the
result's line."""

from __future__ import annotations

import json

import pytest
import torch

from surfbench import harness
from surfbench.tests.tiny import tiny_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checked"]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", ["dtu_val", "dtu_train"])
def test_program_matches_reference_at_tiny_size(cell):
    result, compared = harness.run(tiny_cell(cell), 2 ** 40 + 7, 0.1, 0, device="cpu")
    assert list(result) == KEYS
    json.dumps(result)
    # on the CPU the program runs the kernels' plain versions, as the
    # reference does: every number within its limit, most of them 0
    for name, value, limit in compared:
        assert value <= limit, (name, value, limit)
    assert result["correct"] and result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in tiny_cell(cell)["end_to_end"]}


def test_traced_run_reports_the_per_layer_metrics_it_can_read():
    cell = tiny_cell("dtu_val")
    result, _ = harness.run(cell, 31337, 0.1, 1, device="cpu")
    assert list(result) == KEYS[:5] + ["breakdown", "checked"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(result["device"])
    # no card: no kernel time to read, so no roofline share
    assert "kernel_roofline.val" not in result["metrics"]
    assert {"val_build_s", "val_mesh_s", "val_render_rays_per_s", "mfu.val"} \
        <= set(result["metrics"])
