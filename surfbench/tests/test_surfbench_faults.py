"""Runs of the tiny cells with the timed path broken underneath
(surfbench/faults.py): each fault that a cell can have turns ``correct``
false, through the number that should catch it, also where it is planted
only once set-up is over.  (One card: there is no exchange between cards
to leave out.)"""

from __future__ import annotations

import contextlib
import importlib

import pytest
import torch

from surfbench import faults, harness
from surfbench.tests.tiny import tiny_cell

CAUGHT_BY = {
    ("dtu_val", "colour_altered"): "color_gap",
    ("dtu_val", "half_the_rays"): "depth_gap",
    ("dtu_val", "vertices_shifted"): "mesh_vertex_shift",
    ("dtu_val", "storage_altered"): "storage_gap",
    ("dtu_train", "state_unchanged"): "change_gap",
    ("dtu_train", "half_the_batch"): "loss_gap",
    ("dtu_train", "loss_altered"): "loss_gap",
    ("dtu_train", "loss_not_finite"): "window_nonfinite_steps",
}

# planted after set-up, so that only the window and what follows it run
# broken: the numbers of the step after the window catch it
CAUGHT_AFTER_SETUP_BY = {
    ("dtu_val", "colour_altered"): "color_gap",
    ("dtu_train", "state_unchanged"): "steady_change_gap",
    ("dtu_train", "half_the_batch"): "steady_loss_gap",
    ("dtu_train", "loss_altered"): "steady_loss_gap",
    ("dtu_train", "loss_not_finite"): "window_nonfinite_steps",
}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _caught(result, compared, name):
    numbers = {n: (v, lim) for n, v, lim in compared}
    value, limit = numbers[name]
    assert not result["correct"] and not value <= limit, (value, limit)


@pytest.mark.parametrize("cell,fault", sorted(CAUGHT_BY))
def test_fault_turns_correct_false(cell, fault):
    c = tiny_cell(cell)
    with faults.FAULTS[c["workload"]["traffic"]][fault]():
        result, compared = harness.run(c, 424242, 0.1, 0, device="cpu")
    _caught(result, compared, CAUGHT_BY[(cell, fault)])


@pytest.mark.parametrize("cell,fault", sorted(CAUGHT_AFTER_SETUP_BY))
def test_fault_after_setup_turns_correct_false(cell, fault, monkeypatch):
    c = tiny_cell(cell)
    traffic = importlib.import_module(f"surfbench.traffic.{c['workload']['traffic']}")
    setup = traffic.setup
    planted = contextlib.ExitStack()

    def setup_then_fault(ctx):
        setup(ctx)
        planted.enter_context(faults.FAULTS[c["workload"]["traffic"]][fault]())
    monkeypatch.setattr(traffic, "setup", setup_then_fault)
    with planted:
        result, compared = harness.run(c, 2 ** 35 + 11, 0.1, 0, device="cpu")
    _caught(result, compared, CAUGHT_AFTER_SETUP_BY[(cell, fault)])


def test_every_fault_is_tested():
    assert {f for (_, f) in CAUGHT_BY} == {f for d in faults.FAULTS.values() for f in d}
