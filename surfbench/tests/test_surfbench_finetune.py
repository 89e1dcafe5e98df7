"""Runs of the tiny ``dtu_finetune`` cell with the finetune step broken
underneath: each fault turns ``correct`` false, through the number that
should catch it, also where it is planted only once set-up is over.  The
faults are this file's own (``surfbench/faults.py`` holds the other
cells'); the traced run reports the cell's per-layer metrics."""

from __future__ import annotations

import contextlib

import pytest
import torch

from surfbench import harness
from surfbench.tests.tiny_finetune import tiny_finetune_cell
from surfbench.traffic import finetune_step

# the ray-indexed keys of a finetune batch
RAY_KEYS = ("rays_o", "rays_d", "color", "pseudo_depth", "mask")


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def half_the_rays():
    """A step's loss over the first half of its rays only."""
    from surf_tpu_torch.finetune import Finetuner
    orig = Finetuner.loss

    def half(self, batch, *a, **k):
        n = batch["rays_o"].shape[0] // 2
        return orig(self, {key: (v[:n] if key in RAY_KEYS else v) for key, v in batch.items()},
                    *a, **k)
    return _patched(Finetuner, "loss", half)


def storage_grad_zeroed():
    """The finest stage's storage gradient zeroed before Adam."""
    from surf_tpu_torch.finetune import Finetuner
    orig = Finetuner.update

    def zeroed(self):
        self.vol_state["volumes"][-1].grad.zero_()
        return orig(self)
    return _patched(Finetuner, "update", zeroed)


def vol_lr_swapped():
    """The first two stages' learning rates swapped."""
    from surf_tpu_torch.finetune import Finetuner
    orig = Finetuner.update

    def swapped(self):
        groups = self.optimizer.param_groups
        lr = [g["lr"] for g in groups]
        groups[1]["lr"], groups[2]["lr"] = lr[2], lr[1]
        try:
            return orig(self)
        finally:
            groups[1]["lr"], groups[2]["lr"] = lr[1], lr[2]
    return _patched(Finetuner, "update", swapped)


def state_unchanged():
    """A step whose update leaves the implicit surface and the storages as
    they were."""
    from surf_tpu_torch.finetune import Finetuner
    return _patched(Finetuner, "update", lambda self: None)


FAULTS = {"half_the_rays": half_the_rays, "storage_grad_zeroed": storage_grad_zeroed,
          "vol_lr_swapped": vol_lr_swapped, "state_unchanged": state_unchanged}

CAUGHT_BY = {"half_the_rays": "loss_gap", "storage_grad_zeroed": "change_gap",
             "vol_lr_swapped": "change_gap", "state_unchanged": "change_gap"}

# planted after set-up, so that only the window and what follows it run
# broken: the numbers of the step after the window catch it
CAUGHT_AFTER_SETUP_BY = {"half_the_rays": "steady_loss_gap",
                         "storage_grad_zeroed": "steady_grad_gap",
                         "vol_lr_swapped": "steady_change_gap",
                         "state_unchanged": "steady_change_gap"}


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


@pytest.mark.parametrize("fault", sorted(CAUGHT_BY))
def test_fault_turns_correct_false(fault):
    with FAULTS[fault]():
        result, compared = harness.run(tiny_finetune_cell(), 424242, 0.1, 0, device="cpu")
    _caught(result, compared, CAUGHT_BY[fault])


@pytest.mark.parametrize("fault", sorted(CAUGHT_AFTER_SETUP_BY))
def test_fault_after_setup_turns_correct_false(fault, monkeypatch):
    setup = finetune_step.setup
    planted = contextlib.ExitStack()

    def setup_then_fault(ctx):
        setup(ctx)
        planted.enter_context(FAULTS[fault]())
    monkeypatch.setattr(finetune_step, "setup", setup_then_fault)
    with planted:
        result, compared = harness.run(tiny_finetune_cell(), 2 ** 35 + 11, 0.1, 0,
                                       device="cpu")
    _caught(result, compared, CAUGHT_AFTER_SETUP_BY[fault])


def test_loss_not_finite_in_the_window_is_caught(monkeypatch):
    from surf_tpu_torch.finetune import Finetuner
    setup = finetune_step.setup
    planted = contextlib.ExitStack()
    orig = Finetuner.step

    def setup_then_fault(ctx):
        setup(ctx)
        planted.enter_context(_patched(Finetuner, "step", lambda self, *a, **k: {
            **orig(self, *a, **k), "loss": float("nan")}))
    monkeypatch.setattr(finetune_step, "setup", setup_then_fault)
    with planted:
        result, compared = harness.run(tiny_finetune_cell(), 7, 0.1, 0, device="cpu")
    _caught(result, compared, "window_nonfinite_steps")


def test_unbroken_run_is_correct_and_traced_run_reports_its_metrics():
    """The tiny cell unbroken reads ``correct`` true, and a traced run's
    line holds the finetune spans' idle time and the storages' touched
    share (the card's metrics need a card)."""
    result, compared = harness.run(tiny_finetune_cell(), 2 ** 40 + 3, 0.5, 1, device="cpu")
    assert result["correct"], compared
    m = result["metrics"]
    for part in ("rays", "render", "loss", "update"):
        assert m[f"finetune_idle_ms.{part}"]["value"] > 0, part
    assert 0 < m["finetune_grad_row_share"]["value"] <= 100


def test_parent_without_next_batch_fails_at_once(monkeypatch):
    """A program whose finetuner lacks ``next_batch`` stops before set-up
    writes anything."""
    from surf_tpu_torch.finetune import Finetuner
    monkeypatch.delattr(Finetuner, "next_batch")
    monkeypatch.setattr(finetune_step, "prepare", lambda ctx: pytest.fail("set-up ran"))
    with pytest.raises(SystemExit):
        harness.run(tiny_finetune_cell(), 1, 0.1, 0, device="cpu")
