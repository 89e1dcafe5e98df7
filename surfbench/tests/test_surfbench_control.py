"""The control of each cell's check: the reference itself, computed with
TF32 on (the precision below the configuration's f32), in the program's
place, must come out not correct, on three seeds.  At the tiny size here;
``python -m surfbench.calibrate --control_seeds ...`` reads it at the
cell's own size on the card."""

from __future__ import annotations

import importlib

import pytest
import torch

from surfbench import harness
from surfbench.tests.tiny import benchmark, tiny_cell


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in benchmark()["workloads"]])
def test_control_in_tf32_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: TF32 exists only on the card")
    c = tiny_cell(cell)
    traffic = importlib.import_module(f"surfbench.traffic.{c['workload']['traffic']}")
    for seed in (11, 2 ** 33 + 5, 987654321):
        ctx = harness.Ctx(c, seed, device="cuda", trace=False)
        traffic.prepare(ctx)
        traffic.control(ctx)
        compared, _ = traffic.check(ctx)
        assert any(v > lim for _, v, lim in compared), (seed, compared)
