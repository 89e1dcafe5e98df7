"""The port's per-scene finetune (``surf_tpu_torch.finetune``) against the
benchmark's plain reference (``surfbench/reference/finetune.py``), on the
CPU at the tiny size of ``surfbench/tests/tiny_finetune.py`` (two stages,
a 96x128 DTU scan written by ``surfbench/dtu_scan.py``, seeded random
weights; no JAX):

* one run of the ``dtu_finetune`` cell's harness: the storages
  ``init_volumes`` built against the reference's cascade, the first three
  steps' loss terms, each leaf's first gradient and its change over the
  three steps, and the step after the window from a copy of the
  finetuner's state (implicit surface, storages, Adam's moments, the
  schedule, the host stream and the generator), each gap at rounding;
* ``next_batch`` draws what the finetune loop drew before it was moved
  into the method (views, rays, pseudo points, bit for bit);
* the spans ``finetune.rays``, ``.render``, ``.loss`` and ``.update``
  recorded under a profiler, and ``storage_grad_rows`` equal to a direct
  count of each storage's non-zero gradient rows there;
* nothing counted while no profiler runs.
"""

import shutil

import numpy as np
import pytest
import torch

from surfbench import harness
from surfbench.tests.tiny_finetune import tiny_finetune_cell
from surfbench.traffic import finetune_step
from surf_tpu_torch.finetune import Finetuner
from surf_tpu_torch.utils import spans

# one intra-op thread: the suite's xdist workers share the host's cores
torch.set_num_threads(1)

SPANS = {"finetune.rays", "finetune.render", "finetune.loss", "finetune.update"}


@pytest.fixture(scope="module")
def checked():
    result, compared = harness.run(tiny_finetune_cell(), 2 ** 33 + 17, 0.3, 0, device="cpu")
    return result, {n: v for n, v, _ in compared}


@pytest.fixture(scope="module")
def finetuner():
    ctx = harness.Ctx(tiny_finetune_cell(), 2 ** 31 + 5, device="cpu", trace=False)
    params, state = finetune_step.prepare(ctx)
    ft = Finetuner(finetune_step.program_conf(ctx), device="cpu", seed=5,
                   base_exp_dir=ctx.out_dir, params=params, state=state)
    yield ft
    shutil.rmtree(ctx.out_dir, ignore_errors=True)


def test_init_volumes_match_the_reference(checked):
    _, n = checked
    assert n["init_active_voxels_gap"] == 0.0
    assert n["init_storage_gap"] <= 1e-6


def test_first_three_steps_match_the_reference(checked):
    _, n = checked
    assert n["loss_gap"] <= 1e-6 and n["loss_terms_gap"] <= 1e-6, n
    assert n["grad_gap"] <= 1e-5 and n["change_gap"] <= 1e-5, n


def test_step_from_a_copy_of_the_state_matches_the_reference(checked):
    result, n = checked
    assert n["steady_loss_gap"] <= 1e-6 and n["steady_loss_terms_gap"] <= 1e-6, n
    assert n["steady_grad_gap"] <= 1e-5 and n["steady_change_gap"] <= 1e-5, n
    assert n["window_nonfinite_steps"] == 0
    assert result["correct"] and result["attempted"] >= 1


def test_next_batch_draws_what_the_loop_drew(finetuner):
    ft, ds = finetuner, finetuner.dataset
    rng = np.random.RandomState()
    rng.set_state(ft.host_rng.get_state())
    # the loop as it stood: the permutation drawn before the first step and
    # again after each round's last
    perm = rng.permutation(ds.num_views)
    expected = []
    for step in range(8):
        expected.append(ds.get_random_rays(int(perm[step % len(perm)]), rng=rng))
        if (step + 1) % len(perm) == 0:
            perm = rng.permutation(ds.num_views)
    for step, want in enumerate(expected):
        got = ft.next_batch(step)
        for k in ("view_ids", "rays_o", "rays_d", "pseudo_pts", "color", "pseudo_depth"):
            have = got[k].numpy()
            np.testing.assert_array_equal(have, np.asarray(want[k], have.dtype),
                                          err_msg=f"step {step} {k}")
    assert rng.randint(2 ** 30) == ft.host_rng.randint(2 ** 30)


def test_nothing_counted_without_a_profiler(finetuner):
    finetuner.step(finetuner.next_batch(0), 0)
    assert finetuner.storage_grad_rows is None


def test_spans_and_grad_rows_recorded_under_a_profiler(finetuner):
    ft = finetuner
    for step in range(2):                 # the storages' gradient is 0 at the first step
        ft.step(ft.next_batch(step), step)
    spans.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        ft.step(ft.next_batch(2), 2)
    assert SPANS <= {name for name, _, _, _ in spans.recorded()}
    direct = [[int((v.grad != 0).any(dim=1).sum()), v.shape[0]]
              for v in ft.vol_state["volumes"]]
    assert ft.storage_grad_rows == direct
    assert any(0 < t < n for t, n in direct), direct
