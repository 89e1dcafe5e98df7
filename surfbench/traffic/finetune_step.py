"""Traffic ``finetune_step``: SuRF's per-scene finetune, steps back to back
(a closed loop, one caller), each the program's ``Finetuner.next_batch``
and ``Finetuner.step``: ``n_rays`` uniformly random rays of the next view
of the seeded permutation and 2048 pseudo points, the render with ∇sdf and
H·1, the ``finetune`` loss, the backward into the implicit surface and the
four stage storages, and Adam (one group a stage at its ``vol_lr``) under
the conf's schedule.

Set-up renders the procedural scene at the conf's size for the reference
view and its two pair sources and writes it under the run's temporary
directory as a DTU scan (``surfbench/dtu_scan.py``); builds the finetuner
from the conf, as ``main.py --mode finetune`` does, on weights made from
the seed, so that its ``DTUDatasetFinetune`` reads that scan and its
``init_volumes`` runs the one cascade over the three views; copies the
volumes it built to the host; and runs the job's first three steps (the
check's).  The window goes on with the same job from step 4.  Once it has
closed the finetuner's state (the implicit surface, the storages, Adam's
moments, the schedule's count, the host stream, the permutation and the
card's generator) is copied to the host and it runs one step more.

The check runs the reference (``surfbench/reference/finetune.py``):
- its cascade over the scan's arrays against the program's
  ``init_volumes``: each stage's active voxels, and the storage rows of the
  voxels active on both sides;
- its first three steps from the program's volumes, the seed's weights
  and the program's draws: the first step's loss and terms, each leaf's
  first gradient as Adam got it (its first moment over 1 - beta1) and each
  leaf's change over the three steps (leaves whose reference gradient
  stays under a thousandth of the median leaf's at every step left out);
- one step from the copy, against the step after the window: its loss and
  terms, each leaf's gradient as Adam got it and each leaf's change.
Every step of the window must give finite loss terms.  The storages are
leaves like the implicit surface's, each compared by norm.
"""

from __future__ import annotations

import contextlib
import math
import os
import statistics
import time
import types

import numpy as np
import torch

from .. import compare, harness, trace
from ..conf import to_hocon
from ..dtu_scan import write_scan
from ..reference import finetune as ref_ft
from ..reference import pipeline as ref
from ..scene import Scene, seed_ints
from .train_step import _change_gap, _grad_gap, _grads, _host, _loss_gaps, _norm, phase_ranges
from .validate import _grid, tf32

RANGES = ("surfbench.step", "forward", "backward", "update")
CHECK_STEPS = 3


def inputs(ctx):
    return {**ctx.config["inputs"]["finetune_step"], **ctx.workload.get("inputs", {})}


def prepare(ctx):
    """The scan written under the run's directory and the weights, made
    from the seed; returns the weights on the card."""
    ctx.inp = inputs(ctx)
    ft = ctx.config["finetune_dataset"]
    scene = Scene(seed_ints(ctx.seed, 1, 0)[0], ft["img_hw"], int(ctx.inp["n_views"]))
    ctx.scan_root = os.path.join(ctx.out_dir, "dtu")
    ctx.scan = write_scan(ctx.scan_root, scene, ft["scene"], int(ft["ref_view"]),
                          int(ft["num_interval"]), seed_ints(ctx.seed, 2)[0])
    params, state, _ = ref.init(ctx.config["model"], seed_ints(ctx.seed, 3)[0], ctx.device)
    ctx.weights = (ref.tree_to(params, "cpu"), ref.tree_to(state, "cpu"))
    return params, state


def program_conf(ctx):
    from surf_tpu_torch.config import ConfigFactory
    return ConfigFactory.parse_string(to_hocon({
        "general": {"base_exp_dir": ctx.out_dir},
        "finetune_dataset": {**ctx.config["finetune_dataset"], "data_dir": ctx.scan_root},
        "train": ctx.config["train"], "model": ctx.config["model"]}))


def setup(ctx):
    from surf_tpu_torch.card import set_numerics
    from surf_tpu_torch.finetune import Finetuner
    if not hasattr(Finetuner, "next_batch"):
        raise SystemExit("surfbench: the program's Finetuner has no next_batch")
    set_numerics()
    params, state = prepare(ctx)
    ctx.ft = Finetuner(program_conf(ctx), device=ctx.device, seed=seed_ints(ctx.seed, 4)[0],
                       base_exp_dir=ctx.out_dir, params=params, state=state)
    ctx.got = {"vol": _host_volumes(ctx.ft.vol_state)}
    first_steps(ctx)


def _copy(t):
    """A copy of ``t`` on the host (never a view of a leaf that trains on)."""
    return t.detach().to("cpu", copy=True)


def _host_volumes(vs):
    return {"grids": [tuple(_copy(t) for t in g) for g in vs["grids"]],
            "volumes": [_copy(v) for v in vs["volumes"]],
            "matching_volume": _copy(vs["matching_volume"]),
            "features": [_copy(f) for f in vs["features"]]}


def _volumes_to(vol, device):
    """A copy of ``_host_volumes``' dict on ``device``, with reference grids."""
    return {"grids": [_grid(g, device) for g in vol["grids"]],
            "volumes": [v.to(device, copy=True) for v in vol["volumes"]],
            "matching_volume": vol["matching_volume"].to(device),
            "features": [f.to(device) for f in vol["features"]]}


def _leaves(ft):
    """The trained leaves in the optimizer's order: the implicit surface's,
    then each stage's storage."""
    return [p for g in ft.optimizer.param_groups for p in g["params"]]


def _leaf_names(ft):
    names = [n for n, _ in ref.named_leaves(ft.params["implicit_surface"])]
    return names + [f"volume{i}" for i in range(len(ft.vol_state["volumes"]))]


def _moments(ft):
    """Adam's (first moment, second moment, step count) of each leaf,
    copied, or None where it has none yet."""
    st = ft.optimizer.state
    return [None if p not in st else (st[p]["exp_avg"].detach().clone(),
                                      st[p]["exp_avg_sq"].detach().clone(),
                                      float(st[p]["step"]))
            for p in _leaves(ft)]


def _draws(ft):
    """What the next step draws from: the host stream's state, the
    permutation and the card's generator's state."""
    return (ft.host_rng.get_state(), None if ft.perm is None else ft.perm.copy(),
            ft.generator.get_state())


def step(ctx):
    """The window's call: the next batch and one step of the job."""
    k = ctx.step_no
    with trace.host_range("surfbench.step"):
        terms = ctx.ft.step(ctx.ft.next_batch(k), k)
    ctx.step_no += 1
    return terms


def first_steps(ctx):
    """The job's first ``CHECK_STEPS`` steps, keeping what the check
    compares of them."""
    ctx.step_no = 0
    ctx.nonfinite_steps = 0
    got = ctx.got
    got.update(terms=[], draws=[])
    for k in range(CHECK_STEPS):
        got["draws"].append(_draws(ctx.ft))
        got["terms"].append(step(ctx))
        if k == 0:
            got["first_grads"] = _grads([None] * len(_leaves(ctx.ft)), _moments(ctx.ft))
    got["leaves_3"] = [_copy(t) for t in _leaves(ctx.ft)]


def window(ctx, seconds):
    ranges = phase_ranges(types.SimpleNamespace(t=ctx.ft, device=ctx.device)) if ctx.trace \
        else contextlib.nullcontext()
    rows = []
    with ranges:
        t0 = time.time()
        while time.time() - t0 < seconds:
            terms = step(ctx)
            ctx.nonfinite_steps += not all(math.isfinite(v) for v in terms.values())
            counted = getattr(ctx.ft, "storage_grad_rows", None)
            if counted is not None:
                rows.append(counted)
            ctx.units += 1
        ctx.elapsed = time.time() - t0
    ctx.info["storage_grad_rows"] = rows


def end_to_end(ctx):
    return {"train_s_per_step": ctx.elapsed / ctx.units}


def bound_pass(ctx):
    harness.kernel_pass(ctx, lambda: step(ctx))


def steady_step(ctx):
    """The step after the window, from a copy of the job's state."""
    ft = ctx.ft
    before = _moments(ft)
    s = {"step_no": ctx.step_no, "draws": _draws(ft),
         "isf": ref.tree_to(ft.params["implicit_surface"], "cpu"),
         "volumes": [_copy(v) for v in ft.vol_state["volumes"]],
         "moments": _host(before)}
    s["terms"] = step(ctx)
    s["grads"] = _grads(before, _moments(ft))
    s["leaves_after"] = [_copy(t) for t in _leaves(ft)]
    ctx.got["steady"] = s


def release(ctx):
    """The step after the window, then the program freed."""
    steady_step(ctx)
    ctx.got["nonfinite_steps"] = ctx.nonfinite_steps
    ctx.got["names"] = _leaf_names(ctx.ft)
    del ctx.ft


def _replay(data, step_ref, k, draws, device):
    """The reference's step ``k`` from the program's ``draws``."""
    rng = np.random.RandomState()
    rng.set_state(draws[0])
    gen = torch.Generator(device=device)
    gen.set_state(draws[2])
    batch, _ = data.batch(k, draws[1], rng, device)
    return step_ref.step(batch, k, gen)


def check(ctx, flops=False):
    """The numbers compared, [(name, value, limit)], and with ``flops`` the
    reference step's model FLOPs (the mean of its first three)."""
    dev, got = ctx.device, ctx.got
    limits = ctx.workload.get("limits", {})
    train = ctx.config["train"]
    params, state = (ref.tree_to(t, dev) for t in ctx.weights)
    static = ref.init(ctx.config["model"], 0, "cpu")[2]
    data = ref_ft.FinetuneData(ctx.scan, ctx.config["finetune_dataset"])
    names = got["names"]
    out = {}
    # the one cascade of init_volumes
    vol_ref = ref_ft.init_volumes(params, state, static, data, dev)
    gaps = [compare.stage_gaps((_grid(g, dev), s.to(dev)), (g_ref, s_ref))
            for g, s, g_ref, s_ref in zip(got["vol"]["grids"], got["vol"]["volumes"],
                                          vol_ref["grids"], vol_ref["volumes"])]
    out["init_active_voxels_gap"] = max(a for a, _ in gaps)
    out["init_storage_gap"] = max(b for _, b in gaps)
    ctx.info["init_matching_gap"] = compare.rel_gap(got["vol"]["matching_volume"].to(dev),
                                                    vol_ref["matching_volume"])
    del vol_ref, gaps

    # the set-up's steps, from the program's volumes and draws
    vol = _volumes_to(got["vol"], dev)
    step_ref = ref_ft.FinetuneStep(params["implicit_surface"], static, vol, train)
    p0 = [t.detach().clone() for t in step_ref.leaves]
    terms, grads = [], []
    counter = harness.model_flops() if flops else contextlib.nullcontext({})
    with counter as fl:
        for k in range(CHECK_STEPS):
            tk, gk = _replay(data, step_ref, k, got["draws"][k], dev)
            terms.append(tk)
            grads.append([_norm(g) for g in gk])
            if k == 0:
                grads1 = gk
    out["loss_gap"], out["loss_terms_gap"] = _loss_gaps(got["terms"][0], terms[0])
    ctx.info["loss_gap_3_steps"] = max(_loss_gaps(g, r)[0] for g, r in zip(got["terms"], terms))
    out["grad_gap"], _ = _grad_gap(got["first_grads"], grads1)
    g_max = [max(g) for g in zip(*grads)]
    g_med = statistics.median(g_max)
    moved = [i for i, g in enumerate(g_max) if g >= 1e-3 * g_med]
    out["change_gap"], worst = _change_gap(p0, [t.to(dev) for t in got["leaves_3"]],
                                           step_ref.leaves, moved)
    ctx.info["change_left_out"] = [names[i] for i in range(len(names)) if i not in moved]
    ctx.info["change_worst"] = names[worst]
    del step_ref, grads1, p0

    # the step after the window, from the copy of the job's state
    s = got["steady"]
    k = s["step_no"]
    vol["volumes"] = [v.to(dev, copy=True) for v in s["volumes"]]
    step_ref = ref_ft.FinetuneStep(ref.tree_to(s["isf"], dev), static, vol, train)
    step_ref.restore(s["moments"], k)
    p0 = [t.detach().clone() for t in step_ref.leaves]
    tk, gk = _replay(data, step_ref, k, s["draws"], dev)
    out["steady_loss_gap"], out["steady_loss_terms_gap"] = _loss_gaps(s["terms"], tk)
    out["steady_grad_gap"], moved = _grad_gap(s["grads"], gk)
    out["steady_change_gap"], worst = _change_gap(
        p0, [t.to(dev) for t in s["leaves_after"]], step_ref.leaves, moved)
    ctx.info["steady_step"] = k
    ctx.info["steady_change_worst"] = names[worst]
    out["window_nonfinite_steps"] = got["nonfinite_steps"]
    compared = [(n, float(v), float(limits.get(n, float("nan")))) for n, v in out.items()]
    return compared, (fl["total"] / CHECK_STEPS if flops else None)


class _Control:
    """The reference in the program's place, behind the finetuner's
    interface: its cascade and steps with TF32 on, its host stream and
    generator seeded as the program's are."""

    def __init__(self, ctx):
        dev = ctx.device
        params, state = (ref.tree_to(t, dev) for t in ctx.weights)
        static = ref.init(ctx.config["model"], 0, "cpu")[2]
        self.data = ref_ft.FinetuneData(ctx.scan, ctx.config["finetune_dataset"])
        self.vol_state = ref_ft.init_volumes(params, state, static, self.data, dev)
        self.params = {"implicit_surface": params["implicit_surface"]}
        self.step_ref = ref_ft.FinetuneStep(self.params["implicit_surface"], static,
                                            self.vol_state, ctx.config["train"])
        self.optimizer = self.step_ref.optimizer
        seed = seed_ints(ctx.seed, 4)[0]
        self.host_rng = np.random.RandomState(seed)
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(seed + 1)
        self.perm = None
        self.device = dev

    def next_batch(self, k):
        batch, self.perm = self.data.batch(k, self.perm, self.host_rng, self.device)
        return batch

    def step(self, batch, k):
        return self.step_ref.step(batch, k, self.generator)[0]


def control(ctx):
    """The control's outputs in the program's place: the reference's
    cascade, its three steps and one more, all with TF32 on (the precision
    below the configuration's full f32), from the weights and the scan
    ``prepare`` made; the fourth step stands for the step after the
    window."""
    with tf32():
        ctx.ft = _Control(ctx)
        ctx.got = {"vol": _host_volumes(ctx.ft.vol_state)}
        first_steps(ctx)
        release(ctx)
