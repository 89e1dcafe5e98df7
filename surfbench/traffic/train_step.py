"""Traffic ``train_step``: training steps back to back (a closed loop, one
caller), each the program's ``to_device`` and ``Trainer.step`` on the next
item of a pool of ``pool`` items made in set-up (``n_scenes`` scenes,
reference views around the ring, ``n_rays`` rays each drawn from the
seed).  The learning-rate schedule counts ``steps_per_epoch`` steps an
epoch.

Set-up builds one trainer on weights made from the seed and runs its
first three steps through the window's own call, on items 0, 1 and 2; the
window goes on from step 4 with the same trainer.  Once the window has
closed, the trainer's parameters, batch-norm state, Adam moments and
generator are copied to the host and it runs one step more, on the pool's
next item: a step of the steady state the window ran in.

The check runs the reference on the same items and random draws, twice:
- its first three steps from the seed's weights, against the set-up's:
  the first step's loss and its terms and the batch-norm state its
  forward left, each parameter's first gradient as Adam got it (its first
  moment after step 1, over 1 - beta1), and each parameter's change over
  the three steps;
- one step from the copy (parameters, state, moments and schedule),
  against the step after the window: its loss and terms, the batch-norm
  state, each parameter's gradient as Adam got it (from its first moment
  before and after the step) and each parameter's change.
Parameters whose reference gradient is under a thousandth of the median
parameter's are left out of the changes.  Every step of the window must
give finite loss terms.  The set-up's second and third losses and
batch-norm state are noted beside the numbers, not compared: the
backward's float atomics nudge the parameters, and the cascade's active
voxels with them.
"""

from __future__ import annotations

import contextlib
import math
import statistics
import time

import numpy as np
import torch

from .. import compare, harness, trace
from ..conf import to_hocon
from ..reference import pipeline as ref
from ..scene import Scene, seed_ints

RANGES = ("surfbench.step", "forward", "backward", "update")
CHECK_STEPS = 3
BETA1 = 0.9


def inputs(ctx):
    return {**ctx.config["inputs"]["train_step"], **ctx.workload.get("inputs", {})}


def make_items(ctx, inp):
    n_sc, pool, nv = int(inp["n_scenes"]), int(inp["pool"]), int(inp["n_views"])
    scenes = [Scene(seed_ints(ctx.seed, 1, k)[0], inp["img_hw"], nv) for k in range(n_sc)]
    refs = [(i % n_sc, (i // n_sc) % nv) for i in range(pool)]
    for k, sc in enumerate(scenes):
        views = {(r + j) % nv for s, r in refs if s == k
                 for j in range(int(inp["num_src_view"]) + 1)}
        sc.render_views(sorted(views), workers=4)
    return [scenes[s].item(r, int(inp["num_src_view"]), mode="train",
                           rng=np.random.RandomState(seed_ints(ctx.seed, 6, i)[0]),
                           n_rays=int(inp["n_rays"]), pseudo_seed=seed_ints(ctx.seed, 2, i)[0])
            for i, (s, r) in enumerate(refs)]


def program_conf(ctx, inp):
    from surf_tpu_torch.config import ConfigFactory
    return ConfigFactory.parse_string(to_hocon({
        "general": {"base_exp_dir": ctx.out_dir},
        # a stand-in whose length sets the trainer's steps an epoch; the
        # run feeds its own items
        "train_dataset": {"dataset_name": "SyntheticDataset", "img_hw": [16, 16],
                          "n_scenes": 1, "n_views_total": int(inp["steps_per_epoch"])},
        "train": ctx.config["train"], "model": ctx.config["model"]}))


def prepare(ctx):
    """The inputs and the weights, made from the seed; returns the weights
    on the card."""
    ctx.inp = inputs(ctx)
    ctx.items = make_items(ctx, ctx.inp)
    params, state, _ = ref.init(ctx.config["model"], seed_ints(ctx.seed, 3)[0], ctx.device)
    ctx.weights = (ref.tree_to(params, "cpu"), ref.tree_to(state, "cpu"))
    return params, state


def setup(ctx):
    from surf_tpu_torch.card import set_numerics
    from surf_tpu_torch.train import Trainer
    set_numerics()
    params, state = prepare(ctx)
    inp = ctx.inp
    ctx.t = Trainer(program_conf(ctx, inp), device=ctx.device, seed=seed_ints(ctx.seed, 4)[0],
                    base_exp_dir=ctx.out_dir, params=params, state=state)
    ctx.step_no = 0
    ctx.nonfinite_steps = 0
    ctx.got = {"terms": [], "generators": []}
    for k in range(CHECK_STEPS):                   # warm-up: the check's steps
        ctx.got["generators"].append(ctx.t.generator.get_state())
        ctx.got["terms"].append(step(ctx))
        if k == 0:
            ctx.got["first_grads"] = _grads(
                [None] * len(_leaves(ctx.t.params)), _moments(ctx.t))
            ctx.got["state"] = ref.tree_to(ctx.t.state["reg_network"], "cpu")
    ctx.got["params"] = ref.tree_to(ctx.t.params, "cpu")
    ctx.got["state_3"] = ref.tree_to(ctx.t.state["reg_network"], "cpu")


def _leaves(tree):
    return [t for _, t in ref.named_leaves(tree)]


def _moments(trainer):
    """Adam's (first moment, second moment, step count) of each parameter,
    copied, or None where it has none yet; of the program's trainer or the
    reference's step."""
    st = trainer.optimizer.state
    return [None if p not in st else (st[p]["exp_avg"].detach().clone(),
                                      st[p]["exp_avg_sq"].detach().clone(),
                                      float(st[p]["step"]))
            for p in _leaves(trainer.params)]


def _grads(before, after):
    """Each parameter's gradient as Adam got it in one step, on the host,
    from its first moment before and after the step: None where Adam
    skipped it (its step count did not move)."""
    out = []
    for b, a in zip(before, after):
        if a is None or (b is not None and a[2] == b[2]):
            out.append(None)
        else:
            m = a[0] if b is None else a[0] - BETA1 * b[0]
            out.append((m / (1.0 - BETA1)).cpu())
    return out


def _host(moments):
    return [None if m is None else (m[0].cpu(), m[1].cpu(), m[2]) for m in moments]


def steady_step(ctx, trainer, generator, step_no, run):
    """Copies ``trainer``'s parameters, state and moments and ``generator``
    to the host, runs ``run()`` (step ``step_no``, returning its terms) and
    keeps what the check compares of it in ``ctx.got["steady"]``."""
    before = _moments(trainer)
    got = {"step_no": step_no, "generator": generator.get_state(),
           "params": ref.tree_to(trainer.params, "cpu"),
           "state": ref.tree_to(trainer.state, "cpu"), "moments": _host(before)}
    got["terms"] = run()
    got["grads"] = _grads(before, _moments(trainer))
    got["params_after"] = ref.tree_to(trainer.params, "cpu")
    got["batch_norm"] = ref.tree_to(trainer.state["reg_network"], "cpu")
    ctx.got["steady"] = got


def step(ctx):
    """The window's call: the next pool item to the card, one step."""
    from surf_tpu_torch.validate import to_device
    k = ctx.step_no
    with trace.host_range("surfbench.step"):
        batch = to_device(ctx.items[k % len(ctx.items)], ctx.device)
        terms = ctx.t.step(batch, k / int(ctx.inp["steps_per_epoch"]))
    ctx.step_no += 1
    return terms


@contextlib.contextmanager
def phase_ranges(ctx):
    """The step's forward (``Trainer.loss``), backward (``Tensor.backward``)
    and update (``Trainer.update``) in host ranges that end once the card
    is done (traced runs)."""
    t = ctx.t
    loss, update, backward = t.loss, t.update, torch.Tensor.backward

    def ranged(name, fn):
        def run(*a, **k):
            with trace.host_range(name, sync=ctx.device.type == "cuda"):
                return fn(*a, **k)
        return run
    t.loss, t.update = ranged("forward", loss), ranged("update", update)
    torch.Tensor.backward = ranged("backward", backward)
    try:
        yield
    finally:
        t.loss, t.update = loss, update
        torch.Tensor.backward = backward


def window(ctx, seconds):
    ranges = phase_ranges(ctx) if ctx.trace else contextlib.nullcontext()
    with ranges:
        t0 = time.time()
        while time.time() - t0 < seconds:
            terms = step(ctx)
            ctx.nonfinite_steps += not all(math.isfinite(v) for v in terms.values())
            ctx.units += 1
        ctx.elapsed = time.time() - t0


def end_to_end(ctx):
    return {"train_s_per_step": ctx.elapsed / ctx.units}


def bound_pass(ctx):
    harness.kernel_pass(ctx, lambda: step(ctx))


def release(ctx):
    """The step after the window, then the program freed."""
    steady_step(ctx, ctx.t, ctx.t.generator, ctx.step_no, lambda: step(ctx))
    ctx.got["nonfinite_steps"] = ctx.nonfinite_steps
    del ctx.t


def _norm(t):
    return 0.0 if t is None else float(t.double().norm())


def _loss_gaps(got, ref_terms):
    """(loss gap over the loss, the worst term's gap over the loss)."""
    loss = abs(ref_terms["loss"])
    return (abs(got["loss"] - ref_terms["loss"]) / loss,
            max(abs(got[n] - ref_terms[n]) / loss for n in ref_terms))


def _grad_gap(got, ref_grads):
    """The worst parameter's gap of gradient norms, over the larger of its
    reference norm and the median parameter's; and the parameters whose
    reference gradient is a thousandth of the median's or more."""
    g_ref = [_norm(g) for g in ref_grads]
    g_med = statistics.median(g_ref)
    gap = max(abs(_norm(a) - b) / max(b, g_med) for a, b in zip(got, g_ref))
    return gap, [i for i, g in enumerate(g_ref) if g >= 1e-3 * g_med]


def _change_gap(p0, p_got, p_ref, moved):
    """The worst moved parameter's gap of change norms (from ``p0``), over
    the larger of its reference change and the median one's; and its
    index."""
    d_ref = [_norm(p_ref[i].detach() - p0[i]) for i in moved]
    d_got = [_norm(p_got[i] - p0[i]) for i in moved]
    d_med = statistics.median(d_ref)
    gaps = [abs(a - b) / max(b, d_med) for a, b in zip(d_got, d_ref)]
    return max(gaps), moved[int(np.argmax(gaps))]


def _state_gap(got, ref_state, dev):
    return max(compare.rel_gap(a.to(dev), b) for a, b in zip(_leaves(got), _leaves(ref_state)))


def check(ctx, flops=False):
    """The numbers compared, [(name, value, limit)], and with ``flops`` the
    reference step's model FLOPs (the mean of its first three)."""
    dev, got = ctx.device, ctx.got
    limits = ctx.workload.get("limits", {})
    spe = int(ctx.inp["steps_per_epoch"])
    static = ref.init(ctx.config["model"], 0, "cpu")[2]
    params0 = ref.tree_to(ctx.weights[0], dev)
    names = [n for n, _ in ref.named_leaves(params0)]
    p0 = [t.detach().clone() for t in _leaves(params0)]
    step_ref = ref.TrainStep(params0, ref.tree_to(ctx.weights[1], dev), static,
                             ctx.config["train"], spe)
    terms = []
    counter = harness.model_flops() if flops else contextlib.nullcontext({})
    with counter as fl:
        for k in range(CHECK_STEPS):
            gen = torch.Generator(device=dev)
            gen.set_state(got["generators"][k])
            tk, gk = step_ref.step(ref.to_device(ctx.items[k], dev), k / spe, gen)
            terms.append(tk)
            if k == 0:
                grads1 = gk
                state1 = ref.tree_to(step_ref.state["reg_network"], dev)
    out = {}
    # the set-up's steps.  The first step's loss and terms: their forward
    # starts from the same weights on both sides; the later steps' move with
    # the cascade's active voxels, which the backward's float atomics nudge
    # (noted, not compared)
    out["loss_gap"], out["loss_terms_gap"] = _loss_gaps(got["terms"][0], terms[0])
    ctx.info["loss_gap_3_steps"] = max(_loss_gaps(g, r)[0] for g, r in zip(got["terms"], terms))
    ctx.info["loss_terms_gap_3_steps"] = max(
        _loss_gaps(g, r)[1] for g, r in zip(got["terms"], terms))
    out["grad_gap"], moved = _grad_gap(got["first_grads"], grads1)
    out["change_gap"], worst = _change_gap(p0, _leaves(ref.tree_to(got["params"], dev)),
                                           _leaves(step_ref.params), moved)
    ctx.info["change_left_out"] = [names[i] for i in range(len(names)) if i not in moved]
    ctx.info["change_worst"] = names[worst]
    # the batch-norm state the first step's forward left
    out["batch_norm_gap"] = _state_gap(got["state"], state1, dev)
    ctx.info["batch_norm_gap_3_steps"] = _state_gap(
        got["state_3"], step_ref.state["reg_network"], dev)
    del step_ref, state1, grads1, params0, p0

    # the step after the window, from the copy of its state
    s = got["steady"]
    k = s["step_no"]
    step_ref = ref.TrainStep(ref.tree_to(s["params"], dev), ref.tree_to(s["state"], dev),
                             static, ctx.config["train"], spe)
    step_ref.restore(s["moments"], k)
    p0 = [t.detach().clone() for t in _leaves(step_ref.params)]
    gen = torch.Generator(device=dev)
    gen.set_state(s["generator"])
    tk, gk = step_ref.step(ref.to_device(ctx.items[k % len(ctx.items)], dev), k / spe, gen)
    out["steady_loss_gap"], out["steady_loss_terms_gap"] = _loss_gaps(s["terms"], tk)
    out["steady_grad_gap"], moved = _grad_gap(s["grads"], gk)
    out["steady_change_gap"], worst = _change_gap(
        p0, _leaves(ref.tree_to(s["params_after"], dev)), _leaves(step_ref.params), moved)
    ctx.info["steady_step"] = k
    ctx.info["steady_change_worst"] = names[worst]
    out["steady_batch_norm_gap"] = _state_gap(s["batch_norm"], step_ref.state["reg_network"],
                                              dev)
    out["window_nonfinite_steps"] = got["nonfinite_steps"]
    compared = [(k, float(v), float(limits.get(k, float("nan")))) for k, v in out.items()]
    return compared, (fl["total"] / CHECK_STEPS if flops else None)


def control(ctx):
    """The control's outputs in the program's place: the reference's three
    steps and one more with TF32 on (the precision below the
    configuration's full f32) from the weights ``prepare`` made, drawing
    from a generator seeded from the seed; the fourth stands for the step
    after the window."""
    from .validate import tf32
    dev = ctx.device
    params, state = (ref.tree_to(t, dev) for t in ctx.weights)
    static = ref.init(ctx.config["model"], 0, "cpu")[2]
    spe = int(ctx.inp["steps_per_epoch"])
    step_c = ref.TrainStep(params, state, static, ctx.config["train"], spe)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed_ints(ctx.seed, 4)[0])
    ctx.got = got = {"terms": [], "generators": [], "nonfinite_steps": 0}
    with tf32():
        for k in range(CHECK_STEPS):
            got["generators"].append(gen.get_state())
            terms, grads = step_c.step(ref.to_device(ctx.items[k], dev), k / spe, gen)
            got["terms"].append(terms)
            if k == 0:
                got["first_grads"] = [None if g is None else g.cpu() for g in grads]
                got["state"] = ref.tree_to(step_c.state["reg_network"], "cpu")
        got["params"] = ref.tree_to(step_c.params, "cpu")
        got["state_3"] = ref.tree_to(step_c.state["reg_network"], "cpu")
        item = ref.to_device(ctx.items[CHECK_STEPS % len(ctx.items)], dev)
        steady_step(ctx, step_c, gen, CHECK_STEPS,
                    lambda: step_c.step(item, CHECK_STEPS / spe, gen)[0])


