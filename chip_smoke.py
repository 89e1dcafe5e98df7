#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero, with no result line):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: the eight hand-written kernels (surf_tpu_torch/csrc/*.cu: K1-K4
   and the backward kernels K1b-K3b and K4w) with nvcc for sm_90a, one
   process per source, in parallel;
3. ragged: every kernel against its plain PyTorch version on odd shapes
   with out-of-range points; K1 and K1b also at every channel count their
   kernels specialise and two they do not, with all-zero cotangent rows
   and a pile-up of points on one texel; K4 and K4w also at every width
   of the path, on ragged shapes and extreme tables, with and without a
   live-row mask, K4 twice bit for bit;
4. validate: the port's main path, ``Validator.validate`` on
   confs/surf_synthetic_full.conf (4-stage cascade 88^3 -> 704^3, 512^3
   mesh, 144x200 render) with seeded random weights; every kernel's
   launch count is zeroed just before and read just after, and must be
   > 0; K2's and K3's calls are also counted by call site.  This first
   call in the process is cold;
5. warm: a second validate, for warm metrics, with every gather_conv call
   of ``apply_hybrid`` recorded; its cascade must equal the first one's
   bit for bit;
6. kernels: K1-K4 against their plain versions at their validate call
   sites (the validate's own stages, volumes, images and recorded K4
   inputs), with the card's time (CUDA events around back-to-back calls
   queued behind a sleep kernel, so the host's time to issue a call is
   not counted: ``time_ms``) of the kernel, the plain version and, where
   one PyTorch call computes the same function, that call, and the
   bound: the bytes the function must read and write (each distinct
   texel, voxel or row once) at the card's memory rate, or its f32
   operations at the card's peak, whichever takes longer.  K1's entries
   also say how their points fall on the image (``data``).  K2 and K3
   must equal their plain versions bit for bit (K3's occupancy exactly);
   K4's and K4w's entries say what their table holds (``data``: present
   pairs, rows with a present tap, rows their live-row mask keeps) and,
   where the path passes a mask, the time without it:
   K2 at build_z_vals and depth_render, K3 at the render chunk, the mesh
   lattice's first call (recorded in the warm validate) and, in its
   training variant, the training step's render shape.  Then the
   grid-form convs (row 7: the four ops indexed through the voxel and
   parent tables, which no path calls) on the warm validate's own 352^3
   and 704^3 grids and recorded inputs: forward, dX and dW by K4/K4w
   against their plain versions, each op's value equal to the
   neighbour-row K4 call on the same input on live rows;
7. train: the port's training path, a ``Trainer`` on the same
   configuration at full width (5 views of 480x640, 512 rays, 4 stages
   to 704^3), 3 steps: one cold, two warm.  Every kernel's launch count
   is zeroed just before the steps and read just after; the backward
   kernels must each have run.  The loss must be finite and the
   parameters of both optimizer groups must move.  Prints s/step and the
   peak memory.  The largest call of each kind of each backward kernel
   in the last step is recorded (K2b's and K3b's of each kind at each
   call site: K2b by volume, 88^3 to 704^3, K3b by the cotangents it
   takes), and K4's largest forward and largest dX call (launches by call
   site: forward / dX at 352^3 / 704^3); K1b, K2b, K3b, K4w and those K4
   calls are then held against their plain versions and measured on
   those calls as in 6.
   K1b's entries give the share of all-zero cotangent rows (whose
   scatter the kernel skips) and the most points on one texel; its row
   also times its largest call again with a random cotangent on every
   row, as a trained model's denser stage would give.  K2b's entries give
   the distinct voxels and 8^3 bricks touched, the share of all-zero
   cotangent rows, the share of corner scatters merged before an atomic
   and the time of each form (single pass, bricked); K3b's the distinct
   rows touched a stage, the merged share and the kernel's time without
   the wrapper's zero fill (``ms_kernel_only``, ``ms_zero_fill``).
   The trainer saves its checkpoint;
8. finetune: a ``Finetuner`` on confs/surf_synthetic_finetune.conf (5
   views of 576x800, 512 rays, 4 stages to 704^3) resumes from that
   checkpoint as ``--resume`` does, in a temporary directory the phase
   deletes; ``init_volumes``, then 3 steps (one cold, two warm) with every
   launch count zeroed before them: K3 and K3b must have run, the loss
   must be finite and the implicit surface and every stage's storage
   must move; K3b is held against its plain version at each kind of call
   of the last step and measured as in 7.  Then one ``validate_finetune``
   (512^3 mesh, non-empty) and a ``save_finetune`` read back as
   ``--load_vol`` reads it, bit for bit (the bf16 matching volume
   included).  Prints s/step, peak memory,
   ``mesh_s`` and ``render_rays_per_s``;
9. reference: the tiny model on the card against the same model on the
   CPU (plain versions, themselves held against the JAX package by the
   tier-1 tests): a validate build + render, and one training step's
   loss terms and gradients, also against the same step on the card with
   every kernel swapped for its plain version.

No path calls the grid-form convs: their row's ``launches`` counts the
calls of the four ops during the validate, train and finetune phases
(0).  The last three lines are the kernels JSON, the nvidia-smi line and
the result line ``{"ok": true, "device": {...}}``.  The port's numeric settings
(``surf_tpu_torch.card.set_numerics``: no TF32) hold in every phase, so
all comparisons are in full f32.
"""

from __future__ import annotations

import contextlib
import inspect
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12            # f32 outside the tensor cores

TINY = """
general { base_exp_dir = ./exp/tiny }
train_dataset {
    dataset_name = SyntheticDataset
    num_src_view = 2
    img_hw = [64, 80]
    n_rays = 64
    n_scenes = 2
    n_views_total = 6
}
val_dataset {
    dataset_name = SyntheticDataset
    num_src_view = 2
    img_hw = [64, 80]
    val_res_level = 4
    n_scenes = 1
    n_views_total = 6
}
train {
    val_ray_chunk = 4096
    lr_conf { feat_lr = 1e-3  mlp_lr = 5e-4 }
    epochs = 2
    anneal_end = 1
    warmup = 1
    alpha = 0.02
    save_freq = 1
    val_freq = 10
    loss {
        color_weight = 1.0
        sparse_weight = 0.02
        igr_weight = 0.1
        sparse_scale_factor = 100
        mfc_weight = 1.0
        smooth_weight = 0.0001
        depth_weight = 0.0
        ptloss_weight = 1.0
        pseudo_auxi_depth_weight = 1.0
        pseudo_sdf_weight = 1.0
        stage_weights = [0.5, 1.0]
        pseudo_depth_weight = 1.0
    }
}
model {
    range_ratios = [1.0, 0.4]
    feature_network { d_in = 3  d_base = 8  d_out = [4, 4] }
    volume {
        base_volume_dim = [16, 16, 16]
        stage_parent_capacity = [512, 1024]
    }
    reg_network { d_in = [8, 16]  d_base = [8, 8]  d_out = [8, 8] }
    matching_field { n_samples_depths = [16, 8]  depth_res_levels = [4, 2] }
    implicit_surface {
        sdf_network {
            d_out = 129
            d_in = 3
            d_hidden = 128
            n_layers = 6
            skip_in = [3]
            multires = 4
            bias = 0.5
            scale = 1.0
            geometric_init = True
            weight_norm = True
            feat_channels = 14
            feat_multires = 0
        }
        color_network { d_feature = 8 }
        variance_network { init_val = 0.3 }
        render {
            n_samples = [16, 8]
            sample_ranges = [1.0, 0.4]
            n_depth = 32
            perturb = 1.0
        }
    }
}
"""


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def time_ms(fn, iters=10, warmup=2, rounds=3):
    """The card's time for one call of ``fn``: the median over ``rounds``
    of ``iters`` back-to-back calls between two CUDA events, each round
    queued behind a sleep kernel that lasts longer than the host takes to
    issue the round.  The events then see the card's time alone: around a
    single call they would also count the host's time to issue it (a
    wrapper's Python and ctypes call, tens of microseconds), which is most
    of what a short kernel seems to take.  Inputs stay as the calls leave
    them in the 50 MB L2, for the kernel and its yardsticks alike."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    sleep_s = min(0.1, 2.0 * iters * host_s + 1e-4)
    times = []
    for _ in range(rounds):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(sleep_s * 2e9))          # clock cycles, <= 2 GHz
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / iters)
    return statistics.median(times)


def nbytes(t):
    return t.numel() * t.element_size()


def bound(bytes_moved, flops):
    t_b = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_f = flops / F32_FLOPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def check_close(name, got, ref, rtol, atol):
    import torch
    got, ref = got.float(), ref.float()
    if got.shape != ref.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite kernel output")
    err = (got - ref).abs()
    lim = atol + rtol * ref.abs()
    if (err > lim).any():
        fail(f"{name}: max abs err {err.max().item():.3e} beyond "
             f"atol {atol:.1e} + rtol {rtol:.1e} * |ref|")
    return err.max().item() if err.numel() else 0.0


# ---------------------------------------------------------------------------
# phase 3: ragged shapes
# ---------------------------------------------------------------------------

def ragged_checks(dev):
    import torch
    from surf_tpu_torch.ops import grid_sample as gs, sparse as sp
    from surf_tpu_torch.nn import reg_net
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    out = []
    for align in (True, False):
        img = torch.randn(3, 37, 53, 5, device=dev, generator=g)
        co = torch.rand(3, 1001, 2, device=dev, generator=g) * 2.6 - 1.3
        e = check_close("K1 ragged", gs.bilinear_sample(img, co, align_corners=align),
                        gs.bilinear_sample_plain(img, co, align_corners=align), 1e-5, 1e-5)
        out.append(e)
        px = torch.rand(3, 77, 2, device=dev, generator=g) * 70 - 8
        out.append(check_close("K1 pixel coords",
                               gs.bilinear_sample(img, px, normalized=False),
                               gs.bilinear_sample_plain(img, px, normalized=False),
                               1e-5, 1e-5))
        for dt in (torch.float32, torch.bfloat16):
            vol = torch.randn(13, 9, 11, 3, device=dev, generator=g).to(dt)
            pts = torch.rand(2003, 3, device=dev, generator=g) * 2.5 - 1.25
            # K2 and K3 are equal bit for bit to their plain versions
            out.append(check_close(
                f"K2 ragged {dt}", gs.trilinear_sample(vol, pts, align_corners=align),
                gs.trilinear_sample_plain(vol, pts, align_corners=align), 0.0, 0.0))
    # K3: 1 to 4 stages of random sparse grids
    stages = []
    for res, keep, C in ((32, 0.3, 7), (16, 0.5, 5), (8, 0.7, 3), (4, 0.9, 2)):
        half = res // 2
        r = torch.arange(half, device=dev)
        allp = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
        parents = allp[torch.rand(len(allp), device=dev, generator=g) < keep]
        pvalid = torch.ones(len(parents), dtype=torch.bool, device=dev)
        cvalid = torch.rand(len(parents) * 8, device=dev, generator=g) < 0.8
        grid = sp.make_grid(parents, pvalid, cvalid, res)
        storage = torch.randn(len(parents) * 8, C, device=dev, generator=g) \
            * cvalid[:, None]
        stages.append((grid, storage.contiguous()))
    pts3 = torch.rand(3001, 3, device=dev, generator=g) * 2.3 - 1.15
    for ns in (1, 4):
        got = sp.sparse_trilinear_multi(stages[:ns], pts3, derivs=True)
        ref = sp.sparse_trilinear_multi_plain(stages[:ns], pts3, derivs=True)
        if not torch.equal(got[1], ref[1]):
            fail("K3 ragged: occupancy differs")
        for name, a, b in zip(("feats", "jac", "hmix"), (got[0], got[2], got[3]),
                              (ref[0], ref[2], ref[3])):
            out.append(check_close(f"K3 ragged {name}", a, b, 0.0, 0.0))
    got = sp.sparse_trilinear_multi(stages, pts3, third=True)
    ref = sp.sparse_trilinear_multi_plain(stages, pts3, third=True)
    if not torch.equal(got[1], ref[1]):
        fail("K3 training variant: occupancy differs")
    for name, a, b in zip(("feats", "jac", "hmix", "third"), got[:1] + got[2:],
                          ref[:1] + ref[2:]):
        out.append(check_close(f"K3 training variant {name}", a, b, 0.0, 0.0))
    # K4: odd channel counts, misses (-1)
    x = torch.randn(1003, 13, device=dev, generator=g)
    idx = torch.randint(-1, 1003, (2011, 27), device=dev, generator=g).to(torch.int32)
    w = torch.randn(27, 13, 7, device=dev, generator=g)
    out.append(check_close("K4 ragged", reg_net.gather_conv(x, idx, w),
                           reg_net.gather_conv_plain(x, idx, w), 1e-4, 1e-4))
    out.append(k4_shapes_check(dev, g))
    # backward kernels (f32 atomics: sums in a run-dependent order)
    for align in (True, False):
        img = torch.randn(3, 37, 53, 5, device=dev, generator=g)
        co = torch.rand(3, 1001, 2, device=dev, generator=g) * 2.6 - 1.3
        ct = torch.randn(3, 1001, 5, device=dev, generator=g)
        for a, b in zip(gs.bilinear_sample_bwd(img, co, ct, align_corners=align),
                        gs.bilinear_sample_bwd_plain(img, co, ct, align_corners=align)):
            out.append(check_close("K1b ragged", a, b, 1e-5, 1e-5 * scale(b)))
        for dt in (torch.float32, torch.bfloat16):
            vol = torch.randn(13, 9, 11, 3, device=dev, generator=g).to(dt)
            pts = torch.rand(2003, 3, device=dev, generator=g) * 2.5 - 1.25
            ct = torch.randn(2003, 3, device=dev, generator=g)
            for a, b in zip(gs.trilinear_sample_bwd(vol, pts, ct, align_corners=align),
                            gs.trilinear_sample_bwd_plain(vol, pts, ct, align_corners=align)):
                # a bf16 gradient may round to the neighbouring bf16 value
                out.append(check_close(f"K2b ragged {dt}", a, b,
                                       2.0 ** -7 if b.dtype == torch.bfloat16 else 1e-5,
                                       1e-5 * scale(b)))
    # K2b's two forms of a bf16 volume's gradient (where the wrapper has
    # them), C = 1 and 3: a band of ray-ordered samples in a few bricks,
    # samples on and past the volume's faces
    if "bricked" in inspect.signature(gs.trilinear_sample_bwd).parameters:
        for C in (1, 3):
            vol = torch.randn(37, 21, 40, C, device=dev, generator=g).bfloat16()
            t = torch.linspace(0.0, 1.0, 64, device=dev)
            o = torch.rand(41, 1, 3, device=dev, generator=g) * 0.3 - 0.9
            band = (o + t[None, :, None] * torch.tensor([0.2, 0.1, 0.35], device=dev))
            pts = torch.cat([band.reshape(-1, 3),
                             torch.rand(333, 3, device=dev, generator=g) * 2.4 - 1.2])
            ct = torch.randn(pts.shape[0], C, device=dev, generator=g)
            ref = gs.trilinear_sample_bwd_plain(vol, pts, ct, need_coords=False)[0]
            for bricked in (False, True):
                got = gs.trilinear_sample_bwd(vol, pts, ct, need_coords=False,
                                              bricked=bricked)[0]
                out.append(check_close(f"K2b C={C} bricked={bricked}", got, ref, 2.0 ** -7,
                                       1e-5 * scale(ref)))
    n, C = pts3.shape[0], sum(s.shape[1] for _, s in stages)
    cts = [torch.randn(*sh, device=dev, generator=g)
           for sh in ((n, C), (n, 3, C), (n, 3, C), (n, C))]
    for a, b in zip(sp.sparse_trilinear_multi_bwd(stages, pts3, *cts),
                    sp.sparse_trilinear_multi_bwd_plain(stages, pts3, *cts)):
        out.append(check_close("K3b ragged", a, b, 1e-5, 1e-5 * scale(b)))
    out.append(k1_shapes_check(dev, g))
    ct = torch.randn(2011, 7, device=dev, generator=g)
    ref = reg_net.gather_conv_dw_plain(x, idx, ct)
    out.append(check_close("K4w ragged", reg_net.gather_conv_dw(x, idx, ct), ref, 1e-4,
                           1e-4 * scale(ref)))
    return max(out)


def k4_shapes_check(dev, g):
    """K4 and K4w against their plain versions at every (Cin, Cout) of the
    path and on ragged shapes (T < 27; Cin 1, 5, 13, 32; R no multiple of
    the 32-row group; x off its 16-byte alignment) and extreme tables (all
    -1, one input row read by every row and tap, every tap present), each
    with and without a live-row mask that also leaves out rows holding
    taps (those read nothing); K4 twice on the same inputs, bit for bit.
    (Where the wrappers take no mask, as earlier versions of the port's
    did, only the unmasked calls.)"""
    import inspect
    import torch
    from surf_tpu_torch.nn import reg_net
    masks = ["live" in inspect.signature(reg_net.gather_conv).parameters]
    masks = [False, True] if masks[0] else [False]
    errs = []
    cases = [(27, ci, co, "random") for ci, co in ((16, 8), (8, 16), (16, 16), (16, 32),
                                                   (32, 16))]
    cases += [(8, 5, 7, "random"), (27, 1, 3, "random"), (13, 13, 1, "random"),
              (27, 32, 32, "random"), (27, 16, 8, "empty"), (27, 16, 8, "one row"),
              (27, 16, 8, "full"), (27, 16, 8, "unaligned")]
    M, R = 517, 1001
    for T, ci, co, kind in cases:
        live = torch.rand(R, device=dev, generator=g) < 0.5
        if kind == "empty":
            idx = torch.full((R, T), -1, dtype=torch.int32, device=dev)
        elif kind == "one row":
            idx = torch.full((R, T), 3, dtype=torch.int32, device=dev)
        else:
            idx = torch.randint(0, M, (R, T), device=dev, generator=g).to(torch.int32)
            if kind != "full":
                keep = (torch.rand(R, T, device=dev, generator=g) < 0.5) & live[:, None]
                idx = torch.where(keep, idx, torch.full_like(idx, -1))
                live &= torch.rand(R, device=dev, generator=g) < 0.8
        x = torch.randn(M * ci + 1, device=dev, generator=g)
        x = x[1:] if kind == "unaligned" else x[:-1]
        x = x.reshape(M, ci)
        w = torch.randn(T, ci, co, device=dev, generator=g)
        ct = torch.randn(R, co, device=dev, generator=g)
        for masked in masks:
            lv = (live,) if masked else ()
            what = f"T {T}, {ci} -> {co}, {kind}, mask {masked}"
            got = reg_net.gather_conv(x, idx, w, *lv)
            if not torch.equal(got, reg_net.gather_conv(x, idx, w, *lv)):
                fail(f"K4 {what}: two calls differ")
            ref = reg_net.gather_conv_plain(x, idx, w, *lv)
            errs.append(check_close(f"K4 {what}", got, ref, 1e-4, 1e-4 * scale(ref)))
            ref = reg_net.gather_conv_dw_plain(x, idx, ct, *lv)
            errs.append(check_close(f"K4w {what}", reg_net.gather_conv_dw(x, idx, ct, *lv),
                                    ref, 1e-4, 1e-4 * scale(ref)))
    return max(errs)


def k1_shapes_check(dev, g):
    """K1 and K1b against their plain versions at every channel count the
    kernels specialise (1, 3, 4, 19) and two they do not (5, 32), on
    points partly outside the image, with a cotangent whose rows are zero
    one in three (K1b skips their scatter), and on a pile-up (every point
    on the same 4 texels), each (d_image, d_coords) combination."""
    import torch
    from surf_tpu_torch.ops import grid_sample as gs
    errs = []
    for C in (1, 3, 4, 5, 19, 32):
        img = torch.randn(2, 29, 41, C, device=dev, generator=g)
        spread = torch.rand(2, 777, 2, device=dev, generator=g) * 2.6 - 1.3
        pile = torch.tensor([0.137, -0.261], device=dev) \
            + torch.rand(2, 777, 2, device=dev, generator=g) * 0.005
        for what, co in (("spread", spread), ("pile-up", pile)):
            errs.append(check_close(f"K1 C={C} {what}", gs.bilinear_sample(img, co),
                                    gs.bilinear_sample_plain(img, co), 1e-5, 1e-5))
            ct = torch.randn(2, 777, C, device=dev, generator=g)
            ct[:, ::3] = 0.0
            for need in ((True, True), (True, False), (False, True)):
                kw = dict(need_images=need[0], need_coords=need[1])
                for a, b in zip(gs.bilinear_sample_bwd(img, co, ct, **kw),
                                gs.bilinear_sample_bwd_plain(img, co, ct, **kw)):
                    if b is not None:
                        errs.append(check_close(f"K1b C={C} {what} {need}", a, b, 1e-5,
                                                1e-5 * scale(b)))
    return max(errs)


def scale(t):
    """max(1, max |t|): the size against which a sum's rounding is stated."""
    return max(t.abs().max().item() if t.numel() else 0.0, 1.0)


# ---------------------------------------------------------------------------
# phase 5: a warm validate, with apply_hybrid's gather_conv calls recorded
# ---------------------------------------------------------------------------

# apply_hybrid's six gather_conv calls, in order: what each computes and
# the index bytes the convolution needs.  The JAX ops read the (P, 27)
# parent-neighbour table (plus cvalid for conv0); conv9 needs only the
# parent coordinates.  The port's (P*8, 27) child tables are its own
# layout, not work the function must do.
K4_CALLS = (("conv0 children -> children", lambda P: P * 27 * 4 + P * 8),
            ("conv1 children -> parents", lambda P: P * 27 * 4),
            ("conv2 parents -> parents", lambda P: P * 27 * 4),
            ("conv3 parents -> R/4 cells", lambda P: P * 27 * 4),
            ("conv9 R/4 cells -> parents", lambda P: P * 3 * 4),
            ("conv11 parents -> children", lambda P: P * 27 * 4))


def warm_validate(v):
    """A second ``validate`` (kernels loaded, allocator grown) with every
    K4 call of ``apply_hybrid`` recorded as (grid, call index, x, idx, w,
    live-row mask or None),
    and the (stages, points) of the first value-only K3 call: the mesh
    lattice's first ``blocks_per_call`` occupied blocks.  The wrappers are
    the port's own; only the recording is added."""
    from surf_tpu_torch.nn import reg_net
    from surf_tpu_torch.ops import sparse as sp
    hybrid, gconv, k3 = reg_net.apply_hybrid, reg_net.gather_conv, sp.sparse_trilinear_multi
    calls, cur, mesh = [], {}, []

    def rec_hybrid(params, state, grid, feats, **kw):
        cur["grid"], cur["i"] = grid, 0
        return hybrid(params, state, grid, feats, **kw)

    def rec_gconv(x, idx, w, *live):
        calls.append((cur["grid"], cur["i"], x, idx, w, live[0] if live else None))
        cur["i"] += 1
        return gconv(x, idx, w, *live)

    def rec_k3(stages, pts, **kw):
        if not kw.get("derivs") and not kw.get("third") and not mesh:
            mesh.append((stages, pts.detach()))
        return k3(stages, pts, **kw)

    reg_net.apply_hybrid, reg_net.gather_conv, sp.sparse_trilinear_multi = \
        rec_hybrid, rec_gconv, rec_k3
    try:
        m = v.validate()[0]
    finally:
        reg_net.apply_hybrid, reg_net.gather_conv, sp.sparse_trilinear_multi = \
            hybrid, gconv, k3
    if [c[1] for c in calls] != list(range(6)) * (len(calls) // 6) or not calls:
        fail(f"apply_hybrid made {len(calls)} gather_conv calls, not 6 a stage")
    if not mesh:
        fail("the mesh lattice made no value-only K3 call")
    return m, calls, mesh[0]


def same_cascade(a, b):
    """Bit equality of two runs' cascades: parents, active children,
    storage, matching volume and FPN features."""
    import torch
    for (ga, sa), (gb, sb) in zip(a["stages"], b["stages"]):
        for x, y in ((ga.parents, gb.parents), (ga.cvalid, gb.cvalid), (sa, sb)):
            if not torch.equal(x, y):
                return False
    return torch.equal(a["matching"], b["matching"]) and all(
        torch.equal(x, y) for x, y in zip(a["features"], b["features"]))


# ---------------------------------------------------------------------------
# phase 6: main-path shapes
# ---------------------------------------------------------------------------

def _unnormalize(c, size, align):
    return (c + 1.0) * 0.5 * (size - 1) if align else ((c + 1.0) * size - 1.0) * 0.5


def distinct_taps(sizes, co, align, per_id=1):
    """Distinct in-range texels (sizes (V, H, W), co (V, N, 2) as (x, y))
    or voxels (sizes (X, Y, Z), co (N, 3)) that the bilinear/trilinear taps
    at normalized coords ``co`` read; with ``per_id`` > 1, the distinct
    runs of ``per_id`` consecutive ones (one 32-byte sector of 16 bf16
    voxels, at C = 1)."""
    import torch
    if co.shape[-1] == 2:
        V, H, W = sizes
        axes = [(co[..., 1], H), (co[..., 0], W)]          # row y, column x
        lead = torch.arange(V, device=co.device)[:, None] * (H * W)
    else:
        axes = [(co[:, a], sizes[a]) for a in range(3)]
        lead = 0
    base = [torch.floor(_unnormalize(c, n, align)).long() for c, n in axes]
    ids = []
    for k in range(2 ** len(axes)):
        ok = torch.ones_like(base[0], dtype=torch.bool)
        flat = torch.zeros_like(base[0])
        for a, (b0, (_, n)) in enumerate(zip(base, axes)):
            c = b0 + ((k >> a) & 1)
            ok &= (c >= 0) & (c < n)
            flat = flat * n + c
        ids.append((flat + lead)[ok])
    return torch.unique(torch.cat(ids) // per_id).numel()


def texel_load(image, co, normalized=True, align=True, ct=None):
    """How the points of one K1 / K1b call fall on the image: the largest
    number of points whose bilinear corners hit one texel and, given a
    cotangent ``ct`` (V, N, C), the share of its (view, point) rows that
    are entirely zero (K1b skips their scatter) and the same largest count
    over the rows that are not."""
    import torch
    V, H, W = image.shape[:3]
    x, y = co[..., 0], co[..., 1]
    if normalized:
        x, y = _unnormalize(x, W, align), _unnormalize(y, H, align)
    x0, y0 = torch.floor(x).long(), torch.floor(y).long()
    lead = torch.arange(V, device=co.device)[:, None] * (H * W)
    live = None if ct is None else (ct != 0).any(-1)

    def most(keep):
        ids = []
        for ox, oy in ((0, 0), (1, 0), (0, 1), (1, 1)):
            cx, cy = x0 + ox, y0 + oy
            ok = (cx >= 0) & (cx < W) & (cy >= 0) & (cy < H)
            if keep is not None:
                ok &= keep
            ids.append((lead + cy * W + cx)[ok])
        ids = torch.cat(ids)
        return int(torch.bincount(ids).max()) if ids.numel() else 0
    out = {"max_points_per_texel": most(None)}
    if ct is not None:
        out["zero_cotangent_rows"] = 1.0 - live.float().mean().item()
        out["max_points_per_texel_nonzero_rows"] = most(live)
    return out


def k1_entry(what, image, co, align):
    """K1 against its plain version and F.grid_sample at one call site."""
    import torch.nn.functional as F
    from surf_tpu_torch.ops import grid_sample as gs
    got = gs.bilinear_sample(image, co, align_corners=align)
    err = check_close(f"K1 {what}", got,
                      gs.bilinear_sample_plain(image, co, align_corners=align), 1e-5, 1e-5)
    nchw = image.permute(0, 3, 1, 2).contiguous()
    lib_grid = co[:, None]

    def lib():
        return F.grid_sample(nchw, lib_grid, mode="bilinear", padding_mode="zeros",
                             align_corners=align)
    check_close(f"K1 {what} vs F.grid_sample", got, lib()[:, :, 0].permute(0, 2, 1),
                1e-4, 1e-4)
    V, N, C = got.shape
    texels = distinct_taps(image.shape[:3], co, align)
    b_ms, b_by = bound(nbytes(co) + nbytes(got) + texels * C * 4, V * N * C * 12)
    return {"shape": f"{what}: image {tuple(image.shape)} f32, {N} points x {V} views, "
                     f"align_corners={align}, {texels} distinct texels read",
            "data": texel_load(image, co, align=align),
            "max_abs_err": err,
            "ms": time_ms(lambda: gs.bilinear_sample(image, co, align_corners=align)),
            "plain_ms": time_ms(lambda: gs.bilinear_sample_plain(image, co,
                                                                 align_corners=align), 5),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": time_ms(lib)}


def k2_entry(what, vol, pts):
    """K2 against its plain version and F.grid_sample 3D (axes flipped)
    at one call site (align_corners=False, as every K2 call of the path).
    ``data``: the distinct 32-byte sectors the gathers touch and, at
    C = 1, K2's time on the f32 copy F.grid_sample reads."""
    import torch.nn.functional as F
    from surf_tpu_torch.ops import grid_sample as gs
    got = gs.trilinear_sample(vol, pts, align_corners=False)
    err = check_close(f"K2 {what}", got,
                      gs.trilinear_sample_plain(vol, pts, align_corners=False), 0.0, 0.0)
    vol_f = vol.float().permute(3, 0, 1, 2)[None].contiguous()
    lib_grid = pts.flip(-1)[None, None, None].contiguous()

    def lib():
        return F.grid_sample(vol_f, lib_grid, mode="bilinear", padding_mode="zeros",
                             align_corners=False)
    check_close(f"K2 {what} vs F.grid_sample", got,
                lib().reshape(vol.shape[-1], -1).t(), 1e-4, 1e-4)
    n, C = got.shape
    voxels = distinct_taps(vol.shape[:3], pts, False)
    b_ms, b_by = bound(nbytes(pts) + nbytes(got) + voxels * C * vol.element_size(),
                       n * C * 30)
    # a gather reads whole 32-byte sectors: the distinct ones the taps touch
    # (at C = 1) and their time at the memory rate
    sectors = distinct_taps(vol.shape[:3], pts, False, 32 // vol.element_size()) \
        if C == 1 else None
    data = {"distinct_32B_sectors": sectors,
            "sectors_ms": sectors and sectors * 32 / HBM_BYTES_PER_S * 1e3}
    if C == 1:
        # on the f32 copy F.grid_sample reads (at C = 1 the same layout)
        v32 = vol_f.view(vol.shape)
        check_close(f"K2 {what} f32 copy", gs.trilinear_sample(v32, pts, align_corners=False),
                    got, 0.0, 0.0)
        data["ms_f32_volume"] = time_ms(
            lambda: gs.trilinear_sample(v32, pts, align_corners=False))
    return {"shape": f"{what}: volume {tuple(vol.shape)} {str(vol.dtype).split('.')[-1]}, "
                     f"{n} points, {voxels} distinct voxels read",
            "data": data,
            "max_abs_err": err,
            "ms": time_ms(lambda: gs.trilinear_sample(vol, pts, align_corners=False)),
            "plain_ms": time_ms(lambda: gs.trilinear_sample_plain(vol, pts,
                                                                  align_corners=False), 5),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": time_ms(lib)}


def k3_bytes_read(stages, pts):
    """Bytes of the stages that K3's corners and nearest voxels at ``pts``
    need: distinct parent-table entries, cvalid flags and storage rows."""
    import torch
    from surf_tpu_torch.ops import sparse as sp
    off = sp.child_offsets(pts.device)
    total = 0
    for g, s in stages:
        res, half = g.res, g.res // 2
        c0 = torch.floor((pts + 1.0) * 0.5 * (res - 1)).long()
        near = torch.floor(((pts + 1.0) * res - 1.0) * 0.5 + 0.5).long()
        vox = torch.cat([c0 + off[k] for k in range(8)] + [near]).clamp(0, res - 1)
        p = vox >> 1
        pidx = (p[:, 0] * half + p[:, 1]) * half + p[:, 2]
        rows, valid = sp.lookup_rows(g, vox)
        present = g.parent_table.reshape(-1)[pidx] >= 0
        total += (torch.unique(pidx).numel() * 4 + torch.unique(rows[present]).numel()
                  + torch.unique(rows[valid]).numel() * s.shape[1] * 4)
    return total


# K3's modes: the sums a (point, channel) forms, and the wrapper's flags
K3_MODES = {"value": (1, {}), "derivs": (7, {"derivs": True}), "third": (8, {"third": True})}


def k3_entry(what, stages, pts, mode):
    """K3 against its plain version (equal bit for bit, occupancy equal) at
    one call site, in one of its modes (``K3_MODES``)."""
    import torch
    from surf_tpu_torch.ops import sparse as sp
    sums, kw = K3_MODES[mode]
    got = sp.sparse_trilinear_multi(stages, pts, **kw)
    ref = sp.sparse_trilinear_multi_plain(stages, pts, **kw)
    if not torch.equal(got[1], ref[1]):
        fail(f"K3 {what}: occupancy differs at {(got[1] != ref[1]).sum().item()} points")
    err = 0.0
    for name, a, b in zip(("feats", "occ", "jac", "hmix", "third"), got, ref):
        if b is not None and name != "occ":
            err = max(err, check_close(f"K3 {what} {name}", a, b, 0.0, 0.0))
    n, ctot = got[0].shape
    moved = nbytes(pts) + sum(nbytes(t) for t in got if t is not None) \
        + k3_bytes_read(stages, pts)
    # each sum: 8 corners, a product and an add each (the weights' products
    # once a (point, stage) at best: not counted)
    b_ms, b_by = bound(moved, n * ctot * sums * 8 * 2)
    del got, ref
    outs = {"value": "value + occupancy", "derivs": "value + jacobian + mixed 2nd "
            "derivatives + occupancy", "third": "value + jacobian + mixed 2nd + d3/dxdydz "
            "+ occupancy (training variant)"}[mode]
    return {"shape": f"{what}: {n} points, stages {[g.res for g, _ in stages]}, {ctot} "
                     f"channels, {outs}",
            "max_abs_err": err,
            "ms": time_ms(lambda: sp.sparse_trilinear_multi(stages, pts, **kw)),
            "plain_ms": time_ms(lambda: sp.sparse_trilinear_multi_plain(stages, pts, **kw), 3),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


@contextlib.contextmanager
def count_call_sites():
    """Counts the K2 and K3 calls made inside the block by call site: K2's
    by its caller (``build_z_vals`` in nn/implicit_surface.py,
    ``depth_render`` in nn/matching_field.py), K3's by mode (in a validate
    the render's chunks ask for the derivatives and the mesh lattice for
    values only; a training step asks for the training variant).  Each
    call there is one launch on the card."""
    from surf_tpu_torch.nn import implicit_surface, matching_field
    from surf_tpu_torch.ops import sparse as sp
    sites = {"trilinear_sample_3d": {"build_z_vals": 0, "depth_render": 0},
             "sparse_trilinear_multi": {"derivatives": 0, "value only": 0,
                                        "training variant": 0}}

    def k2_at(site):
        def count(_kw):
            sites["trilinear_sample_3d"][site] += 1
        return count

    def k3_by_mode(kw):
        site = ("training variant" if kw.get("third") else
                "derivatives" if kw.get("derivs") else "value only")
        sites["sparse_trilinear_multi"][site] += 1

    def wrap(fn, count):
        def counted(*a, **k):
            count(k)
            return fn(*a, **k)
        return counted
    swaps = [(implicit_surface, "trilinear_sample_3d", k2_at("build_z_vals")),
             (matching_field, "trilinear_sample_3d", k2_at("depth_render")),
             (sp, "sparse_trilinear_multi", k3_by_mode)]
    orig = [getattr(m, n) for m, n, _ in swaps]
    for (m, n, count), fn in zip(swaps, orig):
        setattr(m, n, wrap(fn, count))
    try:
        yield sites
    finally:
        for (m, n, _), fn in zip(swaps, orig):
            setattr(m, n, fn)


def k4_data(idx, live):
    """What a K4 / K4w call's table holds: present (row, tap) pairs, rows
    with a present tap, and the rows its live-row mask keeps (the rows
    whose table entries the kernel reads), where it is given one."""
    d = {"rows": idx.shape[0], "present_pairs": int((idx >= 0).sum()),
         "rows_with_a_present_tap": int((idx >= 0).any(1).sum())}
    if live is not None:
        d["live_mask_rows"] = int(live.sum())
    return d


def k4_bound(index_bytes, x, idx, c_out, out_bytes):
    """(bound_ms, bound_by) of a K4 / K4w call: the index bytes the JAX op
    needs, each distinct row of x it reads once, the output (and W or ct)
    once; 2 Cin Cout flops a present pair."""
    import torch
    present = idx[idx >= 0]
    rows_read = torch.unique(present).numel()
    return bound(index_bytes + rows_read * x.shape[1] * 4 + out_bytes,
                 2 * present.numel() * x.shape[1] * c_out)


def k4_entry(grid, i, x, idx, w, live, what=None, index_bytes=None):
    """K4 against its plain version on one recorded apply_hybrid call (or,
    with ``what`` and ``index_bytes``, one of a training step's calls); with
    a live-row mask also timed without it (the full-table pass)."""
    import torch
    from surf_tpu_torch.nn import reg_net
    if what is None:
        what, ib = K4_CALLS[i]
        index_bytes = ib(grid.parents.shape[0])
        what = f"{grid.res}^3 {what}"
    # an int64 table (earlier versions of the port's) is narrowed on each
    # call: time the kernel alone on the narrowed table
    idx = idx.to(torch.int32).contiguous()
    lv = () if live is None else (live,)
    got = reg_net.gather_conv(x, idx, w, *lv)
    ref = reg_net.gather_conv_plain(x, idx, w, *lv)
    err = check_close(f"K4 {what}", got, ref, 1e-4,
                      1e-4 * max(ref.abs().max().item(), 1.0))
    R, T = idx.shape
    Cin, Cout = w.shape[1], w.shape[2]
    data = k4_data(idx, live)
    b_ms, b_by = k4_bound(index_bytes, x, idx, Cout, nbytes(w) + R * Cout * 4)
    e = {"shape": f"{what}: {R} rows x {T} taps, {Cin} -> {Cout} channels, "
                  f"{grid.parents.shape[0]} parents",
         "data": data, "max_abs_err": err,
         "ms": time_ms(lambda: reg_net.gather_conv(x, idx, w, *lv)),
         "plain_ms": time_ms(lambda: reg_net.gather_conv_plain(x, idx, w, *lv), 3),
         "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    if live is not None:
        e["ms_without_live_mask"] = time_ms(lambda: reg_net.gather_conv(x, idx, w))
    return e


def render_chunk_points(scene, static, chunk):
    """The first render chunk's sample points (chunk rays x 136 z-vals
    between near and far, as the render places them)."""
    import torch
    from surf_tpu_torch.nn.implicit_surface import build_z_vals
    ipts = scene["ipts"]
    ro, rd = ipts["rays_o"][:chunk], ipts["rays_d"][:chunk]
    near = ipts["near"].reshape(1, 1).expand(ro.shape[0], 1)
    far = ipts["far"].reshape(1, 1).expand(ro.shape[0], 1)
    z = build_z_vals(static, ro, rd, near, far, scene["matching"])
    mid = torch.cat([(z[:, 1:] + z[:, :-1]) * 0.5, z[:, -1:]], -1)
    return (ro[:, None] + rd[:, None] * mid[..., None]).reshape(-1, 3), ro, rd, near, far


def main_path_kernels(v, launches, k4_calls, mesh_call, sites):
    """One row per kernel: its headline call site, and ``also_checked``
    entries for its other call sites on the main path; K2's and K3's
    entries carry their call site's launches (``sites``, counted in the
    same validate as ``launches``)."""
    import torch
    from surf_tpu_torch.ops import sparse as sp
    from surf_tpu_torch.ops.feature_lookup import fuse_pyramid
    from surf_tpu_torch.ops.projection import (project_points_all, pixel_to_normalized,
                                               make_pixel_grid, pixels_to_rays)

    scene = v.last_scene
    ipts = scene["ipts"]
    intrs, c2ws = ipts["intrs"], ipts["c2ws"]
    static = v.static["implicit_surface"]
    stages_ff = scene["stages"][::-1]
    feats = scene["features"]                      # coarse to fine
    pts, ro, rd, near, far = render_chunk_points(scene, static, v.val_chunk)
    H, W = ipts["imgs"].shape[1:3]

    def row(name, source, replaces, entries, tolerance, library):
        r = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
             "launches": launches[name], **entries[0], "tolerance": tolerance,
             "library": library}
        if len(entries) > 1:
            r["also_checked"] = entries[1:]
        return r

    # K1: the colour fetch of one render chunk (fused pyramid, 2 source
    # views); back_project (stage 0, every 88^3 voxel centre into every
    # level, align_corners=True); depth_consistency (the last stage's
    # candidates against a 1-channel full-resolution map; the image's first
    # channel stands in for the depth values)
    fused = fuse_pyramid(ipts["imgs"], feats[::-1])[1:].contiguous()
    xy, _ = project_points_all(pts, intrs[1:], c2ws[1:])
    k1 = [k1_entry("colour fetch", fused, pixel_to_normalized(xy, fused.shape[1:3])
                   .contiguous(), False)]
    del fused
    g0 = scene["stages"][0][0]
    xy, _ = project_points_all(sp.voxel_centers_world(g0.child_coords(), g0.res), intrs, c2ws)
    co = pixel_to_normalized(xy, feats[-1].shape[1:3]).contiguous()
    k1 += [k1_entry(f"back_project level {i}", f.contiguous(), co, True)
           for i, f in enumerate(feats)]
    g2 = scene["stages"][-2][0]
    cand = g2.child_coords()[g2.cvalid]
    cand = (cand[:, None, :] * 2 + sp.child_offsets(cand.device)[None]).reshape(-1, 3)
    xy, _ = project_points_all(sp.voxel_centers_world(cand, g2.res * 2), intrs, c2ws)
    k1.append(k1_entry("depth_consistency", ipts["imgs"][..., :1].contiguous(),
                       pixel_to_normalized(xy, (H, W)).contiguous(), True))
    del xy, co, cand
    rows = [row("bilinear_sample_2d", "surf_tpu_torch/csrc/grid_sample.cu",
                "surf_tpu/ops/grid_sample.py:78", k1, "|err| <= 1e-5 + 1e-5 |plain|",
                "F.grid_sample, 2-D, NCHW copy of the image")]

    # K2: the z-vals density pre-render of one chunk through the 704^3
    # volume; the last stage's depth_render (one view, 576x800 rays x 2
    # bands x 16 samples)
    mv = scene["matching"].contiguous()
    z_d = near + (far - near) * torch.linspace(0.0, 1.0, static["n_depth"],
                                               device=near.device)[None]
    p2 = (ro[:, None] + rd[:, None] * z_d[..., None]).reshape(-1, 3).contiguous()
    # (build_z_vals heads the row: the call site where K2 lost to
    # F.grid_sample before it was redesigned)
    k2 = [k2_entry("build_z_vals", mv, p2)]
    rof, rdf = pixels_to_rays(make_pixel_grid((H, W), device=mv.device), intrs[0], c2ws[0])
    nf = ipts["near_fars"][0]
    z = nf[0] + (nf[1] - nf[0]) * torch.linspace(0.0, 1.0, 32, device=mv.device)
    k2.append(k2_entry("depth_render", mv, (rof[:, None] + rdf[:, None] * z[None, :, None])
                       .reshape(-1, 3).contiguous()))
    for e, site in zip(k2, ("build_z_vals", "depth_render")):
        e["call_site_launches"] = sites["trilinear_sample_3d"][site]
    rows.append(row("trilinear_sample_3d", "surf_tpu_torch/csrc/grid_sample.cu",
                    "surf_tpu/ops/grid_sample.py:347", k2,
                    "exact: max abs err 0 (equal bit for bit to the plain version)",
                    "F.grid_sample, 3-D, f32 NCDHW copy, axes flipped"))

    # K3: the render chunk's 4-stage lookup with derivatives; the mesh
    # lattice's first call (value only); the training variant at the
    # training step's render shape (512 rays x 136 samples)
    pts = pts.contiguous()
    k3 = [k3_entry("render chunk", stages_ff, pts, "derivs"),
          k3_entry("mesh lattice", mesh_call[0], mesh_call[1].contiguous(), "value"),
          k3_entry("training variant", stages_ff, pts[:512 * 136].contiguous(), "third")]
    for e, site in zip(k3, ("derivatives", "value only", "training variant")):
        e["call_site_launches"] = sites["sparse_trilinear_multi"][site]
    rows.append(row("sparse_trilinear_multi", "surf_tpu_torch/csrc/sparse_trilinear.cu",
                    "surf_tpu/ops/sparse.py:422", k3,
                    "exact: max abs err 0 (equal bit for bit to the plain version), "
                    "occupancy equal",
                    "none: no one PyTorch call samples a sparse voxel set"))

    # K4: every gather_conv call of apply_hybrid (352^3 and 704^3) on the
    # warm validate's own tensors; the 704^3 conv0 heads the row (sums in
    # another order than the plain version's matmul)
    k4 = [k4_entry(*c) for c in k4_calls]
    head = max(range(len(k4)), key=lambda j: (k4_calls[j][0].res, -k4_calls[j][1]))
    rows.append(row("gather_conv", "surf_tpu_torch/csrc/gather_conv.cu",
                    "surf_tpu/nn/reg_net.py:359", [k4[head]] + k4[:head] + k4[head + 1:],
                    "|err| <= 1e-4 max(max|plain|, 1) + 1e-4 |plain|",
                    "none: no one PyTorch call does a gathered sparse convolution"))
    for r in rows:
        say("kernel", json.dumps(r))
    return rows


# ---------------------------------------------------------------------------
# phase 6b: the grid-form convs (row 7) on the validate's own grids
# ---------------------------------------------------------------------------

# recorded apply_hybrid call index -> (grid-form op, input on children,
# cotangent mask, its output mask); the backward: (paired table, flip, dX mask)
GRID_OPS = {0: "subm_conv_child", 1: "down_conv_child_to_parent",
            2: "subm_conv_parent", 5: "up_conv_parent_to_child"}


# the four grid-form ops as nn.reg_net defines them, and how often any
# path called them (``count_grid_form_calls`` wraps the module attributes)
GRID_FNS = {}
GRID_CALLS = {"n": 0}


def count_grid_form_calls():
    from surf_tpu_torch.nn import reg_net
    for name in GRID_OPS.values():
        fn = GRID_FNS[name] = getattr(reg_net, name)

        def counted(*a, _fn=fn, **k):
            GRID_CALLS["n"] += 1
            return _fn(*a, **k)
        setattr(reg_net, name, counted)


def grid_op_tables(op, grid, pactive):
    """(forward table, cotangent mask, output mask or None, (dX table,
    flip, dX mask)) of one grid-form op, as ``nn.reg_net`` builds them."""
    from surf_tpu_torch.nn import reg_net as rn
    cval = grid.cvalid
    if op == "subm_conv_child":
        t = rn.grid_child_table(grid)
        return t, cval, cval, (t, True, cval)
    if op == "subm_conv_parent":
        t = rn.grid_parent_table(grid, pactive)
        return t, pactive, pactive, (t, True, pactive)
    if op == "down_conv_child_to_parent":
        return rn.grid_down_table(grid), pactive, None, (rn.grid_up_table(grid, pactive),
                                                        False, cval)
    return rn.grid_up_table(grid, pactive), cval, cval, (rn.grid_down_table(grid), False,
                                                         pactive)


def grid_index_bytes(grid, op):
    """Bytes of the index inputs the JAX op reads: the parent coordinates
    (P x 3 int32), the distinct parent-table cells its lookups consult (the
    3^3 parent neighbourhoods; 2^3 for the stride-2 down conv), cvalid
    (one byte a child) for the child lookups and child outputs, pactive
    (one byte a parent) for the parent lookups."""
    import torch
    from surf_tpu_torch.nn.reg_net import _OFFSETS_NP
    half = grid.res // 2
    off = torch.as_tensor(_OFFSETS_NP, device=grid.parents.device)
    if op == "down_conv_child_to_parent":
        off = off[(off <= 0).all(-1)]
    cells = grid.parents[:, None, :] + off
    inb = ((cells >= 0) & (cells < half)).all(-1)
    lin = (cells[..., 0] * half + cells[..., 1]) * half + cells[..., 2]
    P = grid.parents.shape[0]
    n = P * 12 + torch.unique(lin[inb]).numel() * 4 + P * 8
    return n + (P if op != "subm_conv_child" else 0)


def grid_form_kernels(k4_calls):
    """Row 7: the four grid-form convs on the warm validate's 352^3 and
    704^3 grids, each on the input its neighbour-row conv took there.
    Forward, dX and dW by K4/K4w against their plain versions (the
    tolerances of rows 6/6w); each op's value (through its autograd
    function) against the neighbour-row K4 call on live rows; its dX and
    dW through autograd against the plain versions."""
    import torch
    from surf_tpu_torch.nn import reg_net as rn
    fwd, bwd_x, bwd_w, eq = [], [], [], []
    for grid, i, x, idx_nbr, w27, _ in k4_calls:
        if i not in GRID_OPS:
            continue
        op = GRID_OPS[i]
        pactive = grid.pvalid & grid.cvalid.reshape(-1, 8).any(1)
        table, ct_mask, out_mask, (t_b, flip, dx_mask) = grid_op_tables(op, grid, pactive)
        idx, idx_b = table.to(torch.int32).contiguous(), t_b.to(torch.int32).contiguous()
        del table, t_b
        Cin, Cout = w27.shape[1], w27.shape[2]
        w_b = (w27.flip(0) if flip else w27).transpose(1, 2).contiguous()
        g = torch.Generator(device=x.device).manual_seed(11 + i)
        ct = (torch.randn(idx.shape[0], Cout, device=x.device, generator=g)
              * ct_mask[:, None]).contiguous()
        what = f"{grid.res}^3 {op}"
        ib = grid_index_bytes(grid, op)

        def entry(name, fn, plain, inp, tab, c_out, out_bytes, flops, tol):
            got, ref = fn(), plain()
            err = check_close(f"row 7 {what} {name}", got, ref, tol, tol * scale(ref))
            present = tab[tab >= 0]
            rows_read = torch.unique(present).numel()
            b_ms, b_by = bound(ib + rows_read * inp.shape[1] * 4 + out_bytes, flops)
            return {"shape": f"{what} {name}: {tab.shape[0]} rows x 27 taps "
                             f"({present.numel()} present, {rows_read} distinct rows read), "
                             f"{inp.shape[1]} -> {c_out} channels, {grid.parents.shape[0]} "
                             "parents",
                    "data": k4_data(tab, None), "max_abs_err": err, "ms": time_ms(fn), "plain_ms": time_ms(plain, 3),
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}

        n_present = int((idx >= 0).sum())
        nb_present = int((idx_b >= 0).sum())
        fwd.append(entry("forward", lambda: rn.gather_conv(x, idx, w27),
                         lambda: rn.gather_conv_plain(x, idx, w27), x, idx, Cout,
                         nbytes(w27) + idx.shape[0] * Cout * 4,
                         2 * n_present * Cin * Cout, 1e-4))
        bwd_x.append(entry("dX", lambda: rn.gather_conv(ct, idx_b, w_b),
                           lambda: rn.gather_conv_plain(ct, idx_b, w_b), ct, idx_b, Cin,
                           nbytes(w_b) + idx_b.shape[0] * Cin * 4,
                           2 * nb_present * Cin * Cout, 1e-4))
        bwd_w.append(entry("dW", lambda: rn.gather_conv_dw(x, idx, ct),
                           lambda: rn.gather_conv_dw_plain(x, idx, ct), x, idx, Cout,
                           nbytes(ct) + nbytes(w27), 2 * n_present * Cin * Cout, 1e-4))
        # the op itself (its autograd function on the card) against the
        # neighbour-row conv on the same input, and its gradients
        xr = x.detach().clone().requires_grad_(True)
        wr = w27.reshape(3, 3, 3, Cin, Cout).detach().clone().requires_grad_(True)
        extra = () if op == "subm_conv_child" else (pactive,)
        y = GRID_FNS.get(op, getattr(rn, op))(wr, xr, grid, *extra)
        live = ct_mask if out_mask is None else out_mask
        nbr = rn.gather_conv(x, idx_nbr.to(torch.int32).contiguous(), w27)
        d = check_close(f"row 7 {what} against the neighbour-row conv", y.detach()[live],
                        nbr[live], 1e-4, 1e-4 * scale(nbr[live]))
        dx, dw = torch.autograd.grad((y * ct).sum(), (xr, wr))
        check_close(f"row 7 {what} autograd dX", dx,
                    rn.gather_conv_plain(ct, idx_b, w_b) * dx_mask[:, None], 1e-4,
                    1e-4 * scale(dx))
        check_close(f"row 7 {what} autograd dW", dw.reshape(27, Cin, Cout),
                    rn.gather_conv_dw_plain(x, idx, ct), 1e-4, 1e-4 * scale(dw))
        eq.append({"op": what, "max_abs_diff_live_rows": d,
                   "bit_equal_live_rows": bool(torch.equal(y.detach()[live], nbr[live]))})
        del xr, wr, y, dx, dw, nbr, idx, idx_b, ct
        if x.is_cuda:
            torch.cuda.empty_cache()
    say("kernel", "row 7 against the neighbour-row convs: " + json.dumps(eq))

    def head(entries):
        """The finest grid's subm_conv_child first (as row 6 heads with conv0)."""
        res = max(c[0].res for c in k4_calls)
        j = next(k for k, e in enumerate(entries)
                 if e["shape"].startswith(f"{res}^3 subm_conv_child"))
        return [entries[j]] + entries[:j] + entries[j + 1:]
    tol = "|err| <= 1e-4 max(max|plain|, 1) + 1e-4 |plain|"
    rows = [{"name": "gather_conv (grid-form tables)", "route": "cuda",
             "source": "surf_tpu_torch/csrc/gather_conv.cu",
             "replaces": "surf_tpu/nn/reg_net.py:566", "launches": 0,
             **head(fwd)[0], "also_checked": head(fwd)[1:] + bwd_x, "tolerance": tol,
             "library": "none: no one PyTorch call does a gathered sparse convolution",
             "against_neighbour_rows": eq},
            {"name": "gather_conv_dw (grid-form tables)", "route": "cuda",
             "source": "surf_tpu_torch/csrc/gather_conv.cu",
             "replaces": "surf_tpu/nn/reg_net.py:574", "launches": 0,
             **head(bwd_w)[0], "also_checked": head(bwd_w)[1:], "tolerance": tol,
             "library": "none: no one PyTorch call does a gathered sparse convolution's "
                        "weight gradient"}]
    for r in rows:
        say("kernel", json.dumps(r))
    return rows


# ---------------------------------------------------------------------------
# phase 7: training at full width, and the backward kernels at its call sites
# ---------------------------------------------------------------------------

FWD_KERNELS = ("bilinear_sample_2d", "trilinear_sample_3d", "sparse_trilinear_multi",
               "gather_conv")
BWD_KERNELS = ("bilinear_sample_2d_bwd", "trilinear_sample_3d_bwd",
               "sparse_trilinear_multi_bwd", "gather_conv_dw")


def bwd_site(name, a):
    """The call site a backward call is recorded under: K2b's by its volume
    ("176^3"), K3b's by its storages' shapes; the others have one."""
    if name == "trilinear_sample_3d_bwd":
        return "x".join(str(n) for n in a[0].shape[:3]) if len(set(a[0].shape[:3])) > 1 \
            else f"{a[0].shape[0]}^3"
    if name == "sparse_trilinear_multi_bwd":
        return "storages " + " ".join("x".join(map(str, s.shape)) for _, s in a[0])
    return ""


BWD_BY_SITE = ("trilinear_sample_3d_bwd", "sparse_trilinear_multi_bwd")


def bwd_label(name, kind, site):
    """How a recorded K2b / K3b call site is named in the kernels line:
    K2b by its volume, K3b by the cotangents it takes."""
    if name == "sparse_trilinear_multi_bwd":
        return "cotangents of " + " + ".join(
            n for n, on in zip(("feats", "jac", "hmix", "third"), kind) if on)
    return site + ("" if kind == (True, False) else
                   f", d_volume={kind[0]}, d_coords={kind[1]}")


def bwd_site_launches(calls):
    """K2b's and K3b's calls by call site (``bwd_label``)."""
    out = {n: {} for n in BWD_BY_SITE}
    for (name, kind, site), c in calls["by_site"].items():
        if name in out:
            lab = bwd_label(name, kind, site)
            out[name][lab] = out[name].get(lab, 0) + c
    return out


def record_backward_calls(names=None):
    """Wrap the backward kernels' wrappers (the autograd functions call
    them by module attribute; ``names``: all four by default) to keep, per
    kernel, kind of call (which gradients / cotangents it takes) and call
    site (``bwd_site``), the arguments of its largest call.  Returns
    (records, calls, restore): ``calls`` counts each kernel's calls, in
    all and by (kind, site)."""
    from surf_tpu_torch.ops import grid_sample as gs, sparse as sp
    from surf_tpu_torch.nn import reg_net
    where = {"bilinear_sample_2d_bwd": (gs, "bilinear_sample_bwd"),
             "trilinear_sample_3d_bwd": (gs, "trilinear_sample_bwd"),
             "sparse_trilinear_multi_bwd": (sp, "sparse_trilinear_multi_bwd"),
             "gather_conv_dw": (reg_net, "gather_conv_dw")}
    where = {n: w for n, w in where.items() if names is None or n in names}
    size = {"bilinear_sample_2d_bwd": lambda a: a[2].numel(),
            "trilinear_sample_3d_bwd": lambda a: a[2].numel(),
            "sparse_trilinear_multi_bwd": lambda a: a[1].shape[0],
            "gather_conv_dw": lambda a: a[1].numel() * a[2].shape[1]}
    kind = {"bilinear_sample_2d_bwd": lambda a, k: (k.get("need_images", True),
                                                   k.get("need_coords", True)),
            "trilinear_sample_3d_bwd": lambda a, k: (k.get("need_volume", True),
                                                    k.get("need_coords", True)),
            "sparse_trilinear_multi_bwd": lambda a, k: tuple(c is not None for c in a[2:]),
            "gather_conv_dw": lambda a, k: ()}
    records, calls, orig = {}, {"by_site": {}}, {}

    def wrap(name, fn):
        def rec(*a, **k):
            key = (name, kind[name](a, k), bwd_site(name, a))
            calls[name] = calls.get(name, 0) + 1
            calls["by_site"][key] = calls["by_site"].get(key, 0) + 1
            n = size[name](a)
            if n >= records.get(key, (-1,))[0]:
                records[key] = (n, a, k)
            return fn(*a, **k)
        return rec

    for name, (mod, attr) in where.items():
        orig[name] = getattr(mod, attr)
        setattr(mod, attr, wrap(name, orig[name]))

    def restore():
        for name, (mod, attr) in where.items():
            setattr(mod, attr, orig[name])
    return records, calls, restore


@contextlib.contextmanager
def record_k4_train_calls():
    """Inside the block, every K4 call by call site: forward (the autograd
    function's forward, ``apply_hybrid``'s call index and grid) or dX (its
    backward, on the transposed table; its grid is the forward's with the
    same shapes swapped), by resolution.  Yields (counts, largest): the
    launches by "forward 352^3" ... "dX 704^3", and the largest call of
    each kind (by table entries) with what ``k4_entry`` needs to check and
    time it."""
    import sys as _sys
    from surf_tpu_torch.nn import reg_net
    hybrid, gconv = reg_net.apply_hybrid, reg_net.gather_conv
    counts, largest, cur, fwd = {}, {}, {}, {}

    def rec_hybrid(params, state, grid, feats, **kw):
        cur["grid"], cur["i"] = grid, 0
        return hybrid(params, state, grid, feats, **kw)

    def rec_gconv(x, idx, w, *live):
        if _sys._getframe(1).f_code.co_name == "backward":
            grid, i = fwd[(idx.shape[0], x.shape[0])]
            kind = "dX"
        else:
            grid, i = cur["grid"], cur["i"]
            cur["i"] += 1
            fwd[(x.shape[0], idx.shape[0])] = (grid, i)
            kind = "forward"
        site = f"{kind} {grid.res}^3"
        counts[site] = counts.get(site, 0) + 1
        if idx.numel() * w.shape[2] > largest.get(kind, (-1,))[0]:
            # (w, a view of a parameter that the update then changes in place,
            # is copied)
            largest[kind] = (idx.numel() * w.shape[2], grid, i, x.detach(), idx,
                             w.detach().clone(), live[0] if live else None)
        return gconv(x, idx, w, *live)

    reg_net.apply_hybrid, reg_net.gather_conv = rec_hybrid, rec_gconv
    try:
        yield counts, largest
    finally:
        reg_net.apply_hybrid, reg_net.gather_conv = hybrid, gconv


def k4_train_entries(largest):
    """K4 at the training step's largest forward call and largest dX call
    (on the transposed table; its index bytes: the forward's)."""
    out = []
    for kind in ("forward", "dX"):
        _, grid, i, x, idx, w, live = largest[kind]
        what, ib = K4_CALLS[i]
        out.append(k4_entry(grid, i, x, idx, w, live,
                            what=f"training step, largest {kind}: {grid.res}^3 {what}"
                                 + (" (transposed table)" if kind == "dX" else ""),
                            index_bytes=ib(grid.parents.shape[0])))
    return out


def train_phase(conf_path, n_steps=3, dev="cuda"):
    """A Trainer at full width: ``n_steps`` steps on the first scenes, the
    launch counts zeroed before and read after; the last step's backward
    calls recorded.  Returns (launches, records and calls as
    ``record_backward_calls`` gives them, metrics, the checkpoint's path,
    K4's largest calls).  (``dev`` "cpu" rehearses the phase without a
    card.)"""
    import math
    import torch
    from surf_tpu_torch import _build
    from surf_tpu_torch.config import ConfigFactory
    from surf_tpu_torch.train import Trainer
    from surf_tpu_torch.validate import to_device
    conf = ConfigFactory.parse_file(conf_path)
    cuda = dev == "cuda"
    t = Trainer(conf, device=dev, seed=0,
                base_exp_dir=os.path.join(HERE, "exp", "chip_smoke_train"))
    n = len(t.dataset)
    batches = [to_device(t.dataset[i], dev) for i in range(n_steps)]
    before = {g["name"]: [p.detach().clone() for p in g["params"]]
              for g in t.optimizer.param_groups}
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    times, per_step, last = [], [], dict(_build.launches)
    for i in range(n_steps):
        last_step = i == n_steps - 1
        if last_step:
            records, calls, restore = record_backward_calls()
        t0 = time.time()
        try:
            with count_call_sites() if last_step else contextlib.nullcontext({}) as sites, \
                    record_k4_train_calls() if last_step else \
                    contextlib.nullcontext(({}, {})) as (k4_sites, k4_largest):
                res = t.step(batches[i], i / n)
            if cuda:
                torch.cuda.synchronize()
        finally:
            if last_step:
                restore()
        times.append(time.time() - t0)
        now = dict(_build.launches)
        per_step.append({k: now[k] - last[k] for k in now})
        last = now
        say("train", f"step {i} ({'cold' if i == 0 else 'warm'}): {times[-1]:.3f} s, "
            f"active_voxels={t.active_voxels.tolist()} "
            + " ".join(f"{k}={v:.5g}" for k, v in res.items()))
        if not all(math.isfinite(v) for v in res.values()):
            fail(f"train: non-finite loss terms at step {i}: {res}")
    launches = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    moved = {name: sum(int(not torch.equal(a, p.detach())) for a, p in zip(
        before[name], g["params"])) for name, g in
        ((g["name"], g) for g in t.optimizer.param_groups)}
    sizes = {g["name"]: len(g["params"]) for g in t.optimizer.param_groups}
    metrics = {"cold_step_s": times[0], "warm_s_per_step": statistics.mean(times[1:]),
               "warm_steps_s": times[1:], "peak_mem_gb": peak / 2 ** 30,
               "launches_per_step": per_step[-1], "params_moved": moved,
               "params_per_group": sizes,
               "backward_calls_last_step": {k: v for k, v in calls.items() if k != "by_site"},
               "k2_k3_call_sites_last_step": sites, "k4_call_sites_last_step": k4_sites,
               "k2b_k3b_call_sites_last_step": bwd_site_launches(calls)}
    say("train", json.dumps(metrics))
    say("train", "kernels " + json.dumps(launches))
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        fail(f"train: the training path launched no {missing}")
    if any(moved[g] == 0 for g in moved):
        fail(f"train: no parameter moved in some group: {moved}")
    return launches, records, calls, metrics, t.save(n_steps - 1), k4_largest


def bwd_bound(name, a, k, got):
    """(bound_ms, bound_by, what) for one recorded backward call."""
    import torch
    from surf_tpu_torch.ops import sparse as sp
    if name == "bilinear_sample_2d_bwd":
        img, co, ct = a
        V, N, C = ct.shape
        need_img, need_co = k.get("need_images", True), k.get("need_coords", True)
        moved = nbytes(co) + nbytes(ct)
        if need_img:
            moved += nbytes(img)                       # the gradient image, written
        if need_co:
            co_n, align = co, k.get("align_corners", True)
            if not k.get("normalized", True):
                H, W = img.shape[1:3]
                co_n = torch.stack([co[..., 0] * (2.0 / (W - 1)) - 1.0,
                                    co[..., 1] * (2.0 / (H - 1)) - 1.0], -1)
                align = True
            moved += distinct_taps(img.shape[:3], co_n, align) * C * 4 + nbytes(co)
        what = (f"image {tuple(img.shape)}, {N} points x {V} views, d_image={need_img}, "
                f"d_coords={need_co}")
        return (*bound(moved, V * N * C * 4 * (2 * need_img + 2 * need_co)), what)
    if name == "trilinear_sample_3d_bwd":
        vol, co, ct = a
        N, C = ct.shape
        need_vol, need_co = k.get("need_volume", True), k.get("need_coords", True)
        moved = nbytes(co) + nbytes(ct) + (nbytes(vol) if need_vol else 0)
        if need_co:
            moved += distinct_taps(vol.shape[:3], co, k.get("align_corners", True)) \
                * C * vol.element_size() + nbytes(co)
        what = (f"volume {tuple(vol.shape)} {str(vol.dtype).split('.')[-1]}, {N} points, "
                f"d_volume={need_vol}, d_coords={need_co}")
        return (*bound(moved, N * C * 8 * (2 * need_vol + 2 * need_co)), what)
    if name == "sparse_trilinear_multi_bwd":
        stages, pts, cts = a[0], a[1], a[2:]
        n = pts.shape[0]
        ctot = sum(s.shape[1] for _, s in stages)
        moved = nbytes(pts) + sum(nbytes(c) for c in cts if c is not None) \
            + sum(s.shape[0] * s.shape[1] * 4 for _, s in stages)
        off = sp.child_offsets(pts.device)
        for g, _ in stages:
            res, half = g.res, g.res // 2
            c0 = torch.floor((pts + 1.0) * 0.5 * (res - 1)).long()
            vox = torch.cat([c0 + off[j] for j in range(8)]).clamp(0, res - 1)
            p = vox >> 1
            pidx = (p[:, 0] * half + p[:, 1]) * half + p[:, 2]
            rows, _ = sp.lookup_rows(g, vox)
            present = g.parent_table.reshape(-1)[pidx] >= 0
            moved += torch.unique(pidx).numel() * 4 + torch.unique(rows[present]).numel()
        terms = 1 + sum(3 if c is not None and c.dim() == 3 else 1
                        for c in cts if c is not None)
        what = (f"{n} points, stages {[g.res for g, _ in stages]}, {ctot} channels, "
                f"cotangents of (feats, jac, hmix, third) = "
                f"{[c is not None for c in cts]}")
        return (*bound(moved, n * ctot * 8 * 2 * terms), what)
    # K4w: only the rows holding a present tap take part: their table rows
    # and cotangent rows are what the function needs (not the capacity)
    x, idx, ct = a[:3]
    R, T = idx.shape
    Cin, Cout = x.shape[1], ct.shape[1]
    n_rows = int((idx >= 0).any(1).sum())
    what = f"{R} rows x {T} taps, {Cin} -> {Cout} channels"
    return (*k4_bound(n_rows * (T + Cout) * 4, x, idx, Cout, T * Cin * Cout * 4), what)


def bwd_library(name, a, k):
    """One PyTorch call computing the same function, or None."""
    import torch
    if name == "bilinear_sample_2d_bwd":
        img, co, ct = a
        align = k.get("align_corners", True)
        if not k.get("normalized", True):
            H, W = img.shape[1:3]
            co = torch.stack([co[..., 0] * (2.0 / (W - 1)) - 1.0,
                              co[..., 1] * (2.0 / (H - 1)) - 1.0], -1)
            align = True
        inp = img.permute(0, 3, 1, 2).contiguous()
        grid = co[:, None].contiguous()
        go = ct.permute(0, 2, 1)[:, :, None].contiguous()
        mask = [k.get("need_images", True), k.get("need_coords", True)]
        return lambda: torch.ops.aten.grid_sampler_2d_backward(go, inp, grid, 0, 0, align,
                                                               mask)
    if name == "trilinear_sample_3d_bwd":
        vol, co, ct = a
        inp = vol.float().permute(3, 0, 1, 2)[None].contiguous()
        grid = co.flip(-1)[None, None, None].contiguous()
        go = ct.t()[None, :, None, None].contiguous()
        mask = [k.get("need_volume", True), k.get("need_coords", True)]
        align = k.get("align_corners", True)
        return lambda: torch.ops.aten.grid_sampler_3d_backward(go, inp, grid, 0, 0, align,
                                                               mask)
    return None


def device_split(fn, calls=3):
    """The card's time for one call of ``fn`` by what ran on it: the mean
    device microseconds a call of each kernel (by its function's name) and
    memory operation, from ``torch.profiler`` over ``calls`` calls."""
    import re
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        m = re.search(r"(\w+_kernel|Memset|Memcpy\w*|\w+Kernel\w*)", e.key)
        name = m.group(1) if m else e.key[:40]
        out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / calls
    return out


def k2b_data(fn, a, k):
    """What one K2b call scatters: the distinct voxels and 8^3 bricks its
    samples' in-range corners touch (of the volume's bricks), the share of
    all-zero cotangent rows and, where the wrapper reports them
    (``counts``), the (corner, channel) scatters, the global atomics issued
    and the share merged before an atomic; for a bf16 volume whose wrapper
    has both forms, the time of each; the device time by kernel
    (``device_split``) of each form, or of the call."""
    import torch
    vol, co, ct = a
    X, Y, Z = vol.shape[:3]
    norm, align = k.get("normalized", True), k.get("align_corners", True)
    base = [torch.floor(_unnormalize(co[:, i], vol.shape[i], align) if norm else co[:, i])
            .long() for i in range(3)]
    BX, BY, BZ = (-(-n // 8) for n in (X, Y, Z))
    vox, bricks = [], []
    for kk in range(8):
        c = [b + ((kk >> (2 - i)) & 1) for i, b in enumerate(base)]
        ok = (c[0] >= 0) & (c[0] < X) & (c[1] >= 0) & (c[1] < Y) & (c[2] >= 0) & (c[2] < Z)
        c = [x[ok] for x in c]
        vox.append((c[0] * Y + c[1]) * Z + c[2])
        bricks.append(((c[0] // 8) * BY + c[1] // 8) * BZ + c[2] // 8)
    d = {"distinct_voxels": torch.unique(torch.cat(vox)).numel(),
         "distinct_8x8x8_bricks": torch.unique(torch.cat(bricks)).numel(),
         "bricks_in_volume": BX * BY * BZ,
         "zero_cotangent_rows": (ct == 0).all(-1).float().mean().item()}
    del vox, bricks, base
    params = inspect.signature(fn).parameters
    if "counts" in params:
        cnt = torch.zeros(2, dtype=torch.int64, device=ct.device)
        fn(*a, **k, counts=cnt)
        scatters, atomics = cnt.tolist()
        d.update(corner_scatters=scatters, global_atomics=atomics,
                 merged_share=1.0 - atomics / scatters if scatters else 0.0)
    if not ct.is_cuda:
        return d
    if "bricked" in params and vol.dtype == torch.bfloat16 and k.get("need_volume", True):
        for form, on in (("single_pass", False), ("bricked", True)):
            d["ms_" + form] = time_ms(lambda: fn(*a, **k, bricked=on))
            d["device_us_by_kernel_" + form] = device_split(lambda: fn(*a, **k, bricked=on))
    else:
        d["device_us_by_kernel"] = device_split(lambda: fn(*a, **k))
    return d


def k3b_data(fn, a, k):
    """What one K3b call scatters: per stage the distinct storage rows its
    points' present corners touch and, where the wrapper reports them
    (``counts``), the (point, corner, channel) scatters, the atomics issued
    and the share merged in registers; where the kernel can be launched
    alone (``k3b_launch``), its time without the wrapper's zero fill of the
    capacity-sized gradients, and the zero fill's; on the card, the device
    time of a call by kernel (``device_split``)."""
    import torch
    from surf_tpu_torch.ops import sparse as sp
    stages, pts, cts = a[0], a[1], list(a[2:]) + [None] * (6 - len(a))
    off = sp.child_offsets(pts.device)
    rows = []
    for g, _ in stages:
        c0 = torch.floor((pts + 1.0) * 0.5 * (g.res - 1)).long()
        vox = torch.cat([c0 + off[j] for j in range(8)]).clamp(0, g.res - 1)
        r, valid = sp.lookup_rows(g, vox)
        rows.append(torch.unique(r[valid]).numel())
    d = {"distinct_rows_by_stage": rows,
         "cotangent_strides": [None if c is None else list(c.stride()) for c in cts[:4]]}
    if "counts" in inspect.signature(fn).parameters:
        cnt = torch.zeros(2, dtype=torch.int64, device=pts.device)
        fn(*a, **k, counts=cnt)
        scatters, atomics = cnt.tolist()
        d.update(corner_scatters=scatters, atomics=atomics,
                 merged_share=1.0 - atomics / scatters if scatters else 0.0)
    extra = {}
    if hasattr(sp, "k3b_launch") and pts.is_cuda:
        grads = [torch.zeros((s.shape[0], s.shape[-1]), dtype=torch.float32,
                             device=pts.device) for _, s in stages]
        extra["ms_kernel_only"] = time_ms(lambda: sp.k3b_launch(stages, pts, cts[:4], grads))
        extra["ms_zero_fill"] = time_ms(lambda: [g.zero_() for g in grads])
    if pts.is_cuda:
        d["device_us_by_kernel"] = device_split(lambda: fn(*a, **k))
    return d, extra


def bwd_entry(name, rec):
    from surf_tpu_torch.ops import grid_sample as gs, sparse as sp
    from surf_tpu_torch.nn import reg_net
    fns = {"bilinear_sample_2d_bwd": (gs.bilinear_sample_bwd, gs.bilinear_sample_bwd_plain),
           "trilinear_sample_3d_bwd": (gs.trilinear_sample_bwd,
                                       gs.trilinear_sample_bwd_plain),
           "sparse_trilinear_multi_bwd": (sp.sparse_trilinear_multi_bwd,
                                          sp.sparse_trilinear_multi_bwd_plain),
           "gather_conv_dw": (reg_net.gather_conv_dw, reg_net.gather_conv_dw_plain)}
    fn, plain = fns[name]
    _, a, k = rec
    got, ref = fn(*a, **k), plain(*a, **k)
    got = got if isinstance(got, (tuple, list)) else (got,)
    ref = ref if isinstance(ref, (tuple, list)) else (ref,)
    err = 0.0
    for x, y in zip(got, ref):
        if y is None:
            continue
        # f32 atomics sum in a run-dependent order; a bf16 gradient may
        # round to the neighbouring bf16 value
        rtol = 2.0 ** -7 if str(y.dtype) == "torch.bfloat16" else 1e-4
        err = max(err, check_close(f"{name} train call", x, y, rtol, 1e-5 * scale(y)))
    del got, ref
    b_ms, b_by, what = bwd_bound(name, a, k, None)
    lib = bwd_library(name, a, k)
    data, extra = {}, {}
    if name == "bilinear_sample_2d_bwd":
        data = {"data": texel_load(a[0], a[1], k.get("normalized", True),
                                   k.get("align_corners", True), a[2])}
    if name == "trilinear_sample_3d_bwd":
        data = {"data": k2b_data(fn, a, k)}
    if name == "sparse_trilinear_multi_bwd":
        d, extra = k3b_data(fn, a, k)
        data = {"data": d}
    if name == "gather_conv_dw":
        data = {"data": k4_data(a[1], a[3] if len(a) > 3 else None)}
        if len(a) > 3 and a[3] is not None:
            extra = {"ms_without_live_mask": time_ms(lambda: fn(*a[:3], **k))}
    lib_ms = None
    if lib is not None:
        import torch
        try:
            lib_ms = time_ms(lib)
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
    return {"shape": what, **data, "max_abs_err": err,
            "ms": time_ms(lambda: fn(*a, **k)),
            "plain_ms": time_ms(lambda: plain(*a, **k), 3),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms, **extra}


BWD_ROWS = {
    "bilinear_sample_2d_bwd": ("surf_tpu/ops/grid_sample.py:102",
                               "torch.ops.aten.grid_sampler_2d_backward, NCHW copy"),
    "trilinear_sample_3d_bwd": ("surf_tpu/ops/grid_sample.py:355",
                                "torch.ops.aten.grid_sampler_3d_backward, f32 NCDHW "
                                "copy, axes flipped"),
    "sparse_trilinear_multi_bwd": ("surf_tpu/ops/sparse.py:422",
                                   "none: no one PyTorch call scatters into a sparse "
                                   "voxel set"),
    "gather_conv_dw": ("surf_tpu/nn/reg_net.py:368",
                       "none: no one PyTorch call does a gathered sparse convolution's "
                       "weight gradient"),
}


def backward_kernels(launches, records, calls, dense_conv0=None):
    """One row per backward kernel.  K1b and K4w: the largest call of the
    train step heads the row, the largest call of each other kind is
    ``also_checked``.  K2b and K3b: the largest call of each (kind, call
    site) of the step (``record_backward_calls``), K2b's largest volume and
    K3b's largest call with the most cotangents first, each with its call
    site's launches in the step; the row gives them all as
    ``launches_in_train_step_by_call_site``.  ``dense_conv0`` (x, idx)
    adds K4w on the validate's 704^3 conv0 table (a densely active stage,
    as a trained model's is) with a random cotangent."""
    import torch
    rows = []
    src = {"sparse_trilinear_multi_bwd": "surf_tpu_torch/csrc/sparse_trilinear.cu",
           "gather_conv_dw": "surf_tpu_torch/csrc/gather_conv.cu"}
    for name in BWD_KERNELS:
        keyed = [(key, r) for key, r in records.items() if key[0] == name]
        if not keyed:
            fail(f"train: no {name} call was recorded")
        if name == "trilinear_sample_3d_bwd":
            # largest volume first
            keyed.sort(key=lambda kr: (-kr[1][1][0].numel(), -kr[1][0]))
        else:
            # largest first; of equal size, the call with the most cotangents
            keyed.sort(key=lambda kr: (-kr[1][0], -sum(x is not None for x in kr[1][1])))
        recs = [r for _, r in keyed]
        if name == "gather_conv_dw" and dense_conv0 is not None:
            x, idx, live = dense_conv0
            g = torch.Generator(device=x.device).manual_seed(3)
            ct = torch.randn(idx.shape[0], 8, device=x.device, generator=g)
            recs.append((0, (x, idx, ct) + (() if live is None else (live,)), {}))
        if name == "bilinear_sample_2d_bwd":
            # the head call again with a random cotangent on every row: a
            # trained model's denser stage, where no scatter can be skipped
            n_, (img, co, ct), k_ = recs[0]
            g = torch.Generator(device=ct.device).manual_seed(5)
            recs.append((n_, (img, co, torch.randn(ct.shape, device=ct.device, generator=g)),
                         k_))
        if name == "gather_conv_dw":
            # the wrapper narrows an int64 table on each call: time the
            # kernel on the narrowed one
            recs = [(n_, (a_[0], a_[1].to(torch.int32).contiguous()) + tuple(a_[2:]), k_)
                    for n_, a_, k_ in recs]
        entries = [bwd_entry(name, r) for r in recs]
        if name in BWD_BY_SITE:
            for e, (key, _) in zip(entries, keyed):
                e["call_site"] = bwd_label(*key)
                e["call_site_launches"] = calls["by_site"][key]
        if name == "gather_conv_dw" and dense_conv0 is not None:
            entries[-1]["shape"] = ("the validate's 704^3 conv0 table, a random "
                                    "cotangent: " + entries[-1]["shape"])
        if name == "bilinear_sample_2d_bwd":
            entries[-1]["shape"] = ("the head call with a random cotangent on every row: "
                                    + entries[-1]["shape"])
        replaces, library = BWD_ROWS[name]
        r = {"name": name, "route": "cuda",
             "source": src.get(name, "surf_tpu_torch/csrc/grid_sample.cu"),
             "replaces": replaces, "launches": launches[name], **entries[0],
             "tolerance": "|err| <= 1e-5 max(max|plain|, 1) + 1e-4 |plain| (bf16: "
                          "one bf16 step)", "library": library}
        if name in BWD_BY_SITE:
            r["launches_in_train_step_by_call_site"] = bwd_site_launches(calls)[name]
        if len(entries) > 1:
            r["also_checked"] = entries[1:]
        say("kernel", json.dumps(r))
        rows.append(r)
    return rows


def finetune_k3b_entries(records, calls):
    """K3b at each (kind, call site) of a finetune step, as
    ``backward_kernels`` takes the training step's."""
    out = []
    for key, rec in sorted(records.items(), key=lambda kr: -sum(
            x is not None for x in kr[1][1])):
        e = bwd_entry(key[0], rec)
        e["shape"] = "finetune step: " + e["shape"]
        e["call_site"] = "finetune, " + bwd_label(*key)
        e["call_site_launches"] = calls["by_site"][key]
        out.append(e)
    return out


# ---------------------------------------------------------------------------
# phase 8: per-scene finetune at full width, from the train phase's checkpoint
# ---------------------------------------------------------------------------

def finetune_phase(ckpt, n_steps=3, dev="cuda", conf_path=None):
    """A Finetuner on confs/surf_synthetic_finetune.conf resumed from
    ``ckpt`` (``--resume``): ``init_volumes``, ``n_steps`` steps on the
    loop's first batches with the launch counts zeroed before them, one
    ``validate_finetune`` and a ``save_finetune`` read back as
    ``--load_vol`` reads it; the last step's K3b calls recorded.  Returns
    (launches, metrics, and the records and calls of
    ``record_backward_calls``).  Everything is written under a temporary
    directory that the phase deletes.  (``dev`` "cpu" with a tiny
    ``conf_path`` rehearses the phase without a card.)"""
    import math
    import shutil
    import tempfile
    import torch
    from surf_tpu_torch import _build
    from surf_tpu_torch.config import ConfigFactory
    from surf_tpu_torch.finetune import Finetuner
    from surf_tpu_torch.utils import resume_from
    from surf_tpu_torch.validate import to_device
    cuda = dev == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()
    conf = ConfigFactory.parse_file(
        conf_path or os.path.join(HERE, "confs", "surf_synthetic_finetune.conf"))
    os.makedirs(os.path.join(HERE, "exp"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_finetune_", dir=os.path.join(HERE, "exp"))
    try:
        sync()
        t0 = time.time()
        f = Finetuner(conf, device=dev, seed=0, base_exp_dir=tmp, resume=ckpt,
                      mesh_resolution=512 if cuda else 24)
        sync()
        init_s = time.time() - t0
        say("finetune", f"resumed from {os.path.basename(ckpt)}, init_volumes included: "
            f"{init_s:.3f} s, active_voxels="
            f"{[int(g.cvalid.sum()) for g in f.vol_state['grids']]}")
        ds = f.dataset
        perm = f.host_rng.permutation(ds.num_views)
        batches = [to_device(ds.get_random_rays(int(perm[i % len(perm)]), rng=f.host_rng), dev)
                   for i in range(n_steps)]
        before = {g["name"]: [p.detach().clone() for p in g["params"]]
                  for g in f.optimizer.param_groups}
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        times = []
        for i in range(n_steps):
            if i == n_steps - 1:
                records, calls, restore = record_backward_calls(["sparse_trilinear_multi_bwd"])
            t0 = time.time()
            try:
                res = f.step(batches[i], i)
                sync()
            finally:
                if i == n_steps - 1:
                    restore()
            times.append(time.time() - t0)
            say("finetune", f"step {i} ({'cold' if i == 0 else 'warm'}): {times[-1]:.3f} s "
                + " ".join(f"{k}={v:.5g}" for k, v in res.items()))
            if not all(math.isfinite(v) for v in res.values()):
                fail(f"finetune: non-finite loss terms at step {i}: {res}")
        launches = dict(_build.launches)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        moved = {g["name"]: sum(int(not torch.equal(a, p.detach())) for a, p in zip(
            before[g["name"]], g["params"])) for g in f.optimizer.param_groups}
        metrics = {"cold_step_s": times[0], "warm_s_per_step": statistics.mean(times[1:]),
                   "warm_steps_s": times[1:], "peak_mem_gb": peak / 2 ** 30,
                   "init_s": init_s, "params_moved": moved,
                   "params_per_group": {g["name"]: len(g["params"])
                                        for g in f.optimizer.param_groups},
                   "k3b_call_sites_last_step":
                       bwd_site_launches(calls)["sparse_trilinear_multi_bwd"]}
        say("finetune", "kernels " + json.dumps(launches))
        missing = [k for k in ("sparse_trilinear_multi", "sparse_trilinear_multi_bwd")
                   if launches[k] <= 0]
        if missing:
            fail(f"finetune: the finetune steps launched no {missing}")
        if any(v == 0 for v in moved.values()):
            fail(f"finetune: the implicit surface or a stage's storage did not move: {moved}")

        t0 = time.time()
        m = f.validate_finetune(n_steps - 1)
        metrics.update({"validate_" + k: m[k] for k in
                        ("mesh_s", "render_rays_per_s", "psnr", "mesh_vertices",
                         "mesh_faces")})
        if m["mesh_faces"] <= 0 or m["mesh_vertices"] <= 0 or not m["finite"]:
            fail(f"finetune: validate_finetune gave an empty mesh or non-finite render: {m}")
        say("finetune", f"validate_finetune: {time.time() - t0:.1f} s")

        t0 = time.time()
        path = f.save_finetune(n_steps - 1)
        size = os.path.getsize(path)
        _, _, vs = resume_from(path, f.params, f.state, load_vol=True, device=f.device)
        if vs["matching_volume"].dtype != f.vol_state["matching_volume"].dtype:
            fail("finetune: --load_vol changed the matching volume's dtype")
        pairs = [(a, b.detach()) for a, b in zip(vs["volumes"], f.vol_state["volumes"])]
        pairs += [(vs["matching_volume"], f.vol_state["matching_volume"])]
        pairs += list(zip(vs["features"], f.vol_state["features"]))
        pairs += [(a, b) for ga, gb in zip(vs["grids"], f.vol_state["grids"])
                  for a, b in zip(ga, gb)]
        if not all(torch.equal(a, b) for a, b in pairs):
            fail("finetune: the --load_vol round trip changed the volumes")
        metrics["checkpoint_gb"] = size / 2 ** 30
        say("finetune", f"save_finetune + --load_vol: {len(pairs)} tensors bit-equal "
            f"(matching volume {str(vs['matching_volume'].dtype).split('.')[-1]}), "
            f"{size / 2 ** 30:.3f} GiB, {time.time() - t0:.1f} s")
        say("finetune", json.dumps(metrics))
        return launches, metrics, records, calls
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 9: tiny model, card against CPU
# ---------------------------------------------------------------------------

def reference_check():
    import numpy as np
    import torch
    from surf_tpu_torch.config import ConfigFactory
    from surf_tpu_torch.nn import implicit_surface
    from surf_tpu_torch.validate import Validator, to_device

    conf = ConfigFactory.parse_string(TINY)
    out_dir = os.path.join(HERE, "exp", "chip_smoke_tiny")
    vc = Validator(conf, device="cpu", mesh_resolution=24, base_exp_dir=out_dir)

    def to_cuda(t):
        if isinstance(t, dict):
            return {k: to_cuda(x) for k, x in t.items()}
        if isinstance(t, list):
            return [to_cuda(x) for x in t]
        return t.cuda()

    vg = Validator(conf, device="cuda", mesh_resolution=24, base_exp_dir=out_dir,
                   params=to_cuda(vc.params), state=to_cuda(vc.state))
    batch = vc.dataset[0]
    res = {}
    for name, v, dev in (("cpu", vc, "cpu"), ("cuda", vg, "cuda")):
        ipts = to_device(batch, dev)
        outs, stages, mv, feats = v.build(ipts)
        ff = feats[::-1]
        r = implicit_surface.render(
            v.params["implicit_surface"], v.static["implicit_surface"],
            ipts["rays_o"][:256], ipts["rays_d"][:256], ipts["near"], ipts["far"],
            mv, stages[::-1], ff, ipts["imgs"], ipts["intrs"], ipts["c2ws"], 1.0)
        _, _, u = v.extract_geometry(stages[::-1], 24, block=16)
        keyed = []
        for g, s in stages:
            cc = g.child_coords()[g.cvalid]
            lin = ((cc[:, 0] * g.res + cc[:, 1]) * g.res + cc[:, 2]).cpu().numpy()
            order = np.argsort(lin)
            keyed.append((lin[order], s[g.cvalid].cpu().numpy()[order]))
        res[name] = (outs, keyed, r, u)
    (oc, kc, rc, uc), (og, kg, rg, ug) = res["cpu"], res["cuda"]
    err = 0.0
    for (lc, fc), (lg, fg) in zip(kc, kg):
        if not np.array_equal(lc, lg):
            fail("reference: active voxel sets differ between card and CPU")
        err = max(err, check_close("reference stage features", torch.from_numpy(fg),
                                   torch.from_numpy(fc), 1e-4, 1e-4))
    for k in oc:
        err = max(err, check_close(f"reference {k}", og[k].cpu(), oc[k], 1e-4, 1e-4))
    for k in ("color_fine", "render_depth", "weights", "gradients", "inside_sphere"):
        err = max(err, check_close(f"reference {k}", rg[k].cpu(), rc[k], 1e-4, 1e-4))
    err = max(err, check_close("reference lattice", torch.from_numpy(ug),
                               torch.from_numpy(uc), 1e-4, 1e-4))
    return max(err, reference_train_step(conf))


@contextlib.contextmanager
def plain_versions():
    """Every kernel's wrapper replaced by its plain PyTorch version (the
    callers and the autograd functions look the wrappers up as module
    attributes at call time), so the same code runs with no kernel."""
    from surf_tpu_torch.ops import grid_sample as gs, sparse as sp
    from surf_tpu_torch.nn import reg_net
    swaps = [(gs, "bilinear_sample", gs.bilinear_sample_plain),
             (gs, "bilinear_sample_bwd", gs.bilinear_sample_bwd_plain),
             (gs, "trilinear_sample", gs.trilinear_sample_plain),
             (gs, "trilinear_sample_bwd", gs.trilinear_sample_bwd_plain),
             (sp, "sparse_trilinear_multi", sp.sparse_trilinear_multi_plain),
             (sp, "sparse_trilinear_multi_bwd", sp.sparse_trilinear_multi_bwd_plain),
             (reg_net, "gather_conv", reg_net.gather_conv_plain),
             (reg_net, "gather_conv_dw", reg_net.gather_conv_dw_plain)]
    orig = [getattr(m, n) for m, n, _ in swaps]
    for m, n, f in swaps:
        setattr(m, n, f)
    try:
        yield
    finally:
        for (m, n, _), f in zip(swaps, orig):
            setattr(m, n, f)


def reference_train_step(conf):
    """One tiny training step's loss terms and gradients on the CPU, on the
    card with the kernels and on the card with the plain versions: the
    same parameters, batch and probe points, unperturbed, with the hybrid
    U-Net at stage 1 so every backward kernel runs.  Loss terms, card
    against CPU, within 1e-4 relative.  Each gradient leaf, kernels
    against plain versions on the card, within 1e-3 of its largest entry
    (atomics and sums in another order, through three orders of
    differentiation); card against CPU within 5e-3: the plain PyTorch ops
    themselves (cuBLAS, the card's exp and log in the softplus(100x) MLP)
    move the SDF net's gradients by about 2e-3 from the CPU's.  Plus 1e-6
    for the three leaves whose gradient is 0 by softmax shift invariance,
    given by all as round-off."""
    import torch
    from surf_tpu_torch import _build
    from surf_tpu_torch.nn.core import tree_leaves
    from surf_tpu_torch.train import Trainer
    from surf_tpu_torch.utils import to_numpy_tree, to_torch_tree
    from surf_tpu_torch.validate import to_device
    out_dir = os.path.join(HERE, "exp", "chip_smoke_tiny_train")
    runs = {}
    for name in ("cpu", "cuda", "cuda plain"):
        dev = name.split()[0]
        if dev == "cpu":
            tr = Trainer(conf, device="cpu", base_exp_dir=out_dir)
            init = (to_numpy_tree(tr.params), to_numpy_tree(tr.state))
        else:
            tr = Trainer(conf, device="cuda", base_exp_dir=out_dir,
                         params=to_torch_tree(init[0], "cuda"),
                         state=to_torch_tree(init[1], "cuda"))
        tr.static["dense_unet_max_res"] = 16
        tr.static["implicit_surface"] = dict(tr.static["implicit_surface"], perturb=0.0)
        batch = to_device(tr.dataset[0], dev)
        probe = torch.linspace(-0.9, 0.9, 3072, device=dev).reshape(1024, 3)
        _build.reset_launches()
        with plain_versions() if name.endswith("plain") else contextlib.nullcontext():
            res, _ = tr.loss(batch, 1.0, 0.5, perturb=False, pts_random=probe)
            res["loss"].backward()
        runs[name] = (res, dict(_build.launches),
                      [t.grad.detach().cpu() for t in tree_leaves(tr.params)])
    missing = [k for k in BWD_KERNELS if runs["cuda"][1][k] <= 0]
    if missing or any(runs["cuda plain"][1].values()):
        fail(f"reference: the tiny train step on the card launched no {missing}, or "
             f"the plain run launched {runs['cuda plain'][1]}")
    err = 0.0
    (rc, _, gc), (rg, _, gg), (_, _, gp) = runs["cpu"], runs["cuda"], runs["cuda plain"]
    for k in rc:
        a = rg[k].detach().cpu().reshape(1) if torch.is_tensor(rg[k]) else torch.tensor([rg[k]])
        b = rc[k].detach().reshape(1) if torch.is_tensor(rc[k]) else torch.tensor([rc[k]])
        err = max(err, check_close(f"reference train {k}", a, b, 1e-4, 1e-5))
    for what, ref, rel in (("plain versions on the card", gp, 1e-3), ("CPU", gc, 5e-3)):
        worst = 0.0
        for a, b in zip(gg, ref):
            d, scale = (a - b).abs().max().item(), b.abs().max().item()
            if d > rel * scale + 1e-6:
                fail(f"reference train: a gradient leaf differs from the {what} by "
                     f"{d:.3e} > {rel * scale + 1e-6:.3e}")
            if scale > 1e-6:
                worst = max(worst, d / scale)
        say("reference", f"train step gradients against the {what}: worst leaf "
            f"{worst:.3e} of its largest entry")
    return err

def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an NVIDIA GPU")
    sys.path.insert(0, HERE)
    try:
        from surf_tpu_torch import _build
        from surf_tpu_torch.card import nvidia_smi_line, set_numerics
        from surf_tpu_torch.config import ConfigFactory
        from surf_tpu_torch.validate import Validator
    except ImportError as e:
        fail(f"the surf_tpu_torch package is not beside this script ({e})")
    conf_path = os.path.join(HERE, "confs", "surf_synthetic_full.conf")
    if not os.path.exists(conf_path):
        fail(f"missing {conf_path}")
    set_numerics()
    t_start = time.time()

    smi_line = nvidia_smi_line()
    say("device", f"{smi_line} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.time()
    reports = _build.build_kernels()
    say("build", f"{len(reports)} kernel libraries in {time.time() - t0:.1f} s")
    for name, log in reports.items():
        for line in log.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                say("build", f"{name}: {line.strip()}")

    t0 = time.time()
    err = ragged_checks(torch.device("cuda"))
    say("ragged", f"K1-K4, K1b-K3b and K4w match their plain versions, max abs err "
        f"{err:.3e} "
        f"({time.time() - t0:.1f} s)")

    conf = ConfigFactory.parse_file(conf_path)
    count_grid_form_calls()
    v = Validator(conf, device="cuda", mesh_resolution=512, seed=0,
                  base_exp_dir=os.path.join(HERE, "exp", "chip_smoke"))
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.time()
    with count_call_sites() as sites:
        results = v.validate()
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    wall = time.time() - t0
    m = results[0]
    say("validate", f"build_s={m['build_s']:.3f} mesh_s={m['mesh_s']:.3f} "
        f"render_rays_per_s={m['render_rays_per_s']:.1f} psnr={m['psnr']:.3f} "
        f"active_voxels={m['active_voxels']} mesh=({m['mesh_vertices']} v, "
        f"{m['mesh_faces']} f) peak_mem_gb="
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} wall_s={wall:.1f}")
    say("validate", "kernels " + json.dumps(launches) + ", K2 and K3 by call site "
        + json.dumps(sites))
    missing = [k for k in FWD_KERNELS if launches[k] <= 0]
    if missing:
        fail(f"the main path launched no {missing}")
    if not m["finite"]:
        fail("non-finite render outputs")
    if m["mesh_faces"] <= 0 or m["mesh_vertices"] <= 0:
        fail("empty mesh")
    if len(m["active_voxels"]) != 4 or min(m["active_voxels"]) <= 0:
        fail(f"cascade active sets {m['active_voxels']}")

    cold = v.last_scene
    m, k4_calls, mesh_call = warm_validate(v)
    say("warm", f"build_s={m['build_s']:.3f} mesh_s={m['mesh_s']:.3f} "
        f"render_rays_per_s={m['render_rays_per_s']:.1f} "
        f"active_voxels={m['active_voxels']} gather_conv calls recorded: {len(k4_calls)}")
    if not same_cascade(cold, v.last_scene):
        fail("the warm validate's cascade differs from the first one's bits")
    say("warm", "cascade (parents, active children, storage, matching volume, "
        "features) equal bit for bit to the first validate's")
    del cold

    rows = main_path_kernels(v, launches, k4_calls, mesh_call, sites)
    del mesh_call
    t0 = time.time()
    grid_rows = grid_form_kernels(k4_calls)
    say("kernel", f"row 7 (grid-form convs): {time.time() - t0:.1f} s")
    # the 704^3 conv0 (x, table, live-row mask) of the validate, for K4w on
    # a dense stage
    dense_conv0 = next((c[2], c[3].to(torch.int32), c[5]) for c in k4_calls
                       if c[0].res == 704 and c[1] == 0)
    v.last_scene = k4_calls = None
    del v
    torch.cuda.empty_cache()

    t0 = time.time()
    train_launches, records, bwd_calls, train_metrics, ckpt, k4_largest = \
        train_phase(conf_path)
    train_sites = dict(train_metrics["k2_k3_call_sites_last_step"],
                       gather_conv=train_metrics["k4_call_sites_last_step"])
    for r in rows:
        r["launches_in_train"] = train_launches[r["name"]]
        if r["name"] in train_sites:
            r["launches_in_train_step_by_call_site"] = train_sites[r["name"]]
        if r["name"] == "gather_conv":
            r["also_checked"] += k4_train_entries(k4_largest)
            say("kernel", "K4 in the training step: " + json.dumps(r["also_checked"][-2:]))
    del k4_largest
    torch.cuda.empty_cache()
    rows += backward_kernels(train_launches, records, bwd_calls, dense_conv0)
    del records, dense_conv0
    torch.cuda.empty_cache()
    say("train", f"phase and backward kernel checks: {time.time() - t0:.1f} s")

    t0 = time.time()
    ft_launches, ft_metrics, ft_records, ft_calls = finetune_phase(ckpt)
    for r in rows:
        r["launches_in_finetune"] = ft_launches[r["name"]]
        if r["name"] == "sparse_trilinear_multi_bwd":
            r["launches_in_finetune_step_by_call_site"] = ft_metrics["k3b_call_sites_last_step"]
            r.setdefault("also_checked", []).extend(finetune_k3b_entries(ft_records, ft_calls))
            say("kernel", "K3b in the finetune step: " + json.dumps(r["also_checked"][-len(
                ft_records):]))
    del ft_records
    torch.cuda.empty_cache()
    say("finetune", f"phase: {time.time() - t0:.1f} s")
    # no path called the grid-form ops: their launches on the paths
    for r in grid_rows:
        r["launches"] = GRID_CALLS["n"]
    rows += grid_rows

    t0 = time.time()
    err = reference_check()
    say("reference", f"tiny model (validate and one training step) on the card matches "
        f"the CPU plain path, max abs err {err:.3e} ({time.time() - t0:.1f} s)")
    say("total", f"{time.time() - t_start:.1f} s")

    print(json.dumps({"kernels": rows}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
