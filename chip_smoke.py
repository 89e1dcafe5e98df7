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
   and a pile-up of points on one texel;
4. validate: the port's main path, ``Validator.validate`` on
   confs/surf_synthetic_full.conf (4-stage cascade 88^3 -> 704^3, 512^3
   mesh, 144x200 render) with seeded random weights; every kernel's
   launch count is zeroed just before and read just after, and must be
   > 0.  This first call in the process is cold;
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
   also say how their points fall on the image (``data``).  Then the
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
   in the last step is recorded; K1b, K2b, K3b and K4w are then held
   against their plain versions and measured on those calls as in 6.
   K1b's entries give the share of all-zero cotangent rows (whose
   scatter the kernel skips) and the most points on one texel; its row
   also times its largest call again with a random cotangent on every
   row, as a trained model's denser stage would give.
   The trainer saves its checkpoint;
8. finetune: a ``Finetuner`` on confs/surf_synthetic_finetune.conf (5
   views of 576x800, 512 rays, 4 stages to 704^3) resumes from that
   checkpoint as ``--resume`` does, in a temporary directory the phase
   deletes; ``init_volumes``, then 3 steps (one cold, two warm) with every
   launch count zeroed before them: K3 and K3b must have run, the loss
   must be finite and the implicit surface and every stage's storage
   must move.  Then one ``validate_finetune`` (512^3 mesh, non-empty) and
   a ``save_finetune`` read back as ``--load_vol`` reads it, bit for bit
   (the bf16 matching volume included).  Prints s/step, peak memory,
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
            out.append(check_close(
                f"K2 ragged {dt}", gs.trilinear_sample(vol, pts, align_corners=align),
                gs.trilinear_sample_plain(vol, pts, align_corners=align), 1e-5, 1e-5))
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
            out.append(check_close(f"K3 ragged {name}", a, b, 1e-5,
                                   1e-5 * max(b.abs().max().item(), 1.0)))
    got = sp.sparse_trilinear_multi(stages, pts3, third=True)
    ref = sp.sparse_trilinear_multi_plain(stages, pts3, third=True)
    for name, a, b in zip(("feats", "jac", "hmix", "third"), got[:1] + got[2:],
                          ref[:1] + ref[2:]):
        out.append(check_close(f"K3 training variant {name}", a, b, 1e-5, 1e-5 * scale(b)))
    # K4: odd channel counts, misses (-1)
    x = torch.randn(1003, 13, device=dev, generator=g)
    idx = torch.randint(-1, 1003, (2011, 27), device=dev, generator=g).to(torch.int32)
    w = torch.randn(27, 13, 7, device=dev, generator=g)
    out.append(check_close("K4 ragged", reg_net.gather_conv(x, idx, w),
                           reg_net.gather_conv_plain(x, idx, w), 1e-4, 1e-4))
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
    K4 call of ``apply_hybrid`` recorded as (grid, call index, x, idx, w).
    The wrappers are the port's own; only the recording is added."""
    from surf_tpu_torch.nn import reg_net
    hybrid, gconv = reg_net.apply_hybrid, reg_net.gather_conv
    calls, cur = [], {}

    def rec_hybrid(params, state, grid, feats, **kw):
        cur["grid"], cur["i"] = grid, 0
        return hybrid(params, state, grid, feats, **kw)

    def rec_gconv(x, idx, w):
        calls.append((cur["grid"], cur["i"], x, idx, w))
        cur["i"] += 1
        return gconv(x, idx, w)

    reg_net.apply_hybrid, reg_net.gather_conv = rec_hybrid, rec_gconv
    try:
        m = v.validate()[0]
    finally:
        reg_net.apply_hybrid, reg_net.gather_conv = hybrid, gconv
    if [c[1] for c in calls] != list(range(6)) * (len(calls) // 6) or not calls:
        fail(f"apply_hybrid made {len(calls)} gather_conv calls, not 6 a stage")
    return m, calls


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


def distinct_taps(sizes, co, align):
    """Distinct in-range texels (sizes (V, H, W), co (V, N, 2) as (x, y))
    or voxels (sizes (X, Y, Z), co (N, 3)) that the bilinear/trilinear taps
    at normalized coords ``co`` read."""
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
    return torch.unique(torch.cat(ids)).numel()


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
    at one call site (align_corners=False, as every K2 call of the path)."""
    import torch.nn.functional as F
    from surf_tpu_torch.ops import grid_sample as gs
    got = gs.trilinear_sample(vol, pts, align_corners=False)
    err = check_close(f"K2 {what}", got,
                      gs.trilinear_sample_plain(vol, pts, align_corners=False), 1e-5, 1e-5)
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
    return {"shape": f"{what}: volume {tuple(vol.shape)} {str(vol.dtype).split('.')[-1]}, "
                     f"{n} points, {voxels} distinct voxels read",
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


def k4_entry(grid, i, x, idx, w):
    """K4 against its plain version on one recorded apply_hybrid call."""
    import torch
    from surf_tpu_torch.nn import reg_net
    what, index_bytes = K4_CALLS[i]
    # the wrapper narrows int64 tables to int32 on each call; time the
    # kernel alone on the narrowed table
    idx = idx.to(torch.int32).contiguous()
    got = reg_net.gather_conv(x, idx, w)
    ref = reg_net.gather_conv_plain(x, idx, w)
    err = check_close(f"K4 {grid.res}^3 {what}", got, ref, 1e-4,
                      1e-4 * max(ref.abs().max().item(), 1.0))
    R, T = idx.shape
    Cin, Cout = w.shape[1], w.shape[2]
    present = idx[idx >= 0]
    rows_read = torch.unique(present).numel()
    P = grid.parents.shape[0]
    b_ms, b_by = bound(index_bytes(P) + rows_read * Cin * 4 + nbytes(w) + R * Cout * 4,
                       2 * present.numel() * Cin * Cout)
    return {"shape": f"{grid.res}^3 {what}: {R} rows x {T} taps ({present.numel()} "
                     f"present, {rows_read} distinct rows of x read), {Cin} -> {Cout} "
                     f"channels, {P} parents",
            "max_abs_err": err,
            "ms": time_ms(lambda: reg_net.gather_conv(x, idx, w)),
            "plain_ms": time_ms(lambda: reg_net.gather_conv_plain(x, idx, w), 3),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


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


def main_path_kernels(v, launches, k4_calls):
    """One row per kernel: its headline call site, and ``also_checked``
    entries for its other call sites on the main path."""
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
    k2 = [k2_entry("build_z_vals", mv, p2)]
    rof, rdf = pixels_to_rays(make_pixel_grid((H, W), device=mv.device), intrs[0], c2ws[0])
    nf = ipts["near_fars"][0]
    z = nf[0] + (nf[1] - nf[0]) * torch.linspace(0.0, 1.0, 32, device=mv.device)
    k2.append(k2_entry("depth_render", mv, (rof[:, None] + rdf[:, None] * z[None, :, None])
                       .reshape(-1, 3).contiguous()))
    rows.append(row("trilinear_sample_3d", "surf_tpu_torch/csrc/grid_sample.cu",
                    "surf_tpu/ops/grid_sample.py:347", k2, "|err| <= 1e-5 + 1e-5 |plain|",
                    "F.grid_sample, 3-D, f32 NCDHW copy, axes flipped"))

    # K3: the render chunk's 4-stage lookup with derivatives
    pts = pts.contiguous()
    got = sp.sparse_trilinear_multi(stages_ff, pts, derivs=True)
    ref = sp.sparse_trilinear_multi_plain(stages_ff, pts, derivs=True)
    if not torch.equal(got[1], ref[1]):
        fail(f"K3 main: occupancy differs at {(got[1] != ref[1]).sum().item()} points")
    err = 0.0
    for name, a, b in zip(("feats", "jac", "hmix"), (got[0], got[2], got[3]),
                          (ref[0], ref[2], ref[3])):
        err = max(err, check_close(f"K3 main {name}", a, b, 1e-5,
                                   1e-5 * max(b.abs().max().item(), 1.0)))
    n3, ctot = got[0].shape
    moved = nbytes(pts) + sum(nbytes(t) for t in got) + k3_bytes_read(stages_ff, pts)
    b_ms, b_by = bound(moved, n3 * ctot * 8 * 14)
    del got, ref
    rows.append(row("sparse_trilinear_multi", "surf_tpu_torch/csrc/sparse_trilinear.cu",
                    "surf_tpu/ops/sparse.py:422", [{
                        "shape": f"render chunk: {n3} points, stages "
                                 f"{[g.res for g, _ in stages_ff]}, {ctot} channels, "
                                 "value + jacobian + mixed 2nd derivatives + occupancy",
                        "max_abs_err": err,
                        "ms": time_ms(lambda: sp.sparse_trilinear_multi(stages_ff, pts,
                                                                        derivs=True)),
                        "plain_ms": time_ms(lambda: sp.sparse_trilinear_multi_plain(
                            stages_ff, pts, derivs=True), 3),
                        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}],
                    "|err| <= 1e-5 max(max|plain|, 1) + 1e-5 |plain|, occupancy equal",
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
    for grid, i, x, idx_nbr, w27 in k4_calls:
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
                    "max_abs_err": err, "ms": time_ms(fn), "plain_ms": time_ms(plain, 3),
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


def record_backward_calls():
    """Wrap the four backward kernels' wrappers (the autograd functions
    call them by module attribute) to keep, per kernel and per kind of
    call (which gradients / cotangents it takes), the arguments of its
    largest call.  Returns (records, calls, restore)."""
    from surf_tpu_torch.ops import grid_sample as gs, sparse as sp
    from surf_tpu_torch.nn import reg_net
    where = {"bilinear_sample_2d_bwd": (gs, "bilinear_sample_bwd"),
             "trilinear_sample_3d_bwd": (gs, "trilinear_sample_bwd"),
             "sparse_trilinear_multi_bwd": (sp, "sparse_trilinear_multi_bwd"),
             "gather_conv_dw": (reg_net, "gather_conv_dw")}
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
    records, calls, orig = {}, {}, {}

    def wrap(name, fn):
        def rec(*a, **k):
            key = (name, kind[name](a, k))
            calls[name] = calls.get(name, 0) + 1
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


def train_phase(conf_path, n_steps=3, dev="cuda"):
    """A Trainer at full width: ``n_steps`` steps on the first scenes, the
    launch counts zeroed before and read after; the last step's backward
    calls recorded.  (``dev`` "cpu" rehearses the phase without a card.)"""
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
        if i == n_steps - 1:
            records, calls, restore = record_backward_calls()
        t0 = time.time()
        try:
            res = t.step(batches[i], i / n)
            if cuda:
                torch.cuda.synchronize()
        finally:
            if i == n_steps - 1:
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
               "params_per_group": sizes, "backward_calls_last_step": calls}
    say("train", json.dumps(metrics))
    say("train", "kernels " + json.dumps(launches))
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        fail(f"train: the training path launched no {missing}")
    if any(moved[g] == 0 for g in moved):
        fail(f"train: no parameter moved in some group: {moved}")
    return launches, records, metrics, t.save(n_steps - 1)


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
    x, idx, ct = a
    R, T = idx.shape
    present = idx[idx >= 0]
    rows_read = torch.unique(present).numel()
    Cin, Cout = x.shape[1], ct.shape[1]
    moved = idx.numel() * 4 + rows_read * Cin * 4 + nbytes(ct) + T * Cin * Cout * 4
    what = (f"{R} rows x {T} taps ({present.numel()} present, {rows_read} distinct rows of "
            f"x read), {Cin} -> {Cout} channels")
    return (*bound(moved, 2 * present.numel() * Cin * Cout), what)


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
    b_ms, b_by, what = bwd_bound(name, a, k, got)
    lib = bwd_library(name, a, k)
    data = {}
    if name == "bilinear_sample_2d_bwd":
        data = {"data": texel_load(a[0], a[1], k.get("normalized", True),
                                   k.get("align_corners", True), a[2])}
    return {"shape": what, **data, "max_abs_err": err,
            "ms": time_ms(lambda: fn(*a, **k)),
            "plain_ms": time_ms(lambda: plain(*a, **k), 3),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(lib) if lib is not None else None}


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


def backward_kernels(launches, records, dense_conv0=None):
    """One row per backward kernel: its largest call of the train step
    heads it, the largest call of each other kind is ``also_checked``.
    ``dense_conv0`` (x, idx) adds K4w on the validate's 704^3 conv0 table
    (a densely active stage, as a trained model's is) with a random
    cotangent."""
    import torch
    rows = []
    src = {"sparse_trilinear_multi_bwd": "surf_tpu_torch/csrc/sparse_trilinear.cu",
           "gather_conv_dw": "surf_tpu_torch/csrc/gather_conv.cu"}
    for name in BWD_KERNELS:
        # largest first; of equal size, the call with the most cotangents
        recs = sorted((r for key, r in records.items() if key[0] == name),
                      key=lambda r: (-r[0], -sum(x is not None for x in r[1])))
        if not recs:
            fail(f"train: no {name} call was recorded")
        if name == "gather_conv_dw" and dense_conv0 is not None:
            x, idx = dense_conv0
            g = torch.Generator(device=x.device).manual_seed(3)
            ct = torch.randn(idx.shape[0], 8, device=x.device, generator=g)
            recs.append((0, (x, idx, ct), {}))
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
            recs = [(n_, (a_[0], a_[1].to(torch.int32).contiguous(), a_[2]), k_)
                    for n_, a_, k_ in recs]
        entries = [bwd_entry(name, r) for r in recs]
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
        if len(entries) > 1:
            r["also_checked"] = entries[1:]
        say("kernel", json.dumps(r))
        rows.append(r)
    return rows


# ---------------------------------------------------------------------------
# phase 8: per-scene finetune at full width, from the train phase's checkpoint
# ---------------------------------------------------------------------------

def finetune_phase(ckpt, n_steps=3, dev="cuda", conf_path=None):
    """A Finetuner on confs/surf_synthetic_finetune.conf resumed from
    ``ckpt`` (``--resume``): ``init_volumes``, ``n_steps`` steps on the
    loop's first batches with the launch counts zeroed before them, one
    ``validate_finetune`` and a ``save_finetune`` read back as
    ``--load_vol`` reads it.  Everything is written under a temporary
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
            t0 = time.time()
            res = f.step(batches[i], i)
            sync()
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
                                        for g in f.optimizer.param_groups}}
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
        return launches, metrics
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
    say("validate", "kernels " + json.dumps(launches))
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
    m, k4_calls = warm_validate(v)
    say("warm", f"build_s={m['build_s']:.3f} mesh_s={m['mesh_s']:.3f} "
        f"render_rays_per_s={m['render_rays_per_s']:.1f} "
        f"active_voxels={m['active_voxels']} gather_conv calls recorded: {len(k4_calls)}")
    if not same_cascade(cold, v.last_scene):
        fail("the warm validate's cascade differs from the first one's bits")
    say("warm", "cascade (parents, active children, storage, matching volume, "
        "features) equal bit for bit to the first validate's")
    del cold

    rows = main_path_kernels(v, launches, k4_calls)
    t0 = time.time()
    grid_rows = grid_form_kernels(k4_calls)
    say("kernel", f"row 7 (grid-form convs): {time.time() - t0:.1f} s")
    # the 704^3 conv0 (x, table) of the validate, for K4w on a dense stage
    dense_conv0 = next((c[2], c[3].to(torch.int32)) for c in k4_calls
                       if c[0].res == 704 and c[1] == 0)
    v.last_scene = k4_calls = None
    del v
    torch.cuda.empty_cache()

    t0 = time.time()
    train_launches, records, _, ckpt = train_phase(conf_path)
    for r in rows:
        r["launches_in_train"] = train_launches[r["name"]]
    torch.cuda.empty_cache()
    rows += backward_kernels(train_launches, records, dense_conv0)
    del records, dense_conv0
    torch.cuda.empty_cache()
    say("train", f"phase and backward kernel checks: {time.time() - t0:.1f} s")

    t0 = time.time()
    ft_launches, _ = finetune_phase(ckpt)
    for r in rows:
        r["launches_in_finetune"] = ft_launches[r["name"]]
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
