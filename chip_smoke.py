#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero, with no result line):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: the four hand-written kernels (surf_tpu_torch/csrc/*.cu) with
   nvcc for sm_90a, one process per source, in parallel;
3. ragged: every kernel against its plain PyTorch version on odd shapes
   with out-of-range points;
4. validate: the port's main path, ``Validator.validate`` on
   confs/surf_synthetic_full.conf (4-stage cascade 88^3 -> 704^3, 512^3
   mesh, 144x200 render) with seeded random weights; every kernel's
   launch count is zeroed just before and read just after, and must be
   > 0.  This first call in the process is cold;
5. warm: a second validate, for warm metrics, with every gather_conv call
   of ``apply_hybrid`` recorded; its cascade must equal the first one's
   bit for bit;
6. kernels: each kernel against its plain version at its main-path call
   sites (the validate's own stages, volumes, images and recorded K4
   inputs), with median times (CUDA events) of the kernel, the plain
   version and, where one PyTorch call computes the same function, that
   call, and the bound: the bytes the function must read and write (each
   distinct texel, voxel or row once) at the card's memory rate, or its
   f32 operations at the card's peak, whichever takes longer;
7. reference: the tiny model on the card against the same model on the
   CPU (plain versions, themselves held against the JAX package by the
   tier-1 tests).

The last three lines are the kernels JSON, the nvidia-smi line and the
result line ``{"ok": true, "device": {...}}``.  The port's numeric settings
(``surf_tpu_torch.card.set_numerics``: no TF32) hold in every phase, so
all comparisons are in full f32.
"""

from __future__ import annotations

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
val_dataset {
    dataset_name = SyntheticDataset
    num_src_view = 2
    img_hw = [64, 80]
    val_res_level = 4
    n_scenes = 1
    n_views_total = 6
}
train { val_ray_chunk = 4096 }
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


def time_ms(fn, iters=10, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
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
    pts = torch.rand(3001, 3, device=dev, generator=g) * 2.3 - 1.15
    for ns in (1, 4):
        got = sp.sparse_trilinear_multi(stages[:ns], pts, derivs=True)
        ref = sp.sparse_trilinear_multi_plain(stages[:ns], pts, derivs=True)
        if not torch.equal(got[1], ref[1]):
            fail("K3 ragged: occupancy differs")
        for name, a, b in zip(("feats", "jac", "hmix"), (got[0], got[2], got[3]),
                              (ref[0], ref[2], ref[3])):
            out.append(check_close(f"K3 ragged {name}", a, b, 1e-5,
                                   1e-5 * max(b.abs().max().item(), 1.0)))
    # K4: odd channel counts, misses (-1)
    x = torch.randn(1003, 13, device=dev, generator=g)
    idx = torch.randint(-1, 1003, (2011, 27), device=dev, generator=g).to(torch.int32)
    w = torch.randn(27, 13, 7, device=dev, generator=g)
    out.append(check_close("K4 ragged", reg_net.gather_conv(x, idx, w),
                           reg_net.gather_conv_plain(x, idx, w), 1e-4, 1e-4))
    return max(out)


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

    def rec_hybrid(params, state, grid, feats):
        cur["grid"], cur["i"] = grid, 0
        return hybrid(params, state, grid, feats)

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
# phase 7: tiny model, card against CPU
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
            if "registers" in line or "spill" in line:
                say("build", f"{name}: {line.strip()}")

    t0 = time.time()
    err = ragged_checks(torch.device("cuda"))
    say("ragged", f"K1-K4 match their plain versions, max abs err {err:.3e} "
        f"({time.time() - t0:.1f} s)")

    conf = ConfigFactory.parse_file(conf_path)
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
    missing = [k for k, n in launches.items() if n <= 0]
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
    v.last_scene = k4_calls = None
    torch.cuda.empty_cache()

    t0 = time.time()
    err = reference_check()
    say("reference", f"tiny model on the card matches the CPU plain path, max abs "
        f"err {err:.3e} ({time.time() - t0:.1f} s)")
    say("total", f"{time.time() - t_start:.1f} s")

    print(json.dumps({"kernels": rows}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
