#!/usr/bin/env python3
"""The per-kernel table of the PyTorch/CUDA port on one NVIDIA GPU: each
hand-written kernel at its main-path call sites against its plain version,
with the card's time of the kernel, of the plain version and of one
PyTorch call computing the same function where there is one, and the
kernel's bound.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero, with no result line):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: the fourteen hand-written kernels (surf_tpu_torch/csrc/*.cu: K1-K4,
   the backward kernels K1b-K3b and K4w, the second-order K1g, K1s,
   K2g, K2s, K5, the mesh lattice's SDF MLP, and marching cubes on the
   card) with nvcc for sm_90a, one process per source, in parallel;
3. validate: the port's main path, ``Validator.validate`` on
   confs/surf_synthetic_full.conf (4-stage cascade 88^3 -> 704^3, 512^3
   mesh, 144x200 render) with seeded random weights; every kernel's
   launch count is zeroed just before and read just after, and must be
   > 0 (K5's and marching cubes' too); K2's and K3's calls are also
   counted by call site.  This first call in the process is cold;
4. warm: a second validate, for warm metrics, with every gather_conv call
   of ``apply_hybrid`` recorded; its cascade must equal the first one's
   bit for bit;
5. kernels: K1-K4 against their plain versions at their validate call
   sites (the validate's own stages, volumes, images and recorded K4
   inputs), with the card's time (CUDA events around back-to-back calls
   queued behind a sleep kernel, so the host's time to issue a call is
   not counted: ``time_ms``) of the kernel, the plain version and, where
   one PyTorch call computes the same function, that call, and the
   bound: the bytes the function must read and write (each distinct
   texel, voxel or row once) at the card's memory rate, or its f32
   operations at the card's peak, whichever takes longer.  K1-K4, K1b-K3b
   and K4w take their bytes and operations from ``surfbench.counts``
   (``call_counts``, the benchmark's ``kernel_roofline``) for the same
   call; K5, marching cubes and the second-order kernels count their own
   from the same rates.  K1's entries also say how their points fall on
   the image (``data``).  K2 and K3 must equal their plain versions bit
   for bit (K3's occupancy exactly); K4's and K4w's entries say what their
   table holds (``data``: present pairs, rows with a present tap, rows
   their live-row mask keeps) and, where the path passes a mask, the time
   without it:
   K2 at build_z_vals and depth_render, K3 at the render chunk, the mesh
   lattice's first call (recorded in the warm validate) and, in its
   training variant, the training step's render shape; K5 at the mesh
   lattice's first call, within 1e-5 of its plain version (the MLP the
   lattice ran before it, whose time is the yardstick), with the whole
   lattice function's time before and after (K3 included); marching
   cubes on the card at the warm validate's whole lattice, equal to its
   plain version byte for byte, with each pass's time and the whole
   ``mesh.cubes`` path's beside the host C++'s on the same lattice.  Then
   the grid-form convs (row 7: the four ops indexed through the voxel and
   parent tables, which no path calls) on the warm validate's own 352^3
   and 704^3 grids and recorded inputs: forward, dX and dW by K4/K4w
   against their plain versions, each op's value equal to the
   neighbour-row K4 call on the same input on live rows;
6. variants: the functions the JAX package keeps beside its main path
   and the second order of K1 and K2, at full width on the warm
   validate's tensors, every launch count zeroed first (``variants_phase``):
   ``lookup_volume`` in its three modes on the 704^3 bf16 matching volume
   at ``build_z_vals``' 1,048,576 points; a double backward (the gradient
   in x and in the volume of |df/dx|^2 + <df/dV, R>, f = sum y^2, R
   random) at a training step's 69,632 points on that volume and on a
   random f32 (176, 176, 176, 16) one; ``lookup_sphe_volume`` on the 704^3
   volume and ``lookup_triplane`` on two levels of random f32 (512, 512,
   16) and (256, 256, 16) planes at 1,048,576 points, forward, first and
   second order; ``geocheck_depths`` on the depths the last stage's filter
   reads (3 views of 576x800) and ``depth_consistency_geocheck`` on its
   candidate children; ``compute_consistency_loss`` and its gradients in
   both depths at 480x640; the legacy and MNASNet FPNs at
   confs/surf_synthetic_full.conf's widths (forward on the validate's 3
   views, forward and backward on 5 views of 480x640); the IDR rendering
   net (NeuS's published ``rendering_network`` widths, d_feature 128) at
   a render chunk's 557,056 points; ``sample_pdf`` over 4096 rays x 136
   bins to 64 samples in both modes.  K1, K1b, K2, K2b and the four
   second-order kernels K1g, K1s, K2g, K2s must each have launched; the
   largest call of each (of each second-order kernel on each operand) is
   held against its plain version and timed with its bound and library
   call (none for the new four: F.grid_sample has no double backward on
   the card), K1g / K1s on the largest plane and K2g / K2s on the
   (176, 176, 176, 16) volume once more at as many uniformly random
   points; K1s's entries count its 16-byte atomics (``k1s_rows``), K2s's
   carry the kernel's own counts and, at C other than 1, ``k2s_rows``'; one
   ``[variants]`` line gives the parts' seconds, the phase's and its peak
   memory;
7. train: the port's training path, a ``Trainer`` on the same
   configuration at full width (5 views of 480x640, 512 rays, 4 stages
   to 704^3), through its loop (``Trainer.train``, one epoch cut to 3
   items), 3 steps: one cold, two warm.  Every kernel's launch count
   is zeroed just before the steps and read just after; the backward
   kernels must each have run.  The loss must be finite and the
   parameters of both optimizer groups must move.  Prints s/step and the
   peak memory.  The largest call of each kind of each backward kernel
   in the last step is recorded (K2b's and K3b's of each kind at each
   call site: K2b by volume, 88^3 to 704^3, K3b by the cotangents it
   takes), and K4's largest forward and largest dX call (launches by call
   site: forward / dX at 352^3 / 704^3); K1b, K2b, K3b, K4w and those K4
   calls are then held against their plain versions and measured on
   those calls as in 5.
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
   deletes; ``init_volumes``, then its loop (``Finetuner.finetune``) cut
   to 3 steps (one cold, two warm), with every launch count zeroed
   before them: K3 and K3b must have run, the loss
   must be finite and the implicit surface and every stage's storage
   must move; K3b is held against its plain version at each kind of call
   of the last step and measured as in 7.  The loop's last step ends in a
   ``save_finetune`` and a ``validate_finetune`` (512^3 mesh, non-empty);
   the checkpoint is read back as
   ``--load_vol`` reads it, bit for bit (the bf16 matching volume
   included).  Prints s/step, peak memory,
   ``mesh_s`` and ``render_rays_per_s``;
9. dp: multi-device on the one card (correctness, not scaling; the only
   card run of ``parallel.mesh``'s staging of a collective through the
   host under gloo).  A
   process group of one rank (NCCL): ``parallel.mesh.dp_train_step``
   against a plain ``Trainer.step`` (same item, seed and perturbation):
   loss terms and batch-norm state equal bit for bit, the all-reduce
   returns the gradient bit for bit and Adam on it gives the step's
   parameters bit for bit, the gradient within 1e-3 of the plain step's
   (the training step is not bit-reproducible on the card: the backward
   kernels' and PyTorch's float atomics sum in another order from run to
   run).  Then two gloo ranks share the card
   (``parallel.distribute.spawn``), the full-width model with
   ``train.data_parallel = true``, ``n_rays`` halved so both fit, and 3
   items: a step on items (0, 1) and the padded step on (2, 2) at
   weights [1, 0], the ranks equal bit for bit, the all-reduced
   gradients within 1e-3 of one process's (the mean of the two items',
   item 2's alone), one process's Adam on them equal to the ranks' bit
   for bit; a full-width validate sharded over the two ranks (render
   chunks and mesh lattice) against the one-process validate (1e-4, the
   same mesh).  Each rank's largest call of every
   kernel it launched is held against its plain version, and each kernel
   row gains the ranks' launches (``launches_in_dp_step`` /
   ``_validate``).  Prints the backend, each rank's peak memory, the step
   times (two ranks, one process, NCCL at one rank), the all-reduce's time
   and size, and the sharded validate's ``render_rays_per_s`` and
   ``mesh_s``.

No path calls the grid-form convs: their row's ``launches`` counts the
calls of the four ops during the validate, train and finetune phases
(0).  The last three lines are the kernels JSON, the nvidia-smi line and
the result line ``{"ok": true, "device": {...}}``.  The port's numeric settings
(``surf_tpu_torch.card.set_numerics``: no TF32) hold in every phase, so
all comparisons are in full f32.

Elsewhere: every kernel against its plain version on ragged shapes, the
tiny model's training step and DTU-, BlendedMVS-, Tanks- and
ETH3D-layout validates on the card against the CPU are the ``cuda``-marked
tests (tests/*_cuda.py, tests/test_torch_cuda.py); the validates, the
training step and the finetune step at their published widths, under a
check against a plain reference, are the benchmark's cells
(``python -m surfbench.run --workload <cell>``).
"""

from __future__ import annotations

import contextlib
import gc
import inspect
import json
import os
import statistics
import sys
import time

from surfbench.counts import bound_s, call_counts, distinct_taps, nbytes

HERE = os.path.dirname(os.path.abspath(__file__))


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


def bound(bytes_moved, flops):
    """(ms, "bytes" or "operations"): ``surfbench.counts.bound_s`` in
    milliseconds, and which of the two bounds it."""
    by = "bytes" if bound_s(bytes_moved, 0) >= bound_s(0, flops) else "operations"
    return bound_s(bytes_moved, flops) * 1e3, by



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

def scale(t):
    """max(1, max |t|): the size against which a sum's rounding is stated."""
    return max(t.abs().max().item() if t.numel() else 0.0, 1.0)


# ---------------------------------------------------------------------------
# phase 4: a warm validate, with apply_hybrid's gather_conv calls recorded
# ---------------------------------------------------------------------------

# apply_hybrid's six gather_conv calls, in order: what each computes
K4_CALLS = ("conv0 children -> children", "conv1 children -> parents",
            "conv2 parents -> parents", "conv3 parents -> R/4 cells",
            "conv9 R/4 cells -> parents", "conv11 parents -> children")


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
# phase 5: the kernels at the main path's call sites
# ---------------------------------------------------------------------------

def voxel_corners(shape, co, normalized=True, align=True):
    """The in-range corners of the trilinear taps at ``co`` (N, 3) in a
    volume of ``shape`` (X, Y, Z): for each of the 8 corners, the (x, y, z)
    indices of the points whose corner it is inside."""
    import torch
    from surf_tpu_torch.ops import grid_sample as gs
    base = [torch.floor(gs._unnormalize(co[:, i], shape[i], align) if normalized else co[:, i])
            .long() for i in range(3)]
    out = []
    for k in range(8):
        c = [b + ((k >> (2 - i)) & 1) for i, b in enumerate(base)]
        ok = (c[0] >= 0) & (c[0] < shape[0]) & (c[1] >= 0) & (c[1] < shape[1]) \
            & (c[2] >= 0) & (c[2] < shape[2])
        out.append([x[ok] for x in c])
    return out


def texel_load(image, co, normalized=True, align=True, ct=None):
    """How the points of one K1 / K1b call fall on the image: the largest
    number of points whose bilinear corners hit one texel and, given a
    cotangent ``ct`` (V, N, C), the share of its (view, point) rows that
    are entirely zero (K1b skips their scatter) and the same largest count
    over the rows that are not."""
    import torch
    from surf_tpu_torch.ops import grid_sample as gs
    V, H, W = image.shape[:3]
    x, y = co[..., 0], co[..., 1]
    if normalized:
        x, y = gs._unnormalize(x, W, align), gs._unnormalize(y, H, align)
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


def k1_entry(what, image, co, align, normalized=True):
    """K1 against its plain version and F.grid_sample at one call site
    (pixel coordinates, ``normalized`` False, go to F.grid_sample
    normalized with align_corners=True)."""
    import torch
    import torch.nn.functional as F
    from surf_tpu_torch.ops import grid_sample as gs
    kw = {"normalized": normalized, "align_corners": align}
    got = gs.bilinear_sample(image, co, **kw)
    err = check_close(f"K1 {what}", got, gs.bilinear_sample_plain(image, co, **kw),
                      1e-5, 1e-5)
    nchw = image.permute(0, 3, 1, 2).contiguous()
    co_n, align_n = co, align
    if not normalized:
        H, W = image.shape[1:3]
        co_n = torch.stack([co[..., 0] * (2.0 / (W - 1)) - 1.0,
                            co[..., 1] * (2.0 / (H - 1)) - 1.0], -1)
        align_n = True
    lib_grid = co_n[:, None]

    def lib():
        return F.grid_sample(nchw, lib_grid, mode="bilinear", padding_mode="zeros",
                             align_corners=align_n)
    # (F.grid_sample takes normalized coordinates: converted pixel ones move
    # by up to ~1e-4 pixel at 1600 columns, so there the library is held
    # against the plain version at the converted coordinates.  Its CUDA
    # kernel unnormalizes an align_corners=False coordinate as
    # ((c + 1) * size - 1) / 2 with the multiply-add fused, one rounding
    # where K1, its plain version and the JAX package round twice: at
    # 1920-2400 columns that moves a point by up to ~1.2e-4 pixel, so there
    # the library is held against the plain version at its own pixel
    # coordinates, the fused form computed exactly in f64 and rounded once.)
    data = texel_load(image, co, normalized, align)
    lib_out = lib()[:, :, 0].permute(0, 2, 1)
    if not normalized:
        lib_ref = gs.bilinear_sample_plain(image, co_n, align_corners=True)
    elif not align:
        H, W = image.shape[1:3]
        lib_px = torch.stack([((co[..., a] + 1.0).double() * n - 1.0).float() / 2
                              for a, n in ((0, W), (1, H))], -1)
        lib_ref = gs.bilinear_sample_plain(image, lib_px, normalized=False)
        data["library_err_at_its_coordinates"] = (lib_out - lib_ref).abs().max().item()
        data["library_err_at_k1_coordinates"] = (lib_out - got).abs().max().item()
    else:
        lib_ref = got
    check_close(f"K1 {what} vs F.grid_sample", lib_ref, lib_out, 1e-4, 1e-4)
    del lib_out
    V, N, _ = got.shape
    texels = distinct_taps(image.shape[:3], co_n, align_n)
    b_ms, b_by = bound(*call_counts("K1", (image, co), kw, got))
    return {"shape": f"{what}: image {tuple(image.shape)} f32, {N} points x {V} views, "
                     f"align_corners={align}"
                     + ("" if normalized else ", pixel coordinates")
                     + f", {texels} distinct texels read",
            "data": data,
            "max_abs_err": err,
            "ms": time_ms(lambda: gs.bilinear_sample(image, co, **kw)),
            "plain_ms": time_ms(lambda: gs.bilinear_sample_plain(image, co, **kw), 5),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": time_ms(lib)}


def k2_entry(what, vol, pts, align=False):
    """K2 against its plain version and F.grid_sample 3D (axes flipped)
    at one call site (align_corners=False, as every K2 call of the path,
    unless ``align`` says otherwise).
    ``data``: the distinct 32-byte sectors the gathers touch and, at
    C = 1, K2's time on the f32 copy F.grid_sample reads."""
    import torch
    import torch.nn.functional as F
    from surf_tpu_torch.ops import grid_sample as gs
    got = gs.trilinear_sample(vol, pts, align_corners=align)
    err = check_close(f"K2 {what}", got,
                      gs.trilinear_sample_plain(vol, pts, align_corners=align), 0.0, 0.0)
    vol_f = vol.float().permute(3, 0, 1, 2)[None].contiguous()
    lib_grid = pts.flip(-1)[None, None, None].contiguous()

    def lib():
        return F.grid_sample(vol_f, lib_grid, mode="bilinear", padding_mode="zeros",
                             align_corners=align)
    check_close(f"K2 {what} vs F.grid_sample", got,
                lib().reshape(vol.shape[-1], -1).t(), 1e-4, 1e-4)
    n, C = got.shape
    voxels = distinct_taps(vol.shape[:3], pts, align)
    b_ms, b_by = bound(*call_counts("K2", (vol, pts), {"align_corners": align}, got))
    data = {"distinct_32B_sectors": None, "sectors_ms": None}
    if C == 1:
        # a gather reads whole 32-byte sectors: the distinct ones the taps
        # touch and their time at the memory rate
        X, Y, Z = vol.shape[:3]
        ids = torch.cat([(x * Y + y) * Z + z
                         for x, y, z in voxel_corners(vol.shape[:3], pts, True, align)])
        sectors = torch.unique(ids // (32 // vol.element_size())).numel()
        data = {"distinct_32B_sectors": sectors,
                "sectors_ms": bound_s(sectors * 32, 0) * 1e3}
        # on the f32 copy F.grid_sample reads (at C = 1 the same layout)
        v32 = vol_f.view(vol.shape)
        check_close(f"K2 {what} f32 copy", gs.trilinear_sample(v32, pts, align_corners=align),
                    got, 0.0, 0.0)
        data["ms_f32_volume"] = time_ms(
            lambda: gs.trilinear_sample(v32, pts, align_corners=align))
    return {"shape": f"{what}: volume {tuple(vol.shape)} {str(vol.dtype).split('.')[-1]}, "
                     f"{n} points, {voxels} distinct voxels read",
            "data": data,
            "max_abs_err": err,
            "ms": time_ms(lambda: gs.trilinear_sample(vol, pts, align_corners=align)),
            "plain_ms": time_ms(lambda: gs.trilinear_sample_plain(vol, pts,
                                                                  align_corners=align), 5),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": time_ms(lib)}


# K3's modes: the sums a (point, channel) forms, and the wrapper's flags
K3_MODES = {"value": (1, {}), "derivs": (7, {"derivs": True}), "third": (8, {"third": True})}


def k3_entry(what, stages, pts, mode):
    """K3 against its plain version (equal bit for bit, occupancy equal) at
    one call site, in one of its modes (``K3_MODES``)."""
    import torch
    from surf_tpu_torch.ops import sparse as sp
    _, kw = K3_MODES[mode]
    got = sp.sparse_trilinear_multi(stages, pts, **kw)
    ref = sp.sparse_trilinear_multi_plain(stages, pts, **kw)
    if not torch.equal(got[1], ref[1]):
        fail(f"K3 {what}: occupancy differs at {(got[1] != ref[1]).sum().item()} points")
    err = 0.0
    for name, a, b in zip(("feats", "occ", "jac", "hmix", "third"), got, ref):
        if b is not None and name != "occ":
            err = max(err, check_close(f"K3 {what} {name}", a, b, 0.0, 0.0))
    n, ctot = got[0].shape
    b_ms, b_by = bound(*call_counts("K3", (stages, pts), kw, got))
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


def k5_entry(v, mesh_call):
    """K5 against its plain version at the mesh lattice's first call (the
    points of its first ``blocks_per_call`` occupied blocks, K3's features
    and occupancy there), with the card's time of the kernel, of the plain
    version (the MLP the lattice ran before K5: cuBLAS's SGEMMs and
    PyTorch's glue) and of the whole lattice function before and after
    (K3 included: ``apply_occ`` and the pin, ``LatticeSDF``), and the
    bound: the layers' multiply-adds (the last layer's SDF column only) at
    the f32 peak; its bytes (points, features, occupancy, output) are far
    below."""
    import torch
    from surf_tpu_torch.nn import sdf_net
    from surf_tpu_torch.nn.core import materialize_weight_norm
    from surf_tpu_torch.ops import sparse as sp
    from surf_tpu_torch.validate import LatticeSDF
    stages, pts = mesh_call
    pts = pts.contiguous()
    isf, isf_static = v.params["implicit_surface"], v.static["implicit_surface"]
    p = materialize_weight_norm(isf)["sdf_network"]
    static = isf_static["sdf"]
    with torch.no_grad():
        feats, occ = sp.stage_features(stages, pts)
        layout = sdf_net.lattice_layout(p, static)
        got = sdf_net.sdf_lattice(p, static, pts, feats, occ, layout=layout)
        ref = sdf_net.sdf_lattice_plain(p, static, pts, feats, occ)
        err = check_close("K5 mesh lattice", got, ref, 0.0, 1e-5)
        n = pts.shape[0]
        last = len(p["layers"]) - 1
        macs = sum(lin["w"].shape[0] * (1 if l == last else lin["w"].shape[1])
                   for l, lin in enumerate(p["layers"]))
        b_ms, b_by = bound(nbytes(pts) + nbytes(feats) + nbytes(occ) + nbytes(got),
                           2 * n * macs)
        new_fn = LatticeSDF(isf, isf_static, stages)

        def old_fn():
            out, o = sdf_net.apply_occ(p, static, pts, stages)
            return torch.where(o, out[:, 0], torch.full_like(out[:, 0], 100.0))
        del got, ref
        return {"shape": f"mesh lattice: {n} points, {feats.shape[1]} channels, layers "
                         f"{[tuple(lin['w'].shape) for lin in p['layers']]}, SDF column only, "
                         f"{int(occ.sum())} occupied",
                "max_abs_err": err,
                "ms": time_ms(lambda: sdf_net.sdf_lattice(p, static, pts, feats, occ,
                                                          layout=layout)),
                "plain_ms": time_ms(lambda: sdf_net.sdf_lattice_plain(p, static, pts, feats,
                                                                      occ), 3),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "lattice_fn_ms": time_ms(lambda: new_fn(pts)),
                "composite_lattice_fn_ms": time_ms(old_fn, 3)}


@contextlib.contextmanager
def record_lattices():
    """The card lattices (``BlockLattice``) that ``extract_geometry`` meshes
    inside the block, in order."""
    from surf_tpu_torch.geometry import extract
    from surf_tpu_torch.geometry.marching_cubes import BlockLattice
    orig, kept = extract.marching_cubes, []

    def recorded(grid, iso=0.0):
        if isinstance(grid, BlockLattice):
            kept.append(grid)
        return orig(grid, iso)
    extract.marching_cubes = recorded
    try:
        yield kept
    finally:
        extract.marching_cubes = orig


def mc_entry(what, lat):
    """Marching cubes on the card (csrc/marching_cubes_lattice.cu) at a
    validate's lattice against its plain version, byte for byte, with the
    card's time of the whole path as ``mesh.cubes`` runs it (count pass,
    prefix sum, the totals' read, emit pass, the mesh's copy to the host)
    and of each pass alone, the plain version's time, the host C++'s
    (``cpp_ms``, the path before: the same lattice as an array, host
    clock) and the bound: the occupied blocks' values read once and the
    mesh written once."""
    import importlib
    import torch
    mc = importlib.import_module("surf_tpu_torch.geometry.marching_cubes")
    v, t = mc.marching_cubes(lat, 0.0)
    cells = lat.cells
    vp, tp = (x.cpu().numpy() for x in mc.marching_cubes_plain(lat, 0.0))
    if v.tobytes() != vp.tobytes() or t.tobytes() != tp.tobytes():
        fail(f"marching cubes on the card, {what}: its arrays differ from the plain version's")
    u = -lat.dense().cpu().numpy()
    cpp_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        mc.marching_cubes(u, 0.0)
        cpp_s.append(time.perf_counter() - t0)
    del u
    cnt, masks = mc.lattice_counts(lat)
    incl = torch.cumsum(cnt[:2], dim=1, dtype=torch.int64)
    b_ms, b_by = bound(nbytes(lat.vals) + v.nbytes + t.nbytes, 0)
    return {"shape": f"{what}: {lat.resolution}^3 lattice, {len(lat.vals)} occupied blocks of "
                     f"{lat.block}^3, {len(lat.walked)} walked, {len(v)} vertices, "
                     f"{len(t)} triangles",
            "max_abs_err": 0.0, "cells": cells,
            "ms": time_ms(lambda: mc.marching_cubes(lat, 0.0)),
            "count_ms": time_ms(lambda: mc.lattice_counts(lat)),
            "emit_ms": time_ms(lambda: mc.lattice_emit(lat, 0.0, cnt, masks, incl, len(v),
                                                       len(t))),
            "plain_ms": time_ms(lambda: mc.marching_cubes_plain(lat, 0.0), 3),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "cpp_ms": statistics.median(cpp_s) * 1e3}


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


def k4_entry(grid, i, x, idx, w, live, what=None):
    """K4 against its plain version on one recorded apply_hybrid call (or,
    with ``what``, one of a training step's calls); with a live-row mask
    also timed without it (the full-table pass)."""
    import torch
    from surf_tpu_torch.nn import reg_net
    if what is None:
        what = f"{grid.res}^3 {K4_CALLS[i]}"
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
    b_ms, b_by = bound(*call_counts("K4", (x, idx, w, *lv), {}, got))
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


def main_path_kernels(v, launches, k4_calls, mesh_call, sites, lattice=None):
    """One row per kernel: its headline call site, and ``also_checked``
    entries for its other call sites on the main path; K2's and K3's
    entries carry their call site's launches (``sites``, counted in the
    same validate as ``launches``); marching cubes on the card at the
    warm validate's ``lattice`` (``record_lattices``; none on the CPU)."""
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

    # K5: the mesh lattice's first call, against the MLP it replaced there
    rows.append(row("sdf_lattice_mlp", "surf_tpu_torch/csrc/sdf_lattice_mlp.cu",
                    "none: surf_tpu/nn/sdf_net.py mlp is left to XLA",
                    [k5_entry(v, mesh_call)],
                    "|err| <= 1e-5 (the products' sums in another order than cuBLAS's)",
                    "none: the plain version (sdf_net.mlp: cuBLAS SGEMM and PyTorch's "
                    "glue) is the yardstick"))

    # marching cubes on the card, at the whole lattice, against the host C++
    if lattice is not None:
        rows.append(row("marching_cubes_lattice",
                        "surf_tpu_torch/csrc/marching_cubes_lattice.cu",
                        "none: host marching cubes, surf_tpu/geometry/marching_cubes.py:49",
                        [mc_entry("the warm validate's lattice", lattice)],
                        "exact: the plain version's bytes",
                        "none: the host C++ (csrc/marching_cubes.cpp, cpp_ms) is the "
                        "yardstick"))

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
# phase 5, row 7: the grid-form convs on the validate's own grids
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

        def entry(name, kernel, args, c_out):
            fn, plain = ((rn.gather_conv, rn.gather_conv_plain) if kernel == "K4" else
                         (rn.gather_conv_dw, rn.gather_conv_dw_plain))
            got, ref = fn(*args), plain(*args)
            err = check_close(f"row 7 {what} {name}", got, ref, 1e-4, 1e-4 * scale(ref))
            b_ms, b_by = bound(*call_counts(kernel, args, {}, got))
            inp, tab = args[:2]
            present = tab[tab >= 0]
            return {"shape": f"{what} {name}: {tab.shape[0]} rows x 27 taps "
                             f"({present.numel()} present, {torch.unique(present).numel()} "
                             f"distinct rows read), {inp.shape[1]} -> {c_out} channels, "
                             f"{grid.parents.shape[0]} parents",
                    "data": k4_data(tab, None), "max_abs_err": err,
                    "ms": time_ms(lambda: fn(*args)), "plain_ms": time_ms(lambda: plain(*args), 3),
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}

        fwd.append(entry("forward", "K4", (x, idx, w27), Cout))
        bwd_x.append(entry("dX", "K4", (ct, idx_b, w_b), Cin))
        bwd_w.append(entry("dW", "K4w", (x, idx, ct), Cout))
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


def k4_train_entries(largest, where="training step"):
    """K4 at the largest forward call and largest dX call (on the
    transposed table) that ``record_k4_train_calls`` recorded, those of
    them that were made."""
    out = []
    for kind in ("forward", "dX"):
        if kind not in largest:
            continue
        _, grid, i, x, idx, w, live = largest[kind]
        out.append(k4_entry(grid, i, x, idx, w, live,
                            what=f"{where}, largest {kind}: {grid.res}^3 {K4_CALLS[i]}"
                                 + (" (transposed table)" if kind == "dX" else "")))
    return out


@contextlib.contextmanager
def record_forward_calls():
    """Inside the block, the largest call of K1, K2 and K3 (by output
    elements) with its arguments, for ``largest_call_entries``; K4's are
    ``record_k4_train_calls``'s.  Yields the dict kernel -> (size, args,
    kwargs)."""
    from surf_tpu_torch.ops import grid_sample as gs, sparse as sp
    where = {"bilinear_sample_2d": (gs, "bilinear_sample",
                                    lambda a, k: a[1].shape[0] * a[1].shape[1]
                                    * a[0].shape[-1]),
             "trilinear_sample_3d": (gs, "trilinear_sample",
                                     lambda a, k: a[1].shape[0] * a[0].shape[-1]),
             "sparse_trilinear_multi": (sp, "sparse_trilinear_multi",
                                        lambda a, k: a[1].shape[0] * sum(
                                            st.shape[1] for _, st in a[0]) * K3_MODES[
                                            k3_mode(k)][0])}
    largest, orig = {}, {}

    def wrap(name, fn, size):
        def rec(*a, **k):
            n = size(a, k)
            if n > largest.get(name, (-1,))[0]:
                kept = ([(g, st.detach()) for g, st in a[0]], a[1].detach()) \
                    if name == "sparse_trilinear_multi" else tuple(t.detach() for t in a)
                largest[name] = (n, kept, k)
            return fn(*a, **k)
        return rec

    for name, (mod, attr, size) in where.items():
        orig[name] = getattr(mod, attr)
        setattr(mod, attr, wrap(name, orig[name], size))
    try:
        yield largest
    finally:
        for name, (mod, attr, _) in where.items():
            setattr(mod, attr, orig[name])


def k3_mode(kw):
    """The ``K3_MODES`` entry of a K3 call's flags."""
    return "third" if kw.get("third") else "derivs" if kw.get("derivs") else "value"


def largest_call_entries(where, fwd, k4_largest, records):
    """Each kernel that a part of the ``variants`` or ``dp`` phase launched,
    held against its plain version (and timed, with its bound) at the
    largest call it made there: K1-K3 from ``record_forward_calls``, K4 from
    ``record_k4_train_calls``, the backward kernels from
    ``record_backward_calls`` (K3b's largest of the most cotangents).
    Returns kernel -> [entries]."""
    import torch
    out = {}

    what = f"{where}, largest call"

    def add(name, e):
        e["call_site"] = where
        out.setdefault(name, []).append(e)
        say("kernel", f"{name} in the {where}: " + json.dumps(e))
    for name, (_, a, k) in fwd.items():
        if name == "bilinear_sample_2d":
            add(name, k1_entry(what, a[0], a[1], k.get("align_corners", True),
                               k.get("normalized", True)))
        elif name == "trilinear_sample_3d":
            if not k.get("normalized", True):
                fail(f"{where}: a K2 call with pixel coordinates, which k2_entry "
                     "does not check")
            add(name, k2_entry(what, a[0], a[1], k.get("align_corners", True)))
        else:
            add(name, k3_entry(what, a[0], a[1].contiguous(), k3_mode(k)))
    for e in k4_train_entries(k4_largest, where):
        add("gather_conv", e)
    for name in BWD_KERNELS:
        keyed = [r for key, r in records.items() if key[0] == name]
        if not keyed:
            continue
        n_, a_, k_ = max(keyed, key=lambda r: (r[0], sum(x is not None for x in r[1])))
        if name == "gather_conv_dw":
            a_ = (a_[0], a_[1].to(torch.int32).contiguous()) + tuple(a_[2:])
        e = bwd_entry(name, (n_, a_, k_))
        e["shape"] = f"{what}: " + e["shape"]
        add(name, e)
    return out


def train_phase(conf_path, n_steps=3, dev="cuda"):
    """A Trainer at full width through its loop (``Trainer.train``): one
    epoch of ``n_steps`` of the training scenes, the launch counts zeroed
    before and read after; the last step's backward calls recorded.
    Returns (launches, records and calls as ``record_backward_calls`` gives
    them, metrics, the loop's checkpoint, K4's largest calls).  (``dev``
    "cpu" rehearses the phase without a card.)"""
    import math
    import torch
    from surf_tpu_torch import _build
    from surf_tpu_torch.config import ConfigFactory
    from surf_tpu_torch.train import Trainer
    conf = ConfigFactory.parse_file(conf_path)
    cuda = dev == "cuda"
    t = Trainer(conf, device=dev, seed=0,
                base_exp_dir=os.path.join(HERE, "exp", "chip_smoke_train"))
    # one epoch of the first n_steps items (the schedule's epoch as long)
    t.dataset.metas = t.dataset.metas[:n_steps]
    t.steps_per_epoch, t.epochs, t.val_freq = n_steps, 1, 10 ** 9
    before = {g["name"]: [p.detach().clone() for p in g["params"]]
              for g in t.optimizer.param_groups}
    times, per_step, saved, out = [], [], [], {}
    step, save = t.step, t.save

    def timed_step(batch, step_f):
        i = len(times)
        last_step = i == n_steps - 1
        if last_step:
            out["records"], out["calls"], restore = record_backward_calls()
        t0 = time.time()
        try:
            with count_call_sites() if last_step else contextlib.nullcontext({}) as sites, \
                    record_k4_train_calls() if last_step else \
                    contextlib.nullcontext(({}, {})) as (k4_sites, k4_largest):
                res = step(batch, step_f)
            if cuda:
                torch.cuda.synchronize()
        finally:
            if last_step:
                restore()
        times.append(time.time() - t0)
        now = dict(_build.launches)
        per_step.append({k: now[k] - out["last"][k] for k in now})
        out["last"] = now
        if last_step:
            out.update(sites=sites, k4_sites=k4_sites, k4_largest=k4_largest)
        say("train", f"step {i} ({'cold' if i == 0 else 'warm'}): {times[-1]:.3f} s, "
            f"active_voxels={t.active_voxels.tolist()} "
            + " ".join(f"{k}={v:.5g}" for k, v in res.items()))
        if not all(math.isfinite(v) for v in res.values()):
            fail(f"train: non-finite loss terms at step {i}: {res}")
        return res
    t.step = timed_step
    t.save = lambda epoch: saved.append(save(epoch)) or saved[-1]
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    out["last"] = dict(_build.launches)
    try:
        t.train()
    finally:
        # the wrappers hold the trainer: without them it is freed on return
        del t.step, t.save
    launches = dict(_build.launches)
    if len(times) != n_steps or len(saved) != 1:
        fail(f"train: the loop took {len(times)} steps and saved {len(saved)} times")
    records, calls, sites = out["records"], out["calls"], out["sites"]
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
               "k2_k3_call_sites_last_step": sites,
               "k4_call_sites_last_step": out["k4_sites"],
               "k2b_k3b_call_sites_last_step": bwd_site_launches(calls)}
    say("train", json.dumps(metrics))
    say("train", "kernels " + json.dumps(launches))
    missing = [k for k in FWD_KERNELS + BWD_KERNELS if launches[k] <= 0]
    if missing:
        fail(f"train: the training path launched no {missing}")
    if any(moved[g] == 0 for g in moved):
        fail(f"train: no parameter moved in some group: {moved}")
    return launches, records, calls, metrics, saved[0], out["k4_largest"]


def bwd_shape(name, a, k):
    """What one recorded backward call works on, for its entry's shape."""
    if name == "bilinear_sample_2d_bwd":
        img, _, ct = a[:3]
        V, N, _ = ct.shape
        return (f"image {tuple(img.shape)}, {N} points x {V} views, "
                f"d_image={k.get('need_images', True)}, d_coords={k.get('need_coords', True)}")
    if name == "trilinear_sample_3d_bwd":
        vol, co = a[:2]
        return (f"volume {tuple(vol.shape)} {str(vol.dtype).split('.')[-1]}, {co.shape[0]} "
                f"points, d_volume={k.get('need_volume', True)}, "
                f"d_coords={k.get('need_coords', True)}")
    if name == "sparse_trilinear_multi_bwd":
        stages, pts, cts = a[0], a[1], a[2:]
        return (f"{pts.shape[0]} points, stages {[g.res for g, _ in stages]}, "
                f"{sum(s.shape[1] for _, s in stages)} channels, cotangents of (feats, jac, "
                f"hmix, third) = {[c is not None for c in cts]}")
    x, idx, ct = a[:3]
    return f"{idx.shape[0]} rows x {idx.shape[1]} taps, {x.shape[1]} -> {ct.shape[1]} channels"




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
    BX, BY, BZ = (-(-n // 8) for n in (X, Y, Z))
    corners = voxel_corners(vol.shape[:3], co, k.get("normalized", True),
                            k.get("align_corners", True))
    vox = torch.cat([(x * Y + y) * Z + z for x, y, z in corners])
    bricks = torch.cat([((x // 8) * BY + y // 8) * BZ + z // 8 for x, y, z in corners])
    d = {"distinct_voxels": torch.unique(vox).numel(),
         "distinct_8x8x8_bricks": torch.unique(bricks).numel(),
         "bricks_in_volume": BX * BY * BZ,
         "zero_cotangent_rows": (ct == 0).all(-1).float().mean().item()}
    del corners, vox, bricks
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
    fns = {"bilinear_sample_2d_bwd": ("K1b", gs.bilinear_sample_bwd,
                                      gs.bilinear_sample_bwd_plain),
           "trilinear_sample_3d_bwd": ("K2b", gs.trilinear_sample_bwd,
                                       gs.trilinear_sample_bwd_plain),
           "sparse_trilinear_multi_bwd": ("K3b", sp.sparse_trilinear_multi_bwd,
                                          sp.sparse_trilinear_multi_bwd_plain),
           "gather_conv_dw": ("K4w", reg_net.gather_conv_dw, reg_net.gather_conv_dw_plain)}
    kernel, fn, plain = fns[name]
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
    b_ms, b_by = bound(*call_counts(kernel, a, k, None))
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
    return {"shape": bwd_shape(name, a, k), **data, "max_abs_err": err,
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
    ``ckpt`` (``--resume``), ``init_volumes``, then its loop
    (``Finetuner.finetune``) cut to ``n_steps`` steps: the launch counts
    zeroed before the steps and read after them, the last step's K3b calls
    recorded, the loop's ``save_finetune`` read back as ``--load_vol``
    reads it and its ``validate_finetune`` checked.  Returns (launches,
    metrics, and the records and calls of ``record_backward_calls``).
    Everything is written under a temporary directory that the phase
    deletes.  (``dev`` "cpu" with a tiny ``conf_path`` rehearses the phase
    without a card.)"""
    import math
    import shutil
    import tempfile
    import torch
    from surf_tpu_torch import _build
    from surf_tpu_torch.config import ConfigFactory
    from surf_tpu_torch.finetune import Finetuner
    from surf_tpu_torch.utils import resume_from
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
        before = {g["name"]: [p.detach().clone() for p in g["params"]]
                  for g in f.optimizer.param_groups}
        # the loop cut to n_steps; the phase checks the validate_finetune and
        # save_finetune of its last step
        f.epochs, f.val_before = n_steps, False
        times, out = [], {}
        step, validate_ft, save_ft = f.step, f.validate_finetune, f.save_finetune

        def timed_step(batch, i):
            last = i == n_steps - 1
            if last:
                out["records"], out["calls"], restore = record_backward_calls(
                    ["sparse_trilinear_multi_bwd"])
            t0 = time.time()
            try:
                res = step(batch, i)
                sync()
            finally:
                if last:
                    restore()
            times.append(time.time() - t0)
            if last:
                out["launches"] = dict(_build.launches)
            say("finetune", f"step {i} ({'cold' if i == 0 else 'warm'}): {times[-1]:.3f} s "
                + " ".join(f"{k}={v:.5g}" for k, v in res.items()))
            if not all(math.isfinite(v) for v in res.values()):
                fail(f"finetune: non-finite loss terms at step {i}: {res}")
            return res

        def timed(name, fn):
            def call(i):
                t0 = time.time()
                out[name] = fn(i)
                out[name + "_s"] = time.time() - t0
                return out[name]
            return call
        f.step = timed_step
        f.validate_finetune = timed("validate", validate_ft)
        f.save_finetune = timed("save", save_ft)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        try:
            f.finetune()
        finally:
            # the wrappers hold the finetuner (its volumes): without them it
            # is freed on return, before the later phases need the card
            del f.step, f.validate_finetune, f.save_finetune
        if len(times) != n_steps or "save" not in out or "validate" not in out:
            fail(f"finetune: the loop took {len(times)} steps, saved or validated no "
                 f"checkpoint or mesh")
        launches, records, calls = out["launches"], out["records"], out["calls"]
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

        m = out["validate"]
        metrics.update({"validate_" + k: m[k] for k in
                        ("mesh_s", "render_rays_per_s", "psnr", "mesh_vertices",
                         "mesh_faces")})
        if m["mesh_faces"] <= 0 or m["mesh_vertices"] <= 0 or not m["finite"]:
            fail(f"finetune: validate_finetune gave an empty mesh or non-finite render: {m}")
        say("finetune", f"validate_finetune: {out['validate_s']:.1f} s")

        t0 = time.time()
        path = out["save"]
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
        say("finetune", f"save_finetune ({out['save_s']:.1f} s) + --load_vol: {len(pairs)} "
            f"tensors bit-equal (matching volume "
            f"{str(vs['matching_volume'].dtype).split('.')[-1]}), {size / 2 ** 30:.3f} GiB, "
            f"{time.time() - t0:.1f} s")
        say("finetune", json.dumps(metrics))
        return launches, metrics, records, calls
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 9: multi-device (torch.distributed) on the one card
# ---------------------------------------------------------------------------

DP_RANKS = 2
# the training items of the gloo run: super-batches (0, 1) and (2, 2), the
# second padded with item 2 at weight 0
DP_STEPS = (((0, 1), (1.0, 1.0), 0.0), ((2, 2), (1.0, 0.0), 0.5))
# the gradient tolerance of the tiny training step on the card against its
# plain versions (tests/test_torch_cuda.py): 1e-3 of the leaf's largest
# entry, plus 1e-6
DP_GRAD_RTOL, DP_GRAD_ATOL = 1e-3, 1e-6


def dp_conf(conf_path, halve_rays=False):
    """The configuration with ``train.data_parallel = true``
    (confs/surf_synthetic_full.conf sets it false for the TPU's staged
    trainer, which the port does not have); ``halve_rays``: half its
    ``train_dataset.n_rays`` (traffic, not width), so that two full-width
    ranks' training steps fit on one card together."""
    from surf_tpu_torch.config import ConfigFactory
    conf = ConfigFactory.parse_file(conf_path)
    conf["train"]["data_parallel"] = True
    if halve_rays:
        conf["train_dataset"]["n_rays"] = conf.get_int("train_dataset.n_rays") // 2
    return conf


def dp_trainer(conf, dev, out, resume=None):
    """A Trainer of the gloo run's parity: seed 0, the items ``DP_STEPS``
    takes (the first 3), the render unperturbed."""
    from surf_tpu_torch.train import Trainer
    t = Trainer(conf, device=dev, seed=0, base_exp_dir=out, resume=resume)
    t.dataset.metas = t.dataset.metas[:1 + max(i for s in DP_STEPS for i in s[0])]
    t.static["implicit_surface"] = dict(t.static["implicit_surface"], perturb=0.0)
    return t


def dp_probe(i, dev):
    """The SDF probe points given with item i (the same in every process)."""
    import torch
    g = torch.Generator().manual_seed(1000 + i)
    return (torch.rand((1024, 3), generator=g) * 2.0 - 1.0).to(dev)


def dp_tree_arrays(prefix, tree, grad=False):
    from surf_tpu_torch.nn.core import tree_leaves
    return {f"{prefix}{i}": (t.grad if grad else t).detach().cpu().numpy()
            for i, t in enumerate(tree_leaves(tree))}


def dp_rank(url, conf_path, out, mesh_resolution, dev):
    """One of the gloo run's ranks: joins the group (two ranks on one card
    take gloo), builds ``dp_trainer`` (rank 0's parameters broadcast),
    takes the two data-parallel steps of ``DP_STEPS`` on its item of each
    (perturbation off, ``dp_probe``), then one full-width validate of the
    trained parameters with its render chunks and mesh lattice shared with
    the other rank.  The launches of every kernel in the steps and in the
    validate are counted, and the largest call of each is held against
    its plain version (``largest_call_entries``).  Writes, under ``out``:
    each step's parameters (and on rank 0 its all-reduced gradient and
    loss terms) as ``step<s>_rank<r>.npz``; on rank 0 the checkpoints
    after each step (``train/checkpoints``) and the validate's image and
    lattice; and ``rank<r>.json`` (backend, launches, entries, times,
    peak memory, the validate's metrics)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from surf_tpu_torch import _build
    from surf_tpu_torch.card import set_numerics
    from surf_tpu_torch.parallel.distribute import maybe_initialize, rank_device
    from surf_tpu_torch.parallel.mesh import dp_train_step
    from surf_tpu_torch.validate import Validator, to_device
    set_numerics()
    cuda = dev == "cuda"
    maybe_initialize(device=dev, init_method=url)
    rank, dev = dist.get_rank(), rank_device(dev)

    def sync():
        if cuda:
            torch.cuda.synchronize()
    conf = dp_conf(conf_path, halve_rays=True)
    t = dp_trainer(conf, dev, os.path.join(out, "train"))
    # the group's first collective sets it up: not in the timed steps
    dp_warm_collectives(dev)
    rec = {"rank": rank, "backend": dist.get_backend(), "device": str(dev), "steps": []}
    np.savez(os.path.join(out, f"init_rank{rank}.npz"), **dp_tree_arrays("p", t.params))
    batches = [to_device(t.dataset[items[rank]], dev) for items, _, _ in DP_STEPS]
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    records, _, restore = record_backward_calls()
    try:
        with record_forward_calls() as fwd, record_k4_train_calls() as (_, k4):
            for s, ((items, w, step_f), batch) in enumerate(zip(DP_STEPS, batches)):
                timings = {}
                sync()
                t0 = time.time()
                res = dp_train_step(t, batch, step_f, list(w), perturb=False,
                                    pts_random=dp_probe(items[rank], dev), timings=timings)
                sync()
                rec["steps"].append(dict(timings, step_s=time.time() - t0, terms=res,
                                         items=list(items), weights=list(w)))
                arrays = dp_tree_arrays("p", t.params)
                arrays.update(dp_tree_arrays("s", t.state))
                if rank == 0:
                    arrays.update(dp_tree_arrays("g", t.params, grad=True))
                    t.save(s)
                np.savez(os.path.join(out, f"step{s}_rank{rank}.npz"), **arrays)
    finally:
        restore()
    rec["launches_step"] = dict(_build.launches)
    rec["peak_gb_step"] = [torch.cuda.max_memory_allocated() / 2 ** 30,
                           torch.cuda.max_memory_reserved() / 2 ** 30] if cuda else [0, 0]
    missing = [k for k in FWD_KERNELS + BWD_KERNELS if rec["launches_step"][k] <= 0]
    if missing and cuda:
        fail(f"dp rank {rank}: the data-parallel steps launched no {missing}")
    rec["entries_step"], rec["step_kernel_checks_s"], rec["held_gb_steps"] = dp_in_turn(
        f"dp rank {rank} steps", fwd, k4, records, cuda)

    v = Validator(conf, device=dev, mesh_resolution=mesh_resolution, seed=0,
                  base_exp_dir=os.path.join(out, "val"), params=t.params, state=t.state)
    got = dp_record_image_and_lattice(v)
    _build.reset_launches()
    sync()
    t0 = time.time()
    with record_forward_calls() as fwd, record_k4_train_calls() as (_, k4), torch.no_grad():
        (m,) = v.validate()
    sync()
    rec.update(validate_wall_s=time.time() - t0, launches_validate=dict(_build.launches),
               validate=m, group_size=dist.get_world_size(v.group))
    missing = [k for k in FWD_KERNELS if rec["launches_validate"][k] <= 0]
    if missing and cuda:
        fail(f"dp rank {rank}: the sharded validate launched no {missing}")
    if (got["image"] is None) != (rank != 0):
        fail(f"dp rank {rank}: the image went to the wrong rank")
    if rank == 0:
        np.savez(os.path.join(out, "val_image.npz"), *got["image"])
        np.save(os.path.join(out, "val_lattice.npy"), got["lattice"][2])
    del got, v
    rec["entries_validate"], rec["validate_kernel_checks_s"], rec["held_gb_validate"] = \
        dp_in_turn(f"dp rank {rank} validate", fwd, k4, {}, cuda)
    rec["peak_gb"] = [torch.cuda.max_memory_allocated() / 2 ** 30,
                      torch.cuda.max_memory_reserved() / 2 ** 30] if cuda else [0, 0]
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.barrier()
    dist.destroy_process_group()


def dp_in_turn(where, fwd, k4, records, cuda):
    """``largest_call_entries`` on the recorded calls, one rank at a time
    (the others wait at a barrier holding only their records), each rank
    dropping its records once checked: two ranks' records and a check's
    working memory do not fit on one card together.  Returns (the
    entries, the checks' seconds, the GiB the records held on the card).
    (A CPU rehearsal has no kernel to check.)"""
    import torch
    import torch.distributed as dist
    out, took, held = {}, 0.0, 0.0
    for r in range(dist.get_world_size()):
        if r == dist.get_rank() and cuda:
            held = torch.cuda.memory_allocated() / 2 ** 30
            t0 = time.time()
            out = largest_call_entries(where, fwd, k4, records)
            took = time.time() - t0
        if r == dist.get_rank():
            for d in (fwd, k4, records):
                d.clear()
            if cuda:
                torch.cuda.empty_cache()
        dist.barrier()
    return out, took, held


def dp_warm_collectives(dev):
    """One small all-reduce, which sets up the group's communicators."""
    import torch
    import torch.distributed as dist
    from surf_tpu_torch.parallel.mesh import all_reduce_sum
    all_reduce_sum([torch.zeros(8, device=dev)])
    if dist.get_backend() == "nccl":
        torch.cuda.synchronize()


def dp_record_image_and_lattice(v):
    """Keep what ``v.validate`` renders and extracts (None on a rank other
    than the group's first)."""
    got, render, extract = {}, v.render_full_image, v.extract_geometry

    def keep_image(*a):
        got["image"] = render(*a)
        return got["image"]

    def keep_lattice(*a, **k):
        got["lattice"] = extract(*a, **k)
        return got["lattice"]
    v.render_full_image, v.extract_geometry = keep_image, keep_lattice
    return got


def dp_max_err(a, b):
    import numpy as np
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def dp_world_size_1(conf, dev, out):
    """In a process group of one rank: two Trainers of the same seed, one
    taking a plain ``Trainer.step`` and the other ``dp_train_step`` on the
    same item with perturbation on.  The forward is deterministic, the
    backward's float atomics are not (two plain steps differ), so: the
    loss terms and the new state equal bit for bit; the all-reduce of one
    rank returns the step's own gradient bit for bit; a third Trainer's
    Adam on that gradient gives the DP step's parameters bit for bit; and
    the DP step's gradient lies within the plain step's by
    ``DP_GRAD_RTOL`` / ``DP_GRAD_ATOL``.  Then each of the two takes a
    second step, which is the one timed.  Returns its numbers."""
    import numpy as np
    import torch
    from surf_tpu_torch.nn.core import tree_leaves
    from surf_tpu_torch.parallel import mesh
    from surf_tpu_torch.train import Trainer
    from surf_tpu_torch.validate import to_device

    def sync():
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
    trainers = [Trainer(conf, device=dev, seed=0, base_exp_dir=out) for _ in range(3)]
    plain, dpt, adam = trainers
    batch = to_device(plain.dataset[0], dev)
    sync()
    t0 = time.time()
    r_plain = plain.step(batch, 0.0)
    sync()
    s_plain = time.time() - t0
    local, reduce_ = [], mesh.all_reduce_sum

    def record(tensors, group=None):
        if not local:
            local.extend(t.clone() for t in tensors)
        return reduce_(tensors, group)
    mesh.all_reduce_sum, tm = record, {}
    try:
        sync()
        t0 = time.time()
        r_dp = mesh.dp_train_step(dpt, batch, 0.0, [1.0], timings=tm)
        sync()
        s_dp = time.time() - t0
    finally:
        mesh.all_reduce_sum = reduce_
    if {k: np.float32(v) for k, v in r_plain.items()} != \
            {k: np.float32(v) for k, v in r_dp.items()}:
        fail(f"dp: one rank's loss terms {r_dp} are not the plain step's {r_plain}")
    for i, (a, b) in enumerate(zip(tree_leaves(plain.state), tree_leaves(dpt.state))):
        if not torch.equal(a, b):
            fail(f"dp: one rank's new state leaf {i} differs from the plain step's")
    grads = [p.grad for p in tree_leaves(dpt.params)]
    if any(not torch.equal(a, b) for a, b in zip(local, grads)):
        fail("dp: the all-reduce of one rank changed the gradient")
    for p, g in zip(tree_leaves(adam.params), grads):
        p.grad = g.clone()
    adam.update()
    for i, (a, b) in enumerate(zip(tree_leaves(adam.params), tree_leaves(dpt.params))):
        if not torch.equal(a, b):
            fail(f"dp: Adam on one rank's gradient gives parameter {i} other bits")
    worst = dp_check_grads("one rank against the plain step", [g.cpu().numpy() for g in grads],
                           [p.grad for p in tree_leaves(plain.params)])
    p_err = max((a - b).abs().max().item()
                for a, b in zip(tree_leaves(plain.params), tree_leaves(dpt.params)))
    # the times to compare: a second step of each Trainer (the first steps
    # of fresh Trainers ran in that order, the first one colder)
    sync()
    t0 = time.time()
    plain.step(batch, 0.0)
    sync()
    s_plain_warm, tm_warm = time.time() - t0, {}
    t0 = time.time()
    mesh.dp_train_step(dpt, batch, 0.0, [1.0], timings=tm_warm)
    sync()
    s_dp_warm = time.time() - t0
    nums = {"single_process_step_s": s_plain_warm, "w1_dp_step_s": s_dp_warm,
            "single_process_first_step_s": s_plain, "w1_dp_first_step_s": s_dp,
            "w1_all_reduce_s": tm_warm["all_reduce_s"],
            "w1_grad_mb": tm_warm["grad_bytes"] / 2 ** 20,
            "w1_grad_worst_rel": worst, "w1_params_max_abs_err": p_err}
    say("dp", f"world size 1 (one card): loss terms and state equal bit for bit to the plain step's, "
        f"the all-reduce returns the gradient bit for bit, Adam on it gives the step's "
        f"parameters bit for bit; gradient against the plain step's worst {worst:.3e} of "
        f"its leaf's largest, parameters {p_err:.3e} apart; second steps: plain "
        f"{s_plain_warm:.3f} s, dp {s_dp_warm:.3f} s, all-reduce "
        f"{tm_warm['all_reduce_s'] * 1e3:.3f} ms of {nums['w1_grad_mb']:.2f} MB (first steps, "
        f"plain then dp: {s_plain:.3f} s, {s_dp:.3f} s)")
    return nums


def dp_check_grads(what, got, ref_g):
    """Each leaf of ``got`` (numpy) within ``DP_GRAD_RTOL`` of the largest
    entry of ``ref_g``'s leaf (tensors) plus ``DP_GRAD_ATOL``.  Returns
    the worst error relative to the leaf's largest entry (leaves above
    1e-6)."""
    import numpy as np
    worst, bad = 0.0, []
    for i, (a, b) in enumerate(zip(got, ref_g)):
        b = np.zeros_like(a) if b is None else b.detach().cpu().numpy()
        d, sc = dp_max_err(a, b), float(np.abs(b).max())
        if d > DP_GRAD_RTOL * sc + DP_GRAD_ATOL:
            bad.append((i, tuple(b.shape), d, sc))
        if sc > 1e-6:
            worst = max(worst, d / sc)
    if bad:
        fail(f"dp: {what}: gradient leaves beyond {DP_GRAD_RTOL} x largest + "
             f"{DP_GRAD_ATOL} (leaf, shape, max abs err, largest): {bad[:8]}")
    return worst


def dp_phase(dev="cuda", conf_path=None, mesh_resolution=512):
    """Multi-device on the one card (correctness, not scaling):

    1. NCCL at world size 1 (``dp_world_size_1``): ``dp_train_step`` in a
       process group of one rank against a plain ``Trainer.step`` of the
       same seed, item and perturbation, at full width;
    2. two gloo ranks on the card (``parallel.distribute.spawn``, each
       ``dp_rank``; expandable segments), confs/surf_synthetic_full.conf's
       model at full width with ``train.data_parallel = true``,
       ``n_rays`` halved (two full-width training steps at 512 rays do
       not fit on one card together) and 3 training items: after the step
       on (0, 1) and after the padded step on (2, 2) at weights [1, 0]
       both ranks hold the same parameters and state bit for bit.
       Against one process: the step's all-reduced gradient is the mean
       of the two items' own gradients, and the padded step's the
       gradient of item 2 alone from the first step's checkpoint, within
       ``DP_GRAD_RTOL`` of each leaf's largest entry plus
       ``DP_GRAD_ATOL`` (the backward's float atomics sum in another
       order from run to run); the Trainer's Adam applied to that
       gradient gives the ranks' parameters bit for bit; the padded
       step's loss terms are item 2's (rtol 1e-4, atol 1e-5).  Then a
       full-width validate sharded over the two ranks against the
       one-process validate of the same parameters: colour, normal,
       depths and SDF lattice within 1e-4 (+ 1e-4 relative), the same
       mesh counts and active voxels.  Every kernel launched in each
       rank's steps and validate is counted and its largest call held
       against its plain version, one rank at a time (``dp_in_turn``).

    Returns (launches by part and rank, numbers, entries by part and
    rank).  The times are of ranks sharing one card, not of scaling.
    (``dev`` "cpu" with a tiny ``conf_path`` and ``mesh_resolution``
    rehearses the phase on gloo.)"""
    import shutil
    import tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.multiprocessing.spawn import ProcessException
    from surf_tpu_torch.nn.core import tree_leaves
    from surf_tpu_torch.parallel import distribute
    from surf_tpu_torch.utils import load_checkpoint, to_torch_tree
    from surf_tpu_torch.validate import Validator, to_device
    cuda = dev == "cuda"
    conf_path = conf_path or os.path.join(HERE, "confs", "surf_synthetic_full.conf")

    def sync():
        if cuda:
            torch.cuda.synchronize()
    os.makedirs(os.path.join(HERE, "exp"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_", dir=os.path.join(HERE, "exp"))
    nums = {}
    try:
        # 1. NCCL at world size 1
        conf = dp_conf(conf_path)
        distribute.maybe_initialize(
            environ={"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                     "LOCAL_WORLD_SIZE": "1"}, device=dev,
            init_method=f"file://{os.path.join(tmp, 'w1.rdzv')}")
        try:
            nums["w1_backend"] = dist.get_backend()
            dp_warm_collectives(dev)
            nums.update(dp_world_size_1(conf, dev, os.path.join(tmp, "w1")))
        finally:
            dist.destroy_process_group()
        if cuda:
            torch.cuda.empty_cache()

        # 2. two gloo ranks on the card
        if cuda:
            nums["parent_gb_before_ranks"] = [torch.cuda.memory_allocated() / 2 ** 30,
                                              torch.cuda.memory_reserved() / 2 ** 30]
        alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        t0 = time.time()
        try:
            distribute.spawn(dp_rank, DP_RANKS, (
                f"file://{os.path.join(tmp, 'w2.rdzv')}", conf_path, tmp, mesh_resolution,
                dev), timeout=900)
        except (ProcessException, TimeoutError) as e:
            fail(f"dp: the gloo ranks failed: {e}")
        finally:
            if alloc is None:
                os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
            else:
                os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
        nums["ranks_wall_s"] = time.time() - t0
        recs = []
        for r in range(DP_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                recs.append(json.load(f))
        backends = {rec["backend"] for rec in recs}
        if cuda and backends != {"gloo"}:
            fail(f"dp: two ranks on one card took {backends}, not gloo")
        steps = [[dict(np.load(os.path.join(tmp, f"step{s}_rank{r}.npz")))
                  for r in range(DP_RANKS)] for s in range(len(DP_STEPS))]
        for s, per_rank in enumerate(steps):
            for k, a in per_rank[0].items():
                if k[0] in "ps" and not np.array_equal(a, per_rank[1][k]):
                    fail(f"dp: after step {s} the ranks' {k} differ")
        say("dp", f"two {recs[0]['backend']} ranks sharing {recs[0]['device']} (a "
            "correctness run on one card, not scaling): parameters and "
            f"state equal bit for bit after both steps; "
            + "; ".join(f"rank {rec['rank']}: steps "
                        + ", ".join(f"{st['step_s']:.3f}" for st in rec["steps"])
                        + f" s, all-reduce " + ", ".join(
                            f"{st['all_reduce_s'] * 1e3:.1f}" for st in rec["steps"])
                        + f" ms of {rec['steps'][0]['grad_bytes'] / 2 ** 20:.2f} MB, peak "
                        f"{rec['peak_gb'][0]:.2f} GB allocated / {rec['peak_gb'][1]:.2f} "
                        "reserved" for rec in recs))
        # each rank's second step is warm, as the world-size-1 times are
        nums["w2_dp_step_s"] = max(rec["steps"][1]["step_s"] for rec in recs)
        say("dp", f"warm step times on the one card (correctness runs, not scaling): "
            f"single process {nums['single_process_step_s']:.3f} s and one "
            f"{nums['w1_backend']} rank "
            f"{nums['w1_dp_step_s']:.3f} s at n_rays "
            f"{dp_conf(conf_path).get_int('train_dataset.n_rays')}; two "
            f"{recs[0]['backend']} ranks sharing "
            f"the card {nums['w2_dp_step_s']:.3f} s at n_rays "
            f"{dp_conf(conf_path, halve_rays=True).get_int('train_dataset.n_rays')} a rank")

        # the one-process reference
        conf = dp_conf(conf_path, halve_rays=True)
        items = [i for st in DP_STEPS for i in st[0]]
        ref = dp_trainer(conf, dev, os.path.join(tmp, "ref"))
        init = np.load(os.path.join(tmp, "init_rank0.npz"))
        params = tree_leaves(ref.params)
        for i, p in enumerate(params):
            if not np.array_equal(init[f"p{i}"], p.detach().cpu().numpy()):
                fail(f"dp: the ranks' initial parameter {i} differs from one process's")

        def grads_of(t, item, step_f):
            t.optimizer.zero_grad(set_to_none=True)
            res, _ = t.loss(to_device(t.dataset[item], dev), step_f,
                            t.cos_anneal_ratio(step_f), perturb=False,
                            pts_random=dp_probe(item, dev))
            res["loss"].backward()
            return res, [p.grad.detach().clone() if p.grad is not None
                         else torch.zeros_like(p) for p in tree_leaves(t.params)]

        def adam_on(t, grads, want, what):
            for p, g in zip(tree_leaves(t.params), grads):
                p.grad = torch.as_tensor(g, device=p.device)
            t.update()
            for i, p in enumerate(tree_leaves(t.params)):
                if not np.array_equal(p.detach().cpu().numpy(), want[f"p{i}"]):
                    fail(f"dp: {what}: the Adam update of the ranks' gradient gives "
                         f"parameter {i} other bits than the ranks'")

        step_f0 = DP_STEPS[0][2]
        ga = grads_of(ref, items[0], step_f0)[1]
        gb = grads_of(ref, items[1], step_f0)[1]
        mean = [(a + b) / 2 for a, b in zip(ga, gb)]
        g_dp = [steps[0][0][f"g{i}"] for i in range(len(params))]
        worst = dp_check_grads("the step on (0, 1)", g_dp, mean)
        adam_on(ref, g_dp, steps[0][0], "the step on (0, 1)")
        # the parameters that one process reaches from its own mean gradient
        ref2 = dp_trainer(conf, dev, os.path.join(tmp, "ref2"))
        for p, g in zip(tree_leaves(ref2.params), mean):
            p.grad = g
        ref2.update()
        p_err = max(dp_max_err(p.detach().cpu().numpy(), steps[0][0][f"p{i}"])
                    for i, p in enumerate(tree_leaves(ref2.params)))
        lr = max(g["lr"] for g in ref2.optimizer.param_groups)
        nums.update(step_grad_worst_rel=worst, step_params_max_abs_err=p_err, step_lr=lr)
        say("dp", f"step on (0, 1): all-reduced gradient within {DP_GRAD_RTOL} x each "
            f"leaf's largest + {DP_GRAD_ATOL} of the two items' mean (worst {worst:.3e}); "
            f"Adam of it equal bit for bit to the ranks'; one process's own mean-gradient "
            f"step {p_err:.3e} from the ranks' parameters (learning rate {lr:.3e})")
        del ref, ref2, ga, gb, mean
        if cuda:
            torch.cuda.empty_cache()

        # the padded step against one process's step on item 2 alone
        ck0 = os.path.join(tmp, "train", "checkpoints", "model_000.ckpt.npz")
        pad = dp_trainer(conf, dev, os.path.join(tmp, "pad"), resume=ck0)
        items1, _, step_f1 = DP_STEPS[1]
        res_c, gc = grads_of(pad, items1[0], step_f1)
        g_dp2 = [steps[1][0][f"g{i}"] for i in range(len(params))]
        worst2 = dp_check_grads("the padded step", g_dp2, gc)
        terms = recs[0]["steps"][1]["terms"]
        for k, v in res_c.items():
            v = float(v.detach()) if torch.is_tensor(v) else float(v)
            if abs(terms[k] - v) > 1e-5 + 1e-4 * abs(v):
                fail(f"dp: the padded step's {k} {terms[k]} is not item 2's {v}")
        adam_on(pad, g_dp2, steps[1][0], "the padded step")
        nums["padded_grad_worst_rel"] = worst2
        say("dp", f"padded step on (2, 2) at [1, 0]: gradient within the tolerance of item "
            f"2's alone from the first step's checkpoint (worst {worst2:.3e}), its loss "
            "terms item 2's, its Adam update the ranks' bit for bit")
        del pad, gc, g_dp2, steps
        if cuda:
            torch.cuda.empty_cache()

        # the sharded validate against one process's
        ck1 = load_checkpoint(os.path.join(tmp, "train", "checkpoints", "model_001.ckpt.npz"))
        v = Validator(conf, device=dev, mesh_resolution=mesh_resolution, seed=0,
                      base_exp_dir=os.path.join(tmp, "val1"),
                      params=to_torch_tree(ck1["model"], dev),
                      state=to_torch_tree(ck1["state"], dev))
        got = dp_record_image_and_lattice(v)
        with torch.no_grad():
            (m1,) = v.validate()
        del v
        image = np.load(os.path.join(tmp, "val_image.npz"))
        errs = {}
        for i, name in enumerate(("color", "normal", "sdf_depth", "render_depth")):
            errs[name] = check_close(f"dp sharded validate {name}",
                                     torch.from_numpy(image[f"arr_{i}"]),
                                     torch.from_numpy(got["image"][i]), 1e-4, 1e-4)
        errs["lattice"] = check_close(
            "dp sharded validate lattice",
            torch.from_numpy(np.load(os.path.join(tmp, "val_lattice.npy"))),
            torch.from_numpy(got["lattice"][2]), 1e-4, 1e-4)
        del got, image
        ms = recs[0]["validate"]
        for k in ("mesh_vertices", "mesh_faces", "active_voxels"):
            if ms[k] != m1[k] or any(rec["validate"][k] != ms[k] for rec in recs):
                fail(f"dp: the sharded validate's {k} {ms[k]} is not one process's {m1[k]}")
        nums.update(validate_max_abs_err=errs,
                    sharded_render_rays_per_s=ms["render_rays_per_s"],
                    sharded_mesh_s=ms["mesh_s"], sharded_build_s=ms["build_s"],
                    one_process_render_rays_per_s=m1["render_rays_per_s"],
                    one_process_mesh_s=m1["mesh_s"],
                    mesh=[ms["mesh_vertices"], ms["mesh_faces"]],
                    ranks=[{k: rec[k] for k in ("rank", "backend", "device", "peak_gb_step",
                                                "peak_gb", "validate_wall_s",
                                                "step_kernel_checks_s",
                                                "validate_kernel_checks_s")}
                           | {"steps": [{k: st[k] for k in ("step_s", "all_reduce_s",
                                                            "grad_bytes")}
                                        for st in rec["steps"]]} for rec in recs])
        say("dp", f"sharded validate over {recs[0]['group_size']} ranks sharing one card "
            f"(not scaling): render "
            f"{ms['render_rays_per_s']:.1f} rays/s, mesh_s {ms['mesh_s']:.3f} (one process: "
            f"{m1['render_rays_per_s']:.1f} rays/s, {m1['mesh_s']:.3f} s); against one "
            f"process max abs err " + json.dumps(errs) + f"; mesh ({ms['mesh_vertices']} v, "
            f"{ms['mesh_faces']} f) as one process's")
        launches = {"step": [rec["launches_step"] for rec in recs],
                    "validate": [rec["launches_validate"] for rec in recs]}
        entries = {"step": [rec["entries_step"] for rec in recs],
                   "validate": [rec["entries_validate"] for rec in recs]}
        return launches, nums, entries
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

# ---------------------------------------------------------------------------
# phase 6: the variants beside the main path, and the second order of K1/K2
# ---------------------------------------------------------------------------

SECOND_ORDER = {
    # counter: (wrapper, plain version, K-name, replaces)
    "bilinear_sample_2d_bwd2_gather": ("bilinear_sample_bwd2_gather", "K1g",
                                       "surf_tpu/ops/grid_sample.py:102"),
    "bilinear_sample_2d_bwd2_scatter": ("bilinear_sample_bwd2_scatter", "K1s",
                                        "surf_tpu/ops/grid_sample.py:102"),
    "trilinear_sample_3d_bwd2_gather": ("trilinear_sample_bwd2_gather", "K2g",
                                        "surf_tpu/ops/grid_sample.py:278"),
    "trilinear_sample_3d_bwd2_scatter": ("trilinear_sample_bwd2_scatter", "K2s",
                                         "surf_tpu/ops/grid_sample.py:278"),
}
# (``torch.autograd.grad`` of F.grid_sample's backward taken with
# create_graph raises for CUDA tensors in torch 2.11 with CUDA 12.8)
SECOND_ORDER_LIBRARY = ("none: F.grid_sample's double backward is not implemented on "
                        "the card (derivative for aten::grid_sampler_2d_backward / "
                        "grid_sampler_3d_backward)")
VARIANT_KERNELS = ("bilinear_sample_2d", "bilinear_sample_2d_bwd", "trilinear_sample_3d",
                   "trilinear_sample_3d_bwd", *SECOND_ORDER)


@contextlib.contextmanager
def record_second_order_calls():
    """Inside the block, the largest call (by points x channels) of each
    second-order kernel on each image / volume shape and dtype, with its
    arguments.  Yields the dict (kernel, operand) -> (size, args, kwargs)."""
    from surf_tpu_torch.ops import grid_sample as gs
    largest, orig = {}, {}

    def wrap(name, fn):
        def rec(*a, **k):
            n = a[2].shape[:-1].numel() * a[0].shape[-1]
            key = (name, f"{tuple(a[0].shape)} {str(a[0].dtype).split('.')[-1]}")
            if n > largest.get(key, (-1,))[0]:
                largest[key] = (n, tuple(t.detach() if t is not None else None for t in a), k)
            return fn(*a, **k)
        return rec

    for name, (attr, _, _) in SECOND_ORDER.items():
        orig[name] = getattr(gs, attr)
        setattr(gs, attr, wrap(name, orig[name]))
    try:
        yield largest
    finally:
        for name, (attr, _, _) in SECOND_ORDER.items():
            setattr(gs, attr, orig[name])


def k1s_rows(img, co, h, ct, align):
    """K1s's scatter as its kernel issues it: the (sample, corner) rows it
    adds (a nonzero cotangent row, the corner inside, its directional
    weight nonzero), the rows left after the lanes of each warp (32
    consecutive samples of a view) on one texel are merged into one
    atomic, the most rows on one texel and the 16-byte atomics issued
    (C / 4 a row where C is a multiple of 4)."""
    import torch
    from surf_tpu_torch.ops import grid_sample as gs
    V, H, W, C = img.shape
    N = co.shape[1]
    hx = h[..., 0] * gs._coord_scale(W, True, align)
    hy = h[..., 1] * gs._coord_scale(H, True, align)
    nz = (ct != 0).any(-1)
    keys = []
    for idx, valid, wx, wy, ex, ey in gs._cell_2d(img, co, True, align):
        dw = ((wy * ex) * hx + (wx * ey) * hy) * valid
        on = nz & (valid != 0) & (dw != 0)
        keys.append(torch.where(on, idx.reshape(V, N), -1))
    k = torch.nn.functional.pad(torch.stack(keys), (0, -N % 32), value=-1)
    srt = k.reshape(4, V, -1, 32).sort(-1).values
    merged = int((srt[..., 0] >= 0).sum() + ((srt[..., 1:] != srt[..., :-1])
                                            & (srt[..., 1:] >= 0)).sum())
    _, per_texel = torch.unique(k[k >= 0], return_counts=True)
    return {"corner_rows": int((k >= 0).sum()), "rows_after_warp_merge": merged,
            "max_rows_per_texel": int(per_texel.max()) if per_texel.numel() else 0,
            "vector_atomics": merged * C // 4 if C % 4 == 0 else None}


def k2s_rows(vol, co, h, ct, align, normalized=True):
    """K2s's rows form (C other than 1) as its kernel issues it: the
    (sample, corner) rows it adds (a nonzero cotangent row, the corner
    inside, its directional weight nonzero), the rows left after each
    warp's 32 consecutive samples are merged (the lanes in a row in one
    cell add one row a corner that a lane of the run scatters; a zero
    cotangent row or a cell with no corner inside is a run of its own), and
    the atomics issued: C / 4 16-byte ones a row where C is a multiple of
    4 and the cotangent 16-byte aligned (``vec`` 4), else C scalar ones."""
    import torch
    from surf_tpu_torch.ops import grid_sample as gs
    X, Y, Z, C = vol.shape
    N = co.shape[0]
    _, (hx, hy, hz) = gs._dir_scales((X, Y, Z), h, normalized, align)
    nz = (ct != 0).any(-1)
    on, vox = [], []
    for idx, valid, wx, wy, wz, ex, ey, ez in gs._cell_3d(vol, co, normalized, align):
        dw = gs._tri_dweight(wx, wy, wz, ex, ey, ez, hx, hy, hz, valid)
        on.append(nz & (valid != 0) & (dw != 0))
        vox.append(torch.where(valid != 0, idx, -1))
    on, vox = torch.stack(on), torch.stack(vox)
    warp = torch.arange(N, device=co.device) // 32
    # the cell's low corner (from -1 where a corner is inside)
    lo = [torch.floor(gs._unnormalize(co[:, a], n, align) if normalized else co[:, a])
          .nan_to_num(-1.0).clamp(-1, n).long() + 1 for a, n in enumerate((X, Y, Z))]
    cell = (lo[0] * (Y + 2) + lo[1]) * (Z + 2) + lo[2]
    key = torch.where(nz & (vox >= 0).any(0), cell, -1 - torch.arange(N, device=co.device))
    head = torch.ones(N, dtype=torch.bool, device=co.device)
    head[1:] = (key[1:] != key[:-1]) | (warp[1:] != warp[:-1])
    group = torch.cumsum(head.long(), 0)[None].expand(8, N)
    ks = torch.arange(8, device=co.device)[:, None].expand(8, N)
    merged = torch.unique(group[on] * 8 + ks[on]).numel()
    vec = 4 if C % 4 == 0 and ct.data_ptr() % 16 == 0 else 1
    return {"corner_rows": int(on.sum()), "rows_after_warp_merge": merged, "vec": vec,
            "atomics": merged * C // vec}


def second_order_entry(name, rec):
    """One second-order kernel's recorded call against its plain version
    (the gathers' directional term bit for bit, their Hessian term bit for
    bit at one channel and at 1e-5 otherwise; the scatters at 1e-5, one
    bf16 step for a bf16 volume's gradient), timed with its bound.  No
    PyTorch call computes the same terms on the card: this torch's CUDA
    grid_sample has no double backward (``SECOND_ORDER_LIBRARY``)."""
    import torch
    from surf_tpu_torch.ops import grid_sample as gs
    attr, kname, _ = SECOND_ORDER[name]
    fn, plain = getattr(gs, attr), getattr(gs, attr + "_plain")
    _, a, k = rec
    vol, co, h, ct = a[:4]
    got, ref = fn(*a, **k), plain(*a, **k)
    gather = name.endswith("gather")
    got = got if gather else (got,)
    ref = ref if gather else (ref,)
    C = vol.shape[-1]
    err = 0.0
    for i, (x, y) in enumerate(zip(got, ref)):
        if y is None:
            continue
        if gather and (i == 0 or C == 1):
            err = max(err, check_close(f"{kname} {'directional' if i == 0 else 'Hessian'}",
                                       x, y, 0.0, 0.0))
        else:
            rtol = 2.0 ** -7 if y.dtype == torch.bfloat16 else 1e-5
            err = max(err, check_close(kname, x, y, rtol, 1e-5 * scale(y)))
    del got, ref
    pts = co.shape[:-1].numel()
    corners = 2 ** co.shape[-1]
    d2 = co.dim() == 3
    align = k.get("align_corners", True)
    if not k.get("normalized", True):
        fail(f"variants: a {kname} call with pixel coordinates, which the entry "
             "does not count")
    taps = distinct_taps(vol.shape[:3], co, align)
    moved = nbytes(co) + nbytes(h)
    if gather:
        moved += taps * C * vol.element_size() + \
            (pts * C * 4 if k.get("need_dir", True) else 0)
        if k.get("need_hess", True):
            moved += nbytes(ct) + nbytes(co)
        flops = pts * corners * (4 * C + 16)
    else:
        moved += nbytes(ct) + (vol.numel() * 4 if d2 else nbytes(vol))
        flops = pts * corners * (2 * C + 10)
    b_ms, b_by = bound(moved, flops)
    data = {}
    if d2 and not gather:
        data = {"data": k1s_rows(vol, co, h, ct, align)}
    elif not gather:
        # the kernel's own counts, and the rows form's
        d = {}
        if ct.is_cuda:
            cnt = torch.zeros(2, dtype=torch.int64, device=ct.device)
            fn(*a, **k, counts=cnt)
            d.update(zip(("corner_scatters", "atomics"), cnt.tolist()))
        if C != 1:
            d["rows_form"] = k2s_rows(vol, co, h, ct, align)
        data = {"data": d}
    return {"shape": f"{'image' if d2 else 'volume'} {tuple(vol.shape)} "
                     f"{str(vol.dtype).split('.')[-1]}, {pts} points"
                     + (f" x {vol.shape[0]} views" if d2 else "")
                     + f", align_corners={align}, {taps} distinct "
                     + ("texels" if d2 else "voxels")
                     + (f", directional={k.get('need_dir', True)}, "
                        f"Hessian={k.get('need_hess', True)}" if gather else ""),
            **data, "max_abs_err": err,
            "ms": time_ms(lambda: fn(*a, **k)),
            "plain_ms": time_ms(lambda: plain(*a, **k), 3),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def variants_phase(v, dev="cuda", vol_side=176, plane_res=(512, 256), train_hw=(480, 640)):
    """The variants the JAX package keeps beside its main path, at full
    width on the warm validate's tensors, with every launch count zeroed
    first: ``lookup_volume`` in its three modes on the 704^3 bf16 matching
    volume at ``build_z_vals``' points; the gradient in x and in the volume
    of |df/dx|^2 + <df/dV, R> (f = sum y^2, R random) at a training step's
    69,632 points, on that volume and on a random f32 (176, 176, 176, 16)
    one; ``lookup_sphe_volume`` on the 704^3 volume and ``lookup_triplane``
    on two levels of random (512, 512, 16) and (256, 256, 16) planes at
    ``build_z_vals``' points, forward, first and second order; the
    geometric-consistency filter on the depths and candidates the last
    stage's filter read; the consistency loss, forward and backward, at
    480x640; the legacy and MNASNet FPNs (forward on the validate's 3
    views, forward + backward on 5 random views of 480x640); the IDR
    rendering net at a render chunk's 557,056 points; ``sample_pdf`` in
    both modes.  Each second-order kernel's largest call on each operand is
    held against its plain version and timed, K1g's and K1s's on the
    largest plane and K2g's and K2s's on the (176, 176, 176, 16) volume once
    more at as many uniformly random points; K2s's entries carry the
    kernel's counts and ``k2s_rows``'.  Returns
    (launches, entries: kernel -> [entries], new rows, numbers).  (``dev``
    "cpu" with smaller ``vol_side``, ``plane_res`` and ``train_hw``
    rehearses the phase without a card.)"""
    import torch
    import torch.nn.functional as F
    from surf_tpu_torch import _build
    from surf_tpu_torch.config import ConfigFactory
    from surf_tpu_torch.losses import compute_consistency_loss
    from surf_tpu_torch.nn import (feature_net, feature_net_mnasnet, rendering_net,
                                   volume)
    from surf_tpu_torch.nn.core import tree_leaves
    from surf_tpu_torch.ops import sparse as sp
    from surf_tpu_torch.ops.alt_grids import (equirect2sphere, lookup_sphe_volume,
                                              lookup_triplane)
    from surf_tpu_torch.ops.grid_sample import lookup_volume
    from surf_tpu_torch.ops.sampling import sample_pdf

    scene = v.last_scene
    ipts = scene["ipts"]
    intrs, c2ws = ipts["intrs"], ipts["c2ws"]
    mv = scene["matching"]
    static = v.static["implicit_surface"]
    pts, ro, rd, near, far = render_chunk_points(scene, static, v.val_chunk)
    z_d = near + (far - near) * torch.linspace(0.0, 1.0, static["n_depth"],
                                               device=near.device)[None]
    p2 = (ro[:, None] + rd[:, None] * z_d[..., None]).reshape(-1, 3).contiguous()
    # the depths and candidates the last stage's filter reads
    filt, orig = {}, volume.upsample_filter_geometry

    def rec_filter(prev_grid, depths, intrs_, c2ws_, stage_range, parent_cap):
        filt.update(grid=prev_grid, depths=depths, stage_range=stage_range)
        return orig(prev_grid, depths, intrs_, c2ws_, stage_range, parent_cap)
    volume.upsample_filter_geometry = rec_filter
    try:
        with torch.no_grad():
            v.build(ipts)
    finally:
        volume.upsample_filter_geometry = orig
    g2 = filt["grid"]
    cand = g2.child_coords()
    cand = (cand[:, None, :] * 2 + sp.child_offsets(cand.device)[None]).reshape(-1, 3)
    cand_world = sp.voxel_centers_world(cand, g2.res * 2)
    cand_valid = g2.cvalid.repeat_interleave(8)
    gen = torch.Generator(device=dev).manual_seed(12)
    nums, checks = {}, []

    def ok(what, *ts):
        for t in ts:
            if not torch.isfinite(t.float()).all():
                fail(f"variants: non-finite {what}")
        checks.append(what)

    cuda = dev != "cpu"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def timed(part, fn):
        sync()
        t0 = time.time()
        out = fn()
        sync()
        nums[part + "_s"] = time.time() - t0
        return out

    def second_order(sample, grids, x):
        """Gradient in x and in the grids of |df/dx|^2 + sum <df/dG, R>."""
        x = x.detach().requires_grad_()
        gs_ = [g.detach().requires_grad_() for g in grids]
        y = sample(x, gs_)
        f = (y.float() ** 2).sum()
        d = torch.autograd.grad(f, [x] + gs_, create_graph=True)
        loss = (d[0] ** 2).sum()
        for dg in d[1:]:
            r = torch.randn(dg.shape, device=dev, generator=gen).to(dg.dtype)
            loss = loss + (dg * r).float().sum()
        grads = torch.autograd.grad(loss, [x] + gs_)
        ok("second order", y, *grads)
        return grads

    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t_phase = time.time()
    _build.reset_launches()
    records, _, restore = record_backward_calls(["bilinear_sample_2d_bwd",
                                                 "trilinear_sample_3d_bwd"])
    try:
        with record_forward_calls() as fwd, record_second_order_calls() as second:
            with torch.no_grad():
                for mode in ("bilinear", "nearest", "grad"):
                    out = timed(f"lookup_volume_{mode}", lambda: lookup_volume(p2, mv, mode=mode))
                    if tuple(out.shape) != (p2.shape[0], 1):
                        fail(f"variants: lookup_volume {mode} gave {tuple(out.shape)}")
                    ok(f"lookup_volume {mode}", out)
            n_train = 512 * 136
            x = pts[:n_train]
            vol16 = torch.randn((vol_side,) * 3 + (16,), device=dev, generator=gen)

            def grad_lookup(x_, g):
                return lookup_volume(x_, g[0], mode="grad")
            for what, vol in (("matching", mv), ("random", vol16)):
                timed(f"double_backward_{what}", lambda: second_order(grad_lookup, [vol], x))
            del vol16
            planes = [{k: torch.randn((r, r, 16), device=dev, generator=gen)
                       for k in ("xy", "xz", "yz")} for r in plane_res]
            with torch.no_grad():
                ok("sphere lookup", timed("sphe_forward", lambda: lookup_sphe_volume(
                    equirect2sphere(p2), mv)))
                ok("triplane lookup", timed("triplane_forward", lambda: lookup_triplane(
                    p2, planes)))
            timed("sphe_second_order", lambda: second_order(
                lambda x_, g: lookup_sphe_volume(equirect2sphere(x_), g[0]), [mv], p2))
            flat = [planes[i][k] for i in range(2) for k in ("xy", "xz", "yz")]
            timed("triplane_second_order", lambda: second_order(
                lambda x_, g: lookup_triplane(x_, [dict(zip(("xy", "xz", "yz"), g[:3])),
                                                   dict(zip(("xy", "xz", "yz"), g[3:]))]),
                flat, p2))
            del planes, flat
            depths = filt["depths"]
            masked = timed("geocheck_depths", lambda: volume.geocheck_depths(
                depths, intrs, c2ws))
            counts, keep = timed("depth_consistency_geocheck",
                                 lambda: volume.depth_consistency_geocheck(
                                     cand_world, cand_valid, depths, intrs, c2ws,
                                     filt["stage_range"]))
            ok("geocheck", masked, counts)
            nums.update(geocheck_kept_share=(masked != 0).float().mean().item(),
                        geocheck_candidates=int(cand_world.shape[0]),
                        geocheck_kept_candidates=int(keep.sum()))
            # the consistency loss at the training size: views 0 and 1 of
            # those depths resized, the intrinsics scaled to match
            th, tw = train_hw
            d01 = F.interpolate(depths[:2, None], size=(th, tw), mode="bilinear",
                                align_corners=False)[:, 0]
            sc = torch.tensor([tw / depths.shape[2], th / depths.shape[1], 1.0, 1.0],
                              device=dev)[:, None]
            ref_d, src_d = (d01[i].clone().requires_grad_() for i in range(2))
            mask = torch.ones((th, tw), device=dev)
            loss = timed("consistency_loss", lambda: compute_consistency_loss(
                ref_d, src_d, intrs[:2] * sc, c2ws[:2], 1, mask, mask))
            g_ref, g_src = timed("consistency_backward",
                                 lambda: torch.autograd.grad(loss, (ref_d, src_d)))
            ok("consistency loss", loss, g_ref, g_src)
            nums["consistency_loss"] = loss.item()
            # the FPN variants at confs/surf_synthetic_full.conf's widths
            fc = ConfigFactory.parse_string("fn { d_base = 8, d_out = 4 }\n"
                                            "mn { d_out = [4, 4, 4, 4, 4] }")
            nets = {"legacy": (feature_net.init_legacy(gen, fc["fn"], dev),
                               feature_net.apply_legacy),
                    "mnasnet": (feature_net_mnasnet.init(gen, fc["mn"], dev),
                                feature_net_mnasnet.apply)}
            imgs5 = torch.rand((5, th, tw, 3), device=dev, generator=gen)
            for key, (params, apply) in nets.items():
                with torch.no_grad():
                    outs = timed(f"{key}_fpn_forward", lambda: apply(params, ipts["imgs"]))
                ok(f"{key} FPN", *outs)
                leaves = [t.requires_grad_() for t in tree_leaves(params)]

                def step():
                    outs = apply(params, imgs5)
                    return torch.autograd.grad(sum((o ** 2).mean() for o in outs), leaves)
                ok(f"{key} FPN backward", *timed(f"{key}_fpn_forward_backward", step))
            del nets, imgs5
            rc = ConfigFactory.parse_string(
                "net { d_feature = 128, mode = idr, d_in = 9, d_out = 3, d_hidden = 256, "
                "n_layers = 4, weight_norm = True, multires_view = 4, squeeze_out = True }")
            rp, rs = rendering_net.init(gen, rc["net"], dev)
            n = pts.shape[0]
            nrm = F.normalize(torch.randn((n, 3), device=dev, generator=gen), dim=-1)
            feat = torch.randn((n, 128), device=dev, generator=gen)
            with torch.no_grad():
                rgb = timed("rendering_net", lambda: rendering_net.apply(
                    rp, rs, pts, nrm, rd.repeat_interleave(n // rd.shape[0], 0), feat))
            ok("rendering net", rgb)
            if tuple(rgb.shape) != (n, 3) or rgb.min() < 0 or rgb.max() > 1:
                fail("variants: the rendering net's colours are not (n, 3) in [0, 1]")
            z = torch.sort(near + (far - near) * torch.rand((ro.shape[0], 136), device=dev,
                                                            generator=gen), -1)[0]
            w = torch.rand((ro.shape[0], 136), device=dev, generator=gen)
            for det in (True, False):
                s_ = timed(f"sample_pdf_{'det' if det else 'random'}",
                           lambda: sample_pdf(z, w, 64, det=det, generator=gen))
                ok("sample_pdf", s_)
                if ((s_ < z[:, :1]) | (s_ > z[:, -1:])).any():
                    fail("variants: sample_pdf left the rays' bins")
    finally:
        restore()
    sync()
    launches = dict(_build.launches)
    nums.update(phase_s=time.time() - t_phase, checks=len(checks),
                peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else None)
    missing = [k for k in VARIANT_KERNELS if launches[k] <= 0]
    if missing:
        fail(f"variants: launched no {missing}")
    t0 = time.time()
    entries = largest_call_entries("variants", fwd, {}, records)
    rows = []
    uniform = {}
    for name, (_, _, replaces) in SECOND_ORDER.items():
        recs = sorted(((key[1], r) for key, r in second.items() if key[0] == name),
                      key=lambda kr: -kr[1][0])
        es = []
        for operand, r in recs:
            e = second_order_entry(name, r)
            e["call_site"] = f"variants, {operand}"
            es.append(e)
        # each again at as many uniformly random points (the same for the
        # gather and the scatter), beside the path's ray-ordered ones: K1g /
        # K1s on the largest plane, K2g / K2s on the widest volume
        if recs:
            operand, (n, a, k) = max(recs, key=lambda kr: (kr[1][1][0].shape[-1],
                                                            kr[1][1][0].numel()))
            if operand not in uniform:
                uniform[operand] = torch.rand(
                    a[1].shape, device=a[1].device,
                    generator=torch.Generator(device=dev).manual_seed(13)) * 2.0 - 1.0
            e = second_order_entry(name, (n, (a[0], uniform[operand], *a[2:]), k))
            e["call_site"] = f"variants, {operand}, uniformly random points"
            es.insert(1, e)
        row = {"name": name, "route": "cuda", "source": "surf_tpu_torch/csrc/grid_sample.cu",
               "replaces": replaces, "launches": launches[name], **es[0],
               "tolerance": ("directional term exact, Hessian term exact at C = 1 else "
                             "|err| <= 1e-5 max(max|plain|, 1) + 1e-5 |plain|"
                             if name.endswith("gather") else
                             "|err| <= 1e-5 max(max|plain|, 1) + 1e-5 |plain| (bf16: "
                             "one bf16 step)"),
               "library": SECOND_ORDER_LIBRARY}
        if len(es) > 1:
            row["also_checked"] = es[1:]
        say("kernel", json.dumps(row))
        rows.append(row)
    nums["kernel_checks_s"] = time.time() - t0
    return launches, entries, rows, nums

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
    missing = [k for k in FWD_KERNELS + ("sdf_lattice_mlp", "marching_cubes_lattice")
               if launches[k] <= 0]
    if missing:
        fail(f"the main path launched no {missing}")
    if not m["finite"]:
        fail("non-finite render outputs")
    if m["mesh_faces"] <= 0 or m["mesh_vertices"] <= 0:
        fail("empty mesh")
    if len(m["active_voxels"]) != 4 or min(m["active_voxels"]) <= 0:
        fail(f"cascade active sets {m['active_voxels']}")

    cold = v.last_scene
    with record_lattices() as lattices:
        m, k4_calls, mesh_call = warm_validate(v)
    say("warm", f"build_s={m['build_s']:.3f} mesh_s={m['mesh_s']:.3f} "
        f"render_rays_per_s={m['render_rays_per_s']:.1f} "
        f"active_voxels={m['active_voxels']} gather_conv calls recorded: {len(k4_calls)}")
    if not same_cascade(cold, v.last_scene):
        fail("the warm validate's cascade differs from the first one's bits")
    say("warm", "cascade (parents, active children, storage, matching volume, "
        "features) equal bit for bit to the first validate's")
    del cold

    rows = main_path_kernels(v, launches, k4_calls, mesh_call, sites, lattices[0])
    del mesh_call, lattices
    t0 = time.time()
    grid_rows = grid_form_kernels(k4_calls)
    say("kernel", f"row 7 (grid-form convs): {time.time() - t0:.1f} s")
    # the 704^3 conv0 (x, table, live-row mask) of the validate, for K4w on
    # a dense stage
    dense_conv0 = next((c[2], c[3].to(torch.int32), c[5]) for c in k4_calls
                       if c[0].res == 704 and c[1] == 0)
    k4_calls = None
    torch.cuda.empty_cache()

    var_launches, var_entries, second_rows, var_nums = variants_phase(v)
    var_nums["launches"] = {k: var_launches[k] for k in VARIANT_KERNELS}
    say("variants", json.dumps(var_nums))
    v.last_scene = None
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

    # objects of the earlier phases held in reference cycles keep card
    # memory that the two ranks need
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    dp_launches, dp_nums, dp_entries = dp_phase()
    for r in rows:
        for part in ("step", "validate"):
            r[f"launches_in_dp_{part}"] = [c.get(r["name"], 0) for c in dp_launches[part]]
            for per_rank in dp_entries[part]:
                new = per_rank.get(r["name"], [])
                if new:
                    r.setdefault("also_checked", []).extend(new)
    dp_nums["phase_s"] = time.time() - t0
    say("dp", json.dumps(dp_nums))
    say("total", f"{time.time() - t_start:.1f} s")

    # the variants phase's launches and largest calls, and its kernels' rows
    for r in rows:
        r["launches_in_variants"] = var_launches.get(r["name"], 0)
        if var_entries.get(r["name"]):
            r.setdefault("also_checked", []).extend(var_entries[r["name"]])
    rows += second_rows
    print(json.dumps({"kernels": rows}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
