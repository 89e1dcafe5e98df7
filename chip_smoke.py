#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero, with no result line):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: the fourteen hand-written kernels (surf_tpu_torch/csrc/*.cu: K1-K4,
   the backward kernels K1b-K3b and K4w, the second-order K1g, K1s,
   K2g, K2s, K5, the mesh lattice's SDF MLP, and marching cubes on the
   card) with nvcc for sm_90a, one process per source, in parallel;
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
   > 0 (K5's and marching cubes' too, and K5's ``lattice_fused_points``
   must equal the lattice's points); K2's and K3's calls are also counted
   by call site.
   This first call in the process is cold;
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
   training variant, the training step's render shape; K5 at the mesh
   lattice's first call, within 1e-5 of its plain version (the MLP the
   lattice ran before it, whose time is the yardstick), with the whole
   lattice function's time before and after (K3 included); marching
   cubes on the card at the warm validate's whole lattice, equal to its
   plain version byte for byte, with each pass's time and the whole
   ``mesh.cubes`` path's beside the host C++'s on the same lattice (the
   dtu phase's validate's lattice appended).  Then the
   grid-form convs (row 7: the four ops indexed through the voxel and
   parent tables, which no path calls) on the warm validate's own 352^3
   and 704^3 grids and recorded inputs: forward, dX and dW by K4/K4w
   against their plain versions, each op's value equal to the
   neighbour-row K4 call on the same input on live rows;
6c. variants: the functions the JAX package keeps beside its main path
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
   deletes; ``init_volumes``, then its loop (``Finetuner.finetune``) cut
   to 3 steps (one cold, two warm), each logged, with every launch count
   zeroed before them: K3 and K3b must have run, the loss
   must be finite and the implicit surface and every stage's storage
   must move; K3b is held against its plain version at each kind of call
   of the last step and measured as in 7.  The loop's last step ends in a
   ``save_finetune`` and a ``validate_finetune`` (512^3 mesh, non-empty);
   the checkpoint is read back as
   ``--load_vol`` reads it, bit for bit (the bf16 matching volume
   included).  Prints s/step, peak memory,
   ``mesh_s`` and ``render_rays_per_s``;
9. dtu: the DTU data path at full width, on the procedural scene written
   as a DTU scan (5 views at DTU's native 1200x1600, light 3: cam files,
   pair.txt, PNG images and masks, GT and pseudo depth PFMs, pseudo point
   clouds; the port's own writers) in a temporary directory under exp/
   that the phase deletes.  ``Validator.validate`` with ``clean_mesh`` on
   confs/surf.conf's ``DTUDataset`` (576x800, 144x200 render, 4 stages to
   704^3, 512^3 mesh): every forward kernel launched, a non-empty mesh
   with no more faces after cleaning than before, the PNG artifacts,
   ``val_img`` equal to the rendered colour's 8-bit form.  A ``Trainer``
   (5 views of 480x640, 512 rays) takes 2 steps and saves; a fresh one
   resumes from the checkpoint with the Adam moments, steps, learning
   rates and parameters equal bit for bit, and takes 1 step: every
   backward kernel launched, the loss finite.  A ``Finetuner`` on
   confs/surf_finetune.conf's ``DTUDatasetFinetune`` at 1200x1600 from
   that checkpoint takes 3 steps (K3 and K3b launched).  In each part the
   largest call of every kernel launched there is recorded and held
   against its plain version (an ``also_checked`` entry of the kernel's
   row, with ``call_site`` "dtu ...").  Prints ``read_png``'s time on one
   1200x1600 image and on the same image Adam7-interlaced (its pixels
   held equal to the plain file's), the loaders' seconds per item, ``build_s``,
   ``mesh_s``, ``clean_mesh_s``, s/step and peak memory, and each kernel
   row gains its launches in the three parts
   (``launches_in_dtu_validate`` / ``_train`` / ``_finetune``);
9b. eval: the offline DTU evaluation on the port's own modules, on the
   host (numpy and scipy; no kernel): the ``dtu`` phase's scene written
   again in the ``DTU_TEST`` mask layout (``write_dtu_test_scan``: 3 of its
   ring's cameras as view set 1's 43, 42, 44, RGB masks at 1200x1600) and
   the official cleaning (``evaluation.clean_mesh.main``) of the ``dtu``
   validate's mesh, faces before and after; the same cleaning of the
   scene's sphere plus a cube outside every mask (the cube must go, the
   sphere stay); ``evaluation.dtu_eval.eval_scan`` at DTU scale, a sphere
   of radius 150 mm from marching cubes of its exact SDF on a 512^3
   lattice against 2.5 M STL points on it (``ObsMask`` and ``Plane``
   written with ``scipy.io.savemat``), the seconds and sizes of each step
   and a finite Chamfer under 0.5 mm; and ``chamfer_vs_sphere`` of the
   ``dtu`` mesh.  (The train and finetune phases run their loops, which
   write TensorBoard scalars; each phase reads its event file back with
   this script's own reader, lengths and masked CRC-32Cs checked, and
   holds the tags, steps and values to what its loop logged.)
10. mvs: the JPEG data path at full width, for each of
   confs/surf_bmvs.conf, surf_tanks.conf and surf_eth3d.conf (3 views of
   576x768, 5 of 1080x1920, 7 of 1200x2400; ``val_res_level`` 4; 4
   stages to 704^3; 512^3 mesh): the procedural scene written in the
   dataset's layout with the conf's scan and views (JPEGs at the native
   576x768, 1080x1920 and 4141x6212 by the port's encoder, cam files,
   pair.txt, BlendedMVS's depth PFMs) in a temporary directory under exp/
   that the phase deletes, then ``Validator.validate`` with
   ``clean_mesh`` on: every forward kernel launched, finite outputs, a
   non-empty mesh that cleaning does not grow, the PNG artifacts,
   ``val_img`` equal to the rendered colour's 8-bit form, K1's and K2's
   largest operands inside their 32-bit rules, and the largest call of
   every kernel launched held against its plain version (``call_site``
   "mvs <key> validate"; K1 also on its largest image, the colour
   fetch's fused pyramid).  The BlendedMVS and ETH3D scenes are written
   with progressive JPEGs too (the port's encoder, libjpeg's simple
   progression): each ETH3D and BlendedMVS view's progressive file must
   decode to its baseline file's pixels, and the BlendedMVS validate runs
   again on the progressive scene, its loader items and cascade equal to
   the baseline scene's bit for bit.  Prints ``read_jpeg``'s time on one
   native image of each, baseline and (BlendedMVS, ETH3D) progressive
   (the first read apart, the library's build apart), the
   seconds a loaded item, ``build_s``, ``mesh_s``, ``clean_mesh_s``,
   ``render_rays_per_s``, peak memory, and each kernel row gains its
   launches in each validate (``launches_in_mvs_bmvs`` / ``_tanks`` /
   ``_eth3d``);
11. dp: multi-device on the one card (correctness, not scaling).  A
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
   ``mesh_s``;
11b. protocol: the training demo (``surf_tpu_torch.train_synthetic``) in
   this process at tools/run_protocol_r5.sh's shape (4 stages to 704^3,
   5 views of 480x640, 512 rays, bf16 matching volume), 60 steps under the
   warmup-cosine schedule, a 256^3 evaluation (cascade, SDF lattice,
   marching cubes, cleaning, Chamfer against the analytic sphere) after
   step 30 and at the end, its JSONL log and checkpoint in a directory
   under exp/ that the phase deletes (``protocol_phase``), every launch
   count zeroed first: every loss term finite, the mean loss of steps
   50-59 below that of steps 0-9 and the mean PSNR above it, both meshes
   non-empty with a finite Chamfer, the checkpoint equal bit for bit to
   the run's last parameters and state, ``summarize_run`` on the log,
   every forward and backward kernel launched (each kernel row gains
   ``launches_in_protocol``).  Then, before the directory goes, the
   finetune chain in miniature (``chain_leg``, scripts/torch_finetune_runs.sh's
   stages B and D): the checkpoint resumed into ``main --mode finetune``
   on confs/surf_synthetic_finetune.conf derived by ``derive_conf`` to 100
   steps, its step -1 and last validates at 256^3 scored by
   ``evaluation.synthetic.main``, its own launch counts zeroed first:
   every loss term finite, the mean loss of the last 10 steps below the
   first 10's, both cleaned meshes non-empty with finite Chamfers
   (printed, not held to improve), K3, K3b, K1, K1b and K2 launched (each
   kernel row gains ``launches_in_protocol_finetune``).  Prints the
   per-step losses and PSNRs, the summary, the evaluations, s/step, peak
   memory, the leg's losses and Chamfers and the phase's seconds;
12. reference: the tiny model on the card against the same model on the
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
import gc
import inspect
import json
import os
import shutil
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

def crc32c_bitwise(data):
    """CRC-32C (Castagnoli), bit by bit: the event file's checksum,
    independent of the port's table-driven one."""
    c = 0xFFFFFFFF
    for b in data:
        c ^= b
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
    return c ^ 0xFFFFFFFF


def _masked(data):
    c = crc32c_bitwise(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _proto_fields(buf):
    """(field number, wire type, value) of a protobuf message: varints,
    fixed64 / fixed32 as bytes, length-delimited as bytes."""
    pos, out = 0, []

    def varint():
        nonlocal pos
        n = shift = 0
        while True:
            b = buf[pos]
            pos += 1
            n |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                return n
    while pos < len(buf):
        key = varint()
        num, wire = key >> 3, key & 7
        if wire == 0:
            v = varint()
        elif wire == 1:
            v, pos = buf[pos:pos + 8], pos + 8
        elif wire == 5:
            v, pos = buf[pos:pos + 4], pos + 4
        elif wire == 2:
            n = varint()
            v, pos = buf[pos:pos + n], pos + n
        else:
            raise ValueError(f"wire type {wire}")
        out.append((num, wire, v))
    return out


def read_events(path):
    """The records of a TensorBoard event file: each one's length and data
    checked against their masked CRC-32C; returns (file_version, [(tag,
    step, simple_value)])."""
    import struct
    buf = open(path, "rb").read()
    pos, version, scalars = 0, None, []
    while pos < len(buf):
        head = buf[pos:pos + 8]
        n, = struct.unpack("<Q", head)
        if struct.unpack("<I", buf[pos + 8:pos + 12])[0] != _masked(head):
            raise ValueError(f"{path}: bad length CRC at byte {pos}")
        data = buf[pos + 12:pos + 12 + n]
        if len(data) != n or struct.unpack("<I", buf[pos + 12 + n:pos + 16 + n])[0] \
                != _masked(data):
            raise ValueError(f"{path}: bad data CRC at byte {pos}")
        pos += 16 + n
        ev = {num: v for num, _, v in _proto_fields(data)}
        if 3 in ev:
            version = ev[3].decode()
            continue
        step = ev.get(2, 0)
        step = step - (1 << 64) if step >= 1 << 63 else step
        (value,) = [v for num, _, v in _proto_fields(ev[5]) if num == 1]
        fields = {num: v for num, _, v in _proto_fields(value)}
        scalars.append((fields[1].decode(), step, struct.unpack("<f", fields[2])[0]))
    return version, scalars


def mean_of(rows):
    """The running means the JAX runner's ``DictAverageMeter`` keeps."""
    sums, means = {}, {}
    for count, row in enumerate(rows, 1):
        for k, v in row.items():
            sums[k] = sums.get(k, 0.0) + v
            means[k] = sums[k] / count
    return means


def check_scalars(phase, log_dir, expected):
    """The loop's TensorBoard file in ``log_dir``: one file, a
    ``brain.Event:2`` record first, then ``expected`` (tag, step, value)
    in order, each value as its float32.  Returns its size and count."""
    import glob
    import numpy as np
    files = glob.glob(os.path.join(log_dir, "events.out.tfevents.*"))
    if len(files) != 1:
        fail(f"{phase}: expected one event file in {log_dir}, found {files}")
    try:
        version, got = read_events(files[0])
    except ValueError as e:
        fail(f"{phase}: {e}")
    want = [(tag, step, float(np.float32(v))) for tag, step, v in expected]
    if version != "brain.Event:2" or got != want:
        fail(f"{phase}: the event file holds {version!r}, {got[:6]}..., expected "
             f"{want[:6]}...")
    say(phase, f"scalars: {os.path.basename(files[0])}, {len(got)} records, lengths and "
        f"CRCs checked, tags, steps and values as the loop logged them")
    return {"file_bytes": os.path.getsize(files[0]), "records": len(got),
            "tags": sorted({tag for tag, _, _ in got})}


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
    out.append(k5_ragged_check(dev))
    return max(out)


def k5_ragged_check(dev):
    """K5 against its plain version on a narrow net (hidden 32, a skip, 3
    frequencies, 9 feature channels, random weights) at 1001 points (a
    ragged tile), some outside the box, a third of them empty."""
    import torch
    from surf_tpu_torch.config import ConfigFactory
    from surf_tpu_torch.nn import sdf_net
    from surf_tpu_torch.nn.core import materialize_weight_norm
    conf = ConfigFactory.parse_string(
        "d_out = 5\nd_in = 3\nd_hidden = 32\nn_layers = 4\nskip_in = [2]\nmultires = 3\n"
        "bias = 0.5\nscale = 1.0\ngeometric_init = false\nweight_norm = true\n"
        "feat_channels = 9\nfeat_multires = 0")
    params, static = sdf_net.init(torch.Generator().manual_seed(5), conf)
    p = {"layers": [{k: t.to(dev) for k, t in lin.items()}
                    for lin in materialize_weight_norm(params)["layers"]]}
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    pts = torch.rand(1001, 3, device=dev, generator=g) * 2.4 - 1.2
    feats = torch.randn(1001, 9, device=dev, generator=g)
    occ = torch.rand(1001, device=dev, generator=g) < 0.67
    return check_close("K5 ragged", sdf_net.sdf_lattice(p, static, pts, feats, occ),
                       sdf_net.sdf_lattice_plain(p, static, pts, feats, occ), 0.0, 1e-5)


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
    V, N, C = got.shape
    texels = distinct_taps(image.shape[:3], co_n, align_n)
    b_ms, b_by = bound(nbytes(co) + nbytes(got) + texels * C * 4, V * N * C * 12)
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
    b_ms, b_by = bound(nbytes(pts) + nbytes(got) + voxels * C * vol.element_size(),
                       n * C * 30)
    # a gather reads whole 32-byte sectors: the distinct ones the taps touch
    # (at C = 1) and their time at the memory rate
    sectors = distinct_taps(vol.shape[:3], pts, align, 32 // vol.element_size()) \
        if C == 1 else None
    data = {"distinct_32B_sectors": sectors,
            "sectors_ms": sectors and sectors * 32 / HBM_BYTES_PER_S * 1e3}
    if C == 1:
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


def k4_train_entries(largest, where="training step"):
    """K4 at the largest forward call and largest dX call (on the
    transposed table; its index bytes: the forward's) that
    ``record_k4_train_calls`` recorded, those of them that were made."""
    out = []
    for kind in ("forward", "dX"):
        if kind not in largest:
            continue
        _, grid, i, x, idx, w, live = largest[kind]
        what, ib = K4_CALLS[i]
        out.append(k4_entry(grid, i, x, idx, w, live,
                            what=f"{where}, largest {kind}: {grid.res}^3 {what}"
                                 + (" (transposed table)" if kind == "dX" else ""),
                            index_bytes=ib(grid.parents.shape[0])))
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
    """Each kernel that a part of the dtu phase launched, held against its
    plain version (and timed, with its bound) at the largest call it made
    there: K1-K3 from ``record_forward_calls``, K4 from
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
    before and read after; the last step's backward calls recorded; the
    loop's scalar file read back (``check_scalars``).  Returns (launches,
    records and calls as ``record_backward_calls`` gives them, metrics,
    the loop's checkpoint, K4's largest calls).  (``dev`` "cpu" rehearses
    the phase without a card.)"""
    import math
    import shutil
    import torch
    from surf_tpu_torch import _build
    from surf_tpu_torch.config import ConfigFactory
    from surf_tpu_torch.train import Trainer
    conf = ConfigFactory.parse_file(conf_path)
    cuda = dev == "cuda"
    t = Trainer(conf, device=dev, seed=0,
                base_exp_dir=os.path.join(HERE, "exp", "chip_smoke_train"))
    shutil.rmtree(os.path.join(t.base_exp_dir, "logs"), ignore_errors=True)
    # one epoch of the first n_steps items (the schedule's epoch as long)
    t.dataset.metas = t.dataset.metas[:n_steps]
    t.steps_per_epoch, t.epochs, t.val_freq = n_steps, 1, 10 ** 9
    before = {g["name"]: [p.detach().clone() for p in g["params"]]
              for g in t.optimizer.param_groups}
    times, per_step, results, saved, out = [], [], [], [], {}
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
        results.append(res)
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
    every = max(int(t.log_freq * n_steps), 1)
    expected = [(f"train/{k}", i, v) for i, r in enumerate(results) if i % every == 0
                for k, v in r.items()]
    expected += [(f"train_avg/{k}", 0, v) for k, v in mean_of(results).items()]
    metrics = {"cold_step_s": times[0], "warm_s_per_step": statistics.mean(times[1:]),
               "warm_steps_s": times[1:], "peak_mem_gb": peak / 2 ** 30,
               "launches_per_step": per_step[-1], "params_moved": moved,
               "params_per_group": sizes,
               "backward_calls_last_step": {k: v for k, v in calls.items() if k != "by_site"},
               "k2_k3_call_sites_last_step": sites,
               "k4_call_sites_last_step": out["k4_sites"],
               "k2b_k3b_call_sites_last_step": bwd_site_launches(calls),
               "scalars": check_scalars("train", os.path.join(t.base_exp_dir, "logs"),
                                        expected)}
    say("train", json.dumps(metrics))
    say("train", "kernels " + json.dumps(launches))
    missing = [k for k in FWD_KERNELS + BWD_KERNELS if launches[k] <= 0]
    if missing:
        fail(f"train: the training path launched no {missing}")
    if any(moved[g] == 0 for g in moved):
        fail(f"train: no parameter moved in some group: {moved}")
    return launches, records, calls, metrics, saved[0], out["k4_largest"]


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
    ``ckpt`` (``--resume``), ``init_volumes``, then its loop
    (``Finetuner.finetune``) cut to ``n_steps`` steps and logging each:
    the launch counts zeroed before the steps and read after them, the
    last step's K3b calls recorded, the loop's ``save_finetune`` read back
    as ``--load_vol`` reads it and its ``validate_finetune`` checked, and
    its scalar file read back (``check_scalars``).  Returns (launches,
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
        # the loop cut to n_steps, every step logged; the phase checks the
        # validate_finetune and save_finetune of its last step
        f.epochs, f.log_freq, f.val_before = n_steps, 1, False
        times, results, out = [], [], {}
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
            results.append(res)
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
        metrics["scalars"] = check_scalars(
            "finetune", os.path.join(f.base_exp_dir, "logs"),
            [(f"finetune/{k}", i, v) for i, r in enumerate(results) for k, v in r.items()])
        say("finetune", json.dumps(metrics))
        return launches, metrics, records, calls
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 9: the DTU data path
# ---------------------------------------------------------------------------

DTU_VIEWS = (23, 24, 22, 25, 21)


def dtu_confs(root, conf_path=None, ft_conf_path=None):
    """confs/surf.conf and confs/surf_finetune.conf (or the given files)
    read from the DTU-layout scene at ``root``: its scan, its views as the
    training references, the first as the validation and finetune
    reference, light 3 throughout."""
    from surf_tpu_torch.config import ConfigFactory
    from surf_tpu_torch.data.dtu_scene import LIGHT, SCAN
    conf = ConfigFactory.parse_file(conf_path or os.path.join(HERE, "confs", "surf.conf"))
    for key in ("train_dataset", "val_dataset"):
        d = conf[key]
        d["data_dir"], d["scene"], d["light_idx"] = root, [SCAN], [LIGHT]
    conf["train_dataset"]["ref_view"] = list(DTU_VIEWS)
    conf["val_dataset"]["ref_view"] = [DTU_VIEWS[0]]
    ft = ConfigFactory.parse_file(
        ft_conf_path or os.path.join(HERE, "confs", "surf_finetune.conf"))
    d = ft["finetune_dataset"]
    d["data_dir"], d["scene"], d["ref_view"] = root, SCAN, DTU_VIEWS[0]
    return conf, ft


def dtu_phase(dev="cuda", conf_path=None, ft_conf_path=None, image_hw=(1200, 1600),
              mesh_resolution=512, keep_mesh=None):
    """The DTU data path at full width, on a DTU-layout scene that the
    phase writes (the procedural scene at DTU's native 1200x1600, 5 views,
    with the port's own PNG and PFM writers) into a temporary directory
    under exp/ and deletes:

    1. ``Validator.validate`` on confs/surf.conf's ``val_dataset``
       (576x800, a 144x200 render, 4 stages to 704^3, 512^3 mesh) with
       ``clean_mesh`` on: every forward kernel launched, a non-empty mesh
       before and after cleaning with no more faces after, the PNG
       artifacts written and ``val_img`` equal to the rendered colour's
       8-bit form;
    2. a ``Trainer`` on its ``train_dataset`` (5 views of 480x640, 512
       rays) for 2 steps, saved, then a fresh ``Trainer``
       resumed from that checkpoint (``--mode train --resume``) whose Adam
       moments, steps and learning rates equal the saved ones bit for bit,
       and one more step; every backward kernel launched, the loss finite;
    3. a ``Finetuner`` on confs/surf_finetune.conf's ``DTUDatasetFinetune``
       at 1200x1600 from the resumed trainer's checkpoint, 3 steps, the
       loss finite.

    In each part, the largest call of each kernel it launched (in the
    validate, the resumed training step and the last finetune step) is
    recorded and then held against its plain version at the tolerances of
    the kernel's row, with its times and bound (``largest_call_entries``).
    The training's peak memory includes the recorded calls' tensors.
    Also times ``read_png`` on one of the scene's 1200x1600 RGB images,
    and on the same image written Adam7-interlaced (``write_png(...,
    interlace=True)``), whose pixels must equal the plain file's.
    With ``keep_mesh`` (a path), the validate's mesh is copied there for
    the ``eval`` phase.

    Returns (the launches of each part, the phase's numbers, the
    entries of each part by kernel).  (``dev``
    "cpu" with tiny confs and a small ``image_hw`` rehearses the phase.)"""
    import math
    import shutil
    import tempfile
    import numpy as np
    import torch
    from surf_tpu_torch import _build, validate
    from surf_tpu_torch.data.dtu_scene import LIGHT, SCAN, write_dtu_scene
    from surf_tpu_torch.finetune import Finetuner
    from surf_tpu_torch.io import read_png, write_png
    from surf_tpu_torch.train import Trainer
    cuda = dev == "cuda"
    train_steps, ft_steps = 2, 3

    def sync():
        if cuda:
            torch.cuda.synchronize()
    os.makedirs(os.path.join(HERE, "exp"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dtu_", dir=os.path.join(HERE, "exp"))
    try:
        t0 = time.time()
        root = write_dtu_scene(os.path.join(tmp, "dtu"), view_ids=DTU_VIEWS,
                               image_hw=image_hw)
        nums = {"scene_write_s": time.time() - t0}
        # one 1200x1600 RGB image of the scene (rows filtered as libpng
        # filters them): the first read builds the unfilter library
        png = os.path.join(root, "Rectified_raw", SCAN,
                           f"rect_{DTU_VIEWS[0] + 1:03d}_{LIGHT}_r5000.png")
        png_s = []
        for _ in range(4):
            t0 = time.time()
            read_png(png)
            png_s.append(time.time() - t0)
        nums.update(read_png_cold_s=png_s[0], read_png_s=statistics.median(png_s[1:]))
        # the same view as an Adam7-interlaced PNG: the same pixels
        adam7 = os.path.join(tmp, "adam7.png")
        write_png(adam7, read_png(png), interlace=True)
        png_s = []
        for _ in range(4):
            t0 = time.time()
            pixels = read_png(adam7)
            png_s.append(time.time() - t0)
        if not np.array_equal(pixels, read_png(png)):
            fail("dtu: the Adam7-interlaced PNG reads as other pixels than the plain one")
        nums.update(read_png_interlaced_first_s=png_s[0],
                    read_png_interlaced_s=statistics.median(png_s[1:]))
        del pixels
        conf, ft_conf = dtu_confs(root, conf_path, ft_conf_path)
        launches = {}

        # 1. validate with --clean_mesh
        v = validate.Validator(conf, device=dev, mesh_resolution=mesh_resolution, seed=0,
                               base_exp_dir=os.path.join(tmp, "val"), clean_mesh=True)
        t0 = time.time()
        item = v.dataset[0]
        nums["val_load_s_per_item"] = time.time() - t0
        written, write = {}, validate.write_artifacts

        def recorded(*args):
            written["args"] = args
            return write(*args)
        validate.write_artifacts = recorded
        try:
            sync()
            _build.reset_launches()
            with record_forward_calls() as fwd, record_k4_train_calls() as (_, k4), \
                    record_lattices() as lattices:
                (m,) = v.validate()
            sync()
        finally:
            validate.write_artifacts = write
        launches["validate"] = dict(_build.launches)
        missing = [k for k in FWD_KERNELS if launches["validate"][k] <= 0]
        if missing:
            fail(f"dtu: the DTU validate launched no {missing}")
        if not m["finite"] or not 0 < m["mesh_faces"] <= m["mesh_faces_before_clean"]:
            fail(f"dtu: non-finite render or a mesh that cleaning emptied or grew: {m}")
        d, file_name, epoch, color = written["args"][:4]
        val_png = os.path.join(d, "val_img", f"{file_name}_epoch{epoch}.png")
        if not np.array_equal(read_png(val_png),
                              (color * 256).clip(0, 255).astype(np.uint8)):
            fail("dtu: val_img's PNG differs from the rendered colour's 8-bit form")
        arts = sorted(os.path.relpath(os.path.join(dp, f), d) for dp, _, fs in os.walk(d)
                      for f in fs if not dp.endswith(("meshes", "logs")))
        if len(arts) != 8:
            fail(f"dtu: expected 2 PNGs and 3 depth PNG/.npy pairs, found {arts}")
        nums["val_scalars"] = check_scalars("dtu", os.path.join(d, "logs"), [
            (f"val_img_avg/{tag}", epoch, m[key]) for tag, key in validate.VAL_SCALARS
            if key in m])
        if keep_mesh:
            os.makedirs(os.path.dirname(keep_mesh), exist_ok=True)
            shutil.copyfile(os.path.join(tmp, "val", "meshes", f"{m['scene']}_epoch0.ply"),
                            keep_mesh)
        nums.update({k: m[k] for k in ("build_s", "mesh_s", "clean_mesh_s",
                                       "render_rays_per_s", "mesh_faces_before_clean",
                                       "mesh_faces", "active_voxels", "psnr")})
        nums["val_item_hw"] = list(item["imgs"].shape[1:3])
        say("dtu", f"validate ({file_name}, {len(arts)} artifacts): "
            + " ".join(f"{k}={v}" for k, v in nums.items()))
        del v, item, written
        t0 = time.time()
        entries = {"validate": largest_call_entries("dtu validate", fwd, k4, {})}
        if lattices:
            e = mc_entry("dtu validate", lattices[0])
            e["call_site"] = "dtu validate"
            entries["validate"]["marching_cubes_lattice"] = [e]
            say("kernel", "marching_cubes_lattice in the dtu validate: " + json.dumps(e))
        nums["validate_kernel_checks_s"] = time.time() - t0
        del fwd, k4, lattices
        if cuda:
            torch.cuda.empty_cache()

        # 2. train, save, resume, one more step
        t = Trainer(conf, device=dev, seed=0, base_exp_dir=os.path.join(tmp, "train"))
        t0 = time.time()
        items = [t.dataset[i] for i in range(train_steps + 1)]
        nums["train_load_s_per_item"] = (time.time() - t0) / len(items)
        batches = [validate.to_device(b, dev) for b in items]
        n = len(t.dataset)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        times = []
        for i in range(train_steps):
            sync()
            t0 = time.time()
            res = t.step(batches[i], i / n)
            sync()
            times.append(time.time() - t0)
            if not all(math.isfinite(x) for x in res.values()):
                fail(f"dtu: non-finite training loss terms at step {i}: {res}")
        ckpt = t.save(0)
        t2 = Trainer(conf, device=dev, seed=0, base_exp_dir=os.path.join(tmp, "train"),
                     resume=ckpt)
        same = t2.start_epoch == 1 and t2.scheduler.last_epoch == t.scheduler.last_epoch
        for g1, g2 in zip(t.optimizer.param_groups, t2.optimizer.param_groups):
            same &= g1["lr"] == g2["lr"] and len(g1["params"]) == len(g2["params"])
            for a, b in zip(g1["params"], g2["params"]):
                s1, s2 = t.optimizer.state[a], t2.optimizer.state[b]
                same &= torch.equal(a.detach(), b.detach()) and all(
                    torch.equal(s1[k], s2[k]) for k in ("step", "exp_avg", "exp_avg_sq"))
        if not same:
            fail("dtu: the resumed trainer's parameters, Adam moments, steps or learning "
                 "rates differ from the saved ones")
        del t
        records, _, restore = record_backward_calls()
        try:
            with record_forward_calls() as fwd, record_k4_train_calls() as (_, k4):
                sync()
                t0 = time.time()
                res = t2.step(batches[train_steps], train_steps / n)
                sync()
                times.append(time.time() - t0)
        finally:
            restore()
        if not all(math.isfinite(x) for x in res.values()):
            fail(f"dtu: non-finite loss terms after the resume: {res}")
        launches["train"] = dict(_build.launches)
        missing = [k for k in BWD_KERNELS if launches["train"][k] <= 0]
        if missing:
            fail(f"dtu: the DTU training steps launched no {missing}")
        nums.update({"train_s_per_step": times, "train_resumed_step_s": times[-1],
                     "train_peak_mem_gb": (torch.cuda.max_memory_allocated() / 2 ** 30
                                           if cuda else 0.0),
                     "train_loss_after_resume": res["loss"]})
        ckpt = t2.save(1)
        t0 = time.time()
        entries["train"] = largest_call_entries("dtu train, resumed step", fwd, k4, records)
        nums["train_kernel_checks_s"] = time.time() - t0
        del fwd, k4, records
        say("dtu", f"train: {train_steps} steps, save, resume (moments, steps and "
            f"learning rates bit-equal), 1 step: s/step {times}, peak "
            f"{nums['train_peak_mem_gb']:.2f} GB, load {nums['train_load_s_per_item']:.3f} "
            "s/item")
        del t2, batches, items
        if cuda:
            torch.cuda.empty_cache()

        # 3. finetune on DTUDatasetFinetune from that checkpoint
        sync()
        t0 = time.time()
        f = Finetuner(ft_conf, device=dev, seed=0, base_exp_dir=os.path.join(tmp, "ft"),
                      resume=ckpt, mesh_resolution=mesh_resolution)
        sync()
        nums["finetune_init_s"] = time.time() - t0
        ds = f.dataset
        perm = f.host_rng.permutation(ds.num_views)
        _build.reset_launches()
        times = []
        for i in range(ft_steps):
            batch = validate.to_device(ds.get_random_rays(int(perm[i % len(perm)]),
                                                          rng=f.host_rng), dev)
            last = i == ft_steps - 1
            records, _, restore = record_backward_calls() if last else ({}, None, None)
            try:
                with record_forward_calls() if last else contextlib.nullcontext({}) as fwd, \
                        record_k4_train_calls() if last else \
                        contextlib.nullcontext(({}, {})) as (_, k4):
                    sync()
                    t0 = time.time()
                    res = f.step(batch, i)
                    sync()
                    times.append(time.time() - t0)
            finally:
                if last:
                    restore()
            if not all(math.isfinite(x) for x in res.values()):
                fail(f"dtu: non-finite finetune loss terms at step {i}: {res}")
        launches["finetune"] = dict(_build.launches)
        missing = [k for k in ("sparse_trilinear_multi", "sparse_trilinear_multi_bwd")
                   if launches["finetune"][k] <= 0]
        if missing:
            fail(f"dtu: the DTU finetune steps launched no {missing}")
        nums.update({"finetune_s_per_step": times,
                     "finetune_img_hw": list(ds.images.shape[1:3])})
        say("dtu", f"finetune on DTUDatasetFinetune {nums['finetune_img_hw']}: init "
            f"{nums['finetune_init_s']:.3f} s, s/step {times}")
        t0 = time.time()
        entries["finetune"] = largest_call_entries("dtu finetune, last step", fwd, k4,
                                                   records)
        nums["finetune_kernel_checks_s"] = time.time() - t0
        del f, fwd, k4, records
        return launches, nums, entries
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 9b: the offline DTU evaluation, on the card machine's host
# ---------------------------------------------------------------------------

EVAL_SCAN = 24


def sphere_mesh(radius, res, half):
    """Marching cubes (the port's) of the exact SDF of the sphere of
    ``radius`` at the origin, on a ``res``^3 lattice over [-half, half]^3:
    (vertices in the sphere's units, triangles)."""
    import numpy as np
    from surf_tpu_torch.geometry import marching_cubes
    ax = np.linspace(-half, half, res, dtype=np.float32)
    sq = ax * ax
    grid = np.sqrt(sq[:, None, None] + sq[None, :, None] + sq[None, None, :]) - radius
    verts, tris = marching_cubes(grid)
    return verts * np.float32(2 * half / (res - 1)) - np.float32(half), tris


def cube_mesh(size, center):
    import numpy as np
    s = size / 2
    v = np.array([[x, y, z] for x in (-s, s) for y in (-s, s) for z in (-s, s)],
                 np.float32) + np.asarray(center, np.float32)
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
                  [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]])
    return v, f


def timed_dtu_eval(dtu_eval):
    """Wrap ``dtu_eval``'s sampling, downsampling and KD-trees so that
    ``eval_scan`` reports the seconds and sizes of each step; returns (the
    numbers, a function that restores the module)."""
    nums = {"kd_builds": [], "kd_queries": []}
    orig = {k: getattr(dtu_eval, k) for k in ("sample_mesh_points", "radius_downsample",
                                              "cKDTree")}

    def timed(name, fn):
        def call(*args, **kwargs):
            t0 = time.time()
            out = fn(*args, **kwargs)
            nums[name + "_s"], nums[name + "_points"] = time.time() - t0, len(out)
            return out
        return call

    class Tree(orig["cKDTree"]):
        def query(self, x, *args, **kwargs):
            t0 = time.time()
            out = super().query(x, *args, **kwargs)
            nums["kd_queries"].append({"tree_points": int(self.n), "query_points": len(x),
                                       "s": time.time() - t0})
            return out

    def tree(data, **kwargs):
        t0 = time.time()
        out = Tree(data, **kwargs)
        nums["kd_builds"].append({"points": len(data), "s": time.time() - t0})
        return out
    dtu_eval.sample_mesh_points = timed("sample", orig["sample_mesh_points"])
    dtu_eval.radius_downsample = timed("radius_downsample", orig["radius_downsample"])
    dtu_eval.cKDTree = tree

    def restore():
        for k, v in orig.items():
            setattr(dtu_eval, k, v)
    return nums, restore


def eval_phase(dtu_mesh, mask_hw=(1200, 1600), radius_mm=150.0, lattice=512,
               n_stl=2_500_000, outlier_res=192):
    """The offline evaluation on the port's own modules, on the host, in a
    temporary directory under exp/ that the phase deletes:

    1. a ``DTU_TEST``-layout scan (``write_dtu_test_scan``: the ``dtu``
       phase's ring of 5 cameras, 3 labelled as view set 1's 43, 42, 44,
       masks at ``mask_hw``) and the official cleaning
       (``evaluation.clean_mesh.main``) of the ``dtu`` phase's validate
       mesh ``dtu_mesh``: no more faces after than before;
    2. the same cleaning of the scene's sphere (marching cubes of its exact
       SDF) plus a cube that every view sees outside its mask: the cube
       gone, at least 500 faces of the sphere kept;
    3. ``evaluation.dtu_eval.eval_scan`` at DTU scale: the sphere of
       radius ``radius_mm`` (mm) from marching cubes of its exact SDF on a
       ``lattice``^3 lattice, against an STL cloud of ``n_stl`` points on it
       (``ObsMask`` a shell around it, a ground plane cutting its bottom):
       each step's seconds and sizes, and the Chamfer finite and under
       0.5 mm;
    4. ``evaluation.synthetic.chamfer_vs_sphere`` of ``dtu_mesh`` against
       the scene's sphere (untrained weights: finite, no bound).

    Returns the phase's numbers.  (Small arguments rehearse it on any
    host.)"""
    import math
    import shutil
    import tempfile
    import numpy as np
    from scipy.io import savemat
    from surf_tpu_torch.data.dtu_scene import write_dtu_test_scan
    from surf_tpu_torch.evaluation import clean_mesh as ev_clean, dtu_eval, synthetic
    from surf_tpu_torch.geometry import Mesh
    from surf_tpu_torch.io import write_ply
    os.makedirs(os.path.join(HERE, "exp"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_eval_", dir=os.path.join(HERE, "exp"))
    nums = {}
    try:
        t0 = time.time()
        views = ev_clean.VIEW_LIST_SET1[:3]
        root = write_dtu_test_scan(os.path.join(tmp, "DTU_TEST"), scan=EVAL_SCAN,
                                   view_ids=views, n_ring=len(DTU_VIEWS), mask_hw=mask_hw)
        nums["dtu_test_write_s"] = time.time() - t0

        def official(name, mesh):
            out = os.path.join(tmp, name, "meshes")
            os.makedirs(out)
            mesh.export(os.path.join(out, f"scan{EVAL_SCAN}_epoch0.ply"))
            t0 = time.time()
            ev_clean.main(["--root_dir", root, "--out_dir", out])
            return Mesh.load(os.path.join(out, "final", f"scan{EVAL_SCAN}.ply")), \
                time.time() - t0

        # 1. the dtu phase's validate mesh
        before = Mesh.load(dtu_mesh)
        after, secs = official("dtu", before.copy())
        nums.update(dtu_mesh_faces=len(before.faces), dtu_mesh_faces_official=len(after.faces),
                    official_clean_dtu_s=secs)
        say("eval", f"official cleaning of the dtu validate mesh ({mask_hw[0]}x{mask_hw[1]} "
            f"masks, views {views}): {len(before.faces)} -> {len(after.faces)} faces, "
            f"{secs:.2f} s")
        if len(after.faces) > len(before.faces):
            fail("eval: the official cleaning grew the dtu validate mesh")

        # 2. the sphere and an out-of-mask cube
        sv, sf = sphere_mesh(1.0, outlier_res, 1.25)
        cv, cf = cube_mesh(0.2, (0.0, 0.0, -1.6))
        both = Mesh(np.concatenate([sv, cv]), np.concatenate([sf, cf + len(sv)]))
        kept, secs = official("outlier", both)
        r = np.linalg.norm(kept.vertices, axis=1)
        nums.update(outlier_faces=len(both.faces), outlier_faces_official=len(kept.faces),
                    official_clean_outlier_s=secs,
                    outlier_kept_radius_err=float(np.abs(r - 1.0).max()) if len(r) else None)
        say("eval", f"sphere ({len(sf)} faces) + cube: {len(kept.faces)} faces kept, "
            f"max | |v| - 1 | {nums['outlier_kept_radius_err']}, {secs:.2f} s")
        if len(kept.faces) < 500 or np.abs(r - 1.0).max() > 0.02:
            fail("eval: the official cleaning kept the cube or dropped the sphere")

        # 3. eval_scan at DTU scale
        out, data = os.path.join(tmp, "scale"), os.path.join(tmp, "evaluation")
        for d in (os.path.join(out, "meshes", "final"), os.path.join(data, "ObsMask"),
                  os.path.join(data, "Points", "stl")):
            os.makedirs(d)
        t0 = time.time()
        v, f = sphere_mesh(radius_mm, lattice, radius_mm * 16 / 15)
        nums.update(scale_mesh_s=time.time() - t0, scale_mesh_faces=len(f))
        write_ply(os.path.join(out, "meshes", "final", f"scan{EVAL_SCAN}.ply"), v,
                  f.astype(np.int32))
        rng = np.random.default_rng(0)
        stl = rng.normal(size=(n_stl, 3))
        stl *= radius_mm / np.linalg.norm(stl, axis=1, keepdims=True)
        write_ply(os.path.join(data, "Points", "stl", f"stl{EVAL_SCAN:03}_total.ply"),
                  stl.astype(np.float32))
        res_mm, lo = 2.0, -(radius_mm + 20.0)
        n = int(round(-2 * lo / res_mm)) + 1
        c = lo + res_mm * np.arange(n)
        dist = np.sqrt(c[:, None, None] ** 2 + c[None, :, None] ** 2 + c[None, None, :] ** 2)
        obs = (np.abs(dist - radius_mm) < 10.0).astype(np.uint8)
        savemat(os.path.join(data, "ObsMask", f"ObsMask{EVAL_SCAN}_10.mat"),
                {"ObsMask": obs, "BB": np.array([[lo] * 3, [-lo] * 3]),
                 "Res": np.array([[res_mm]])})
        # the ground plane: z > -(radius - 10 mm), the sphere's bottom cap cut
        savemat(os.path.join(data, "ObsMask", f"Plane{EVAL_SCAN}.mat"),
                {"P": np.array([[0.0], [0.0], [1.0], [radius_mm - 10.0]])})
        timings, restore = timed_dtu_eval(dtu_eval)
        t0 = time.time()
        try:
            d2s, s2d, overall = dtu_eval.eval_scan(EVAL_SCAN, out, data)
        finally:
            restore()
        nums.update(eval_scan_s=time.time() - t0, stl_points=n_stl,
                    chamfer_d2s_mm=d2s, chamfer_s2d_mm=s2d, chamfer_mm=overall, **timings)
        say("eval", f"eval_scan at r = {radius_mm} mm ({lattice}^3 lattice, "
            f"{len(f)} faces): sampled {timings['sample_points']} points in "
            f"{timings['sample_s']:.2f} s, radius_downsample kept "
            f"{timings['radius_downsample_points']} in {timings['radius_downsample_s']:.2f} s, "
            f"KD queries {timings['kd_queries']}, chamfer d2s {d2s} s2d {s2d} overall "
            f"{overall} mm, {nums['eval_scan_s']:.2f} s")
        if not all(math.isfinite(x) and x < 0.5 for x in (d2s, s2d, overall)):
            fail(f"eval: the DTU-scale Chamfer {d2s}, {s2d}, {overall} mm is not finite "
                 "and under 0.5 mm")

        # 4. the synthetic score of the dtu validate mesh
        nums["dtu_mesh_chamfer_vs_sphere"] = synthetic.chamfer_vs_sphere(
            before.vertices.astype(np.float32), np.eye(4), 1.0)
        say("eval", f"chamfer_vs_sphere of the dtu validate mesh (untrained): "
            f"{nums['dtu_mesh_chamfer_vs_sphere']}")
        if not all(math.isfinite(x) for x in nums["dtu_mesh_chamfer_vs_sphere"]):
            fail("eval: non-finite chamfer_vs_sphere")
        return nums
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 10: the BlendedMVS, Tanks and ETH3D validates (JPEG data path)
# ---------------------------------------------------------------------------

# key -> the conf that names the dataset, its scan and its views
MVS_CONFS = {"bmvs": "surf_bmvs.conf", "tanks": "surf_tanks.conf", "eth3d": "surf_eth3d.conf"}
# the scenes also written with progressive JPEGs: ETH3D's native images (the
# largest) decoded both ways, BlendedMVS's (the cheapest validate) validated
# a second time
MVS_PROGRESSIVE = ("bmvs", "eth3d")
MVS_PROGRESSIVE_VALIDATE = "bmvs"
INT32_LIMIT = 2 ** 31 - 1


@contextlib.contextmanager
def record_size_limits():
    """Inside the block, the largest operands K1 and K2 were handed, against
    their 32-bit rules (``ops/grid_sample.py``: ``_k1_layout``,
    ``_k2_size_rule``): K1's image elements and points a view, K2's volume
    elements and points.  Yields the dict of maxima; under "k1_largest_image"
    the (images, coords, kwargs) of K1's call on the largest image."""
    from surf_tpu_torch.ops import grid_sample as gs
    most = {"k1_image_elements": 0, "k1_points_per_view": 0, "k1_views": 0,
            "k2_volume_elements": 0, "k2_points": 0}
    orig = {"bilinear_sample": gs.bilinear_sample, "trilinear_sample": gs.trilinear_sample}

    def k1(images, coords, **kw):
        if images.numel() > most["k1_image_elements"]:
            most["k1_largest_image"] = (images.detach(), coords.detach(), kw)
        for k, n in (("k1_image_elements", images.numel()),
                     ("k1_points_per_view", coords.shape[1]), ("k1_views", images.shape[0])):
            most[k] = max(most[k], int(n))
        return orig["bilinear_sample"](images, coords, **kw)

    def k2(volume, coords, **kw):
        most["k2_volume_elements"] = max(most["k2_volume_elements"], int(volume.numel()))
        most["k2_points"] = max(most["k2_points"], int(coords.shape[0]))
        return orig["trilinear_sample"](volume, coords, **kw)
    gs.bilinear_sample, gs.trilinear_sample = k1, k2
    try:
        yield most
    finally:
        gs.bilinear_sample, gs.trilinear_sample = orig["bilinear_sample"], orig[
            "trilinear_sample"]


def same_items(a, b):
    """Bit equality of two loader items: the same keys, dtypes, shapes and
    values."""
    import numpy as np
    import torch
    if sorted(a) != sorted(b):
        return False
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
            if not (isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor)
                    and x.dtype == y.dtype and torch.equal(x, y)):
                return False
        elif isinstance(x, str) or isinstance(y, str):
            if x != y:
                return False
        else:
            x, y = np.asarray(x), np.asarray(y)
            if x.dtype != y.dtype or not np.array_equal(x, y):
                return False
    return True


def progressive_validate(v, conf_path, prog_root, dev, mesh_resolution, out):
    """A second validate of ``v``'s scene, read from its copy with
    progressive JPEGs (``prog_root``): a fresh ``Validator`` (same seed) whose
    loader items equal ``v``'s bit for bit and whose cascade equals the one
    ``v``'s validate built, bit for bit; every forward kernel launched."""
    import torch
    from surf_tpu_torch import _build, validate
    from surf_tpu_torch.config import ConfigFactory
    conf = ConfigFactory.parse_file(conf_path)
    conf["val_dataset"]["data_dir"] = prog_root
    pv = validate.Validator(conf, device=dev, mesh_resolution=mesh_resolution, seed=0,
                            base_exp_dir=out, clean_mesh=True)
    t0 = time.time()
    for i in range(len(v.dataset)):
        if not same_items(pv.dataset[i], v.dataset[i]):
            fail(f"mvs: loader item {i} of the progressive-JPEG scene differs from the "
                 f"baseline scene's")
    items_s = time.time() - t0
    if dev == "cuda":
        torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.time()
    (m,) = pv.validate()
    if dev == "cuda":
        torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(_build.launches)
    missing = [k for k in FWD_KERNELS if launches[k] <= 0]
    if missing:
        fail(f"mvs: the progressive-JPEG validate launched no {missing}")
    if not same_cascade(v.last_scene, pv.last_scene):
        fail("mvs: the progressive-JPEG validate's cascade differs from the baseline "
             "scene's bits")
    nums = {"items_equal": len(v.dataset), "items_s": items_s, "cascade_equal": True,
            "wall_s": wall, "launches": {k: c for k, c in launches.items() if c}}
    nums.update({k: m[k] for k in ("build_s", "mesh_s", "clean_mesh_s", "render_rays_per_s",
                                   "mesh_faces", "psnr")})
    pv.last_scene = None
    return nums


def mvs_phase(dev="cuda", conf_paths=None, image_hw=None, mesh_resolution=512):
    """The three cross-dataset validates at their confs' full width
    (confs/surf_bmvs.conf, surf_tanks.conf, surf_eth3d.conf: 3 views of
    576x768, 5 of 1080x1920, 7 of 1200x2400; ``val_res_level`` 4; 4
    stages to 704^3; a 512^3 mesh), each on the procedural scene that the
    phase writes in the dataset's layout (``data.mvs_scene``: the conf's
    scan and views, JPEGs at the native 576x768, 1080x1920, 4141x6212)
    into a temporary directory under exp/ and deletes:
    ``Validator.validate`` with ``clean_mesh`` on, every forward kernel
    launched, finite outputs, a non-empty mesh that cleaning does not
    grow, the PNG artifacts written and ``val_img`` equal to the rendered
    colour's 8-bit form; K1's and K2's largest operands held against
    their 32-bit rules; the largest call of every kernel launched held
    against its plain version (``largest_call_entries``, ``call_site``
    "mvs <key> validate"), and K1's call on its largest image (the colour
    fetch's fused pyramid) too.  Also times ``read_jpeg`` on one native image
    of each dataset (the first read apart; the library's g++ build
    apart, before any scene is written).  The BlendedMVS and ETH3D scenes
    are also written with progressive JPEGs (``MVS_PROGRESSIVE``): each
    view's progressive file must decode to its baseline file's pixels,
    ``read_jpeg`` is timed on one, and the BlendedMVS validate runs a
    second time on the progressive scene (``progressive_validate``: loader
    items and cascade equal to the baseline scene's bit for bit).

    Returns (the launches of each validate, the numbers of each, the
    entries of each by kernel), keyed "bmvs", "tanks", "eth3d".  (``dev``
    "cpu" with tiny ``conf_paths`` and small ``image_hw`` rehearses the
    phase.)"""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from surf_tpu_torch import _build, validate
    from surf_tpu_torch.config import ConfigFactory
    from surf_tpu_torch.data.mvs_generic import _SPECS
    from surf_tpu_torch.data.mvs_scene import write_mvs_scene
    from surf_tpu_torch.io import jpeg, read_png
    cuda = dev == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()
    os.makedirs(os.path.join(HERE, "exp"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mvs_", dir=os.path.join(HERE, "exp"))
    launches, nums, entries = {}, {}, {}
    try:
        t0 = time.time()
        jpeg._lib()
        build_s = time.time() - t0
        for key, conf_name in MVS_CONFS.items():
            conf = ConfigFactory.parse_file((conf_paths or {}).get(key) or os.path.join(
                HERE, "confs", conf_name))
            d = conf["val_dataset"]
            name, scan = d["dataset_name"], d["scene"][0]
            views = sorted(list(d["ref_view"]) + list(d["src_views"]))
            native = (image_hw or {}).get(key) or _SPECS[name]["native_hw"]
            t0 = time.time()
            prog_root = os.path.join(tmp, key + "_progressive") \
                if key in MVS_PROGRESSIVE else None
            root = write_mvs_scene(os.path.join(tmp, key), name, scan, views,
                                   image_hw=native, progressive_root=prog_root)
            n = {"dataset": name, "views": len(views), "native_hw": list(native),
                 "scene_write_s": time.time() - t0}
            if key == "bmvs":
                n["jpeg_library_build_s"] = build_s

            def image(base, vid):
                return os.path.join(base, _SPECS[name]["img_pattern"].format(scan=scan, vid=vid))
            times = []
            for _ in range(4):
                t0 = time.time()
                jpeg.read_jpeg(image(root, views[0]))
                times.append(time.time() - t0)
            n.update(read_jpeg_first_s=times[0], read_jpeg_s=statistics.median(times[1:]))
            if prog_root:
                times = []
                for _ in range(4):
                    t0 = time.time()
                    jpeg.read_jpeg(image(prog_root, views[0]))
                    times.append(time.time() - t0)
                n.update(read_jpeg_progressive_first_s=times[0],
                         read_jpeg_progressive_s=statistics.median(times[1:]))
                # the same coefficients: the same pixels, view by view
                for vid in views:
                    if not np.array_equal(jpeg.read_jpeg(image(prog_root, vid)),
                                          jpeg.read_jpeg(image(root, vid))):
                        fail(f"mvs {key}: view {vid}'s progressive JPEG decodes to other "
                             f"pixels than its baseline JPEG")
                n["progressive_views_equal"] = len(views)
            d["data_dir"] = root
            v = validate.Validator(conf, device=dev, mesh_resolution=mesh_resolution, seed=0,
                                   base_exp_dir=os.path.join(tmp, key + "_val"),
                                   clean_mesh=True)
            t0 = time.time()
            item = v.dataset[0]
            n["val_load_s_per_item"] = time.time() - t0
            n["val_item_hw"] = list(item["imgs"].shape[1:3])
            del item
            written, write = {}, validate.write_artifacts

            def recorded(*args):
                written["args"] = args
                return write(*args)
            validate.write_artifacts = recorded
            try:
                sync()
                if cuda:
                    torch.cuda.reset_peak_memory_stats()
                _build.reset_launches()
                with record_forward_calls() as fwd, record_k4_train_calls() as (_, k4), \
                        record_size_limits() as sizes:
                    (m,) = v.validate()
                sync()
            finally:
                validate.write_artifacts = write
            launches[key] = dict(_build.launches)
            missing = [k for k in FWD_KERNELS if launches[key][k] <= 0]
            if missing:
                fail(f"mvs: the {name} validate launched no {missing}")
            if not m["finite"] or not 0 < m["mesh_faces"] <= m["mesh_faces_before_clean"]:
                fail(f"mvs {key}: non-finite outputs or a mesh that cleaning emptied or "
                     f"grew: {m}")
            dd, file_name, epoch, color = written["args"][:4]
            val_png = os.path.join(dd, "val_img", f"{file_name}_epoch{epoch}.png")
            if not np.array_equal(read_png(val_png),
                                  (color * 256).clip(0, 255).astype(np.uint8)):
                fail(f"mvs {key}: val_img's PNG differs from the rendered colour's 8-bit form")
            arts = sorted(os.path.relpath(os.path.join(dp, f), dd)
                          for dp, _, fs in os.walk(dd) for f in fs
                          if not dp.endswith(("meshes", "logs")))
            if len(arts) != 8:
                fail(f"mvs {key}: expected 2 PNGs and 3 depth PNG/.npy pairs, found {arts}")
            k1_image, k1_co, k1_kw = sizes.pop("k1_largest_image")
            over = {k: x for k, x in sizes.items() if k != "k1_views" and x >= INT32_LIMIT}
            if over or sizes["k1_views"] > 65535:
                fail(f"mvs {key}: a K1/K2 operand beyond the 32-bit rules: {sizes}")
            n.update({k: m[k] for k in ("build_s", "mesh_s", "clean_mesh_s",
                                        "render_rays_per_s", "mesh_faces_before_clean",
                                        "mesh_faces", "active_voxels", "psnr",
                                        "render_depth_loss", "sdf_depth_loss")})
            n["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else 0.0
            n["largest_operands"] = dict(sizes, int32_limit=INT32_LIMIT)
            n["launches"] = {k: c for k, c in launches[key].items() if c}
            if key == MVS_PROGRESSIVE_VALIDATE:
                n["progressive_validate"] = progressive_validate(
                    v, (conf_paths or {}).get(key) or os.path.join(HERE, "confs", conf_name),
                    prog_root, dev, mesh_resolution, os.path.join(tmp, key + "_progressive_val"))
            say("mvs", f"{key} validate ({file_name}, {len(arts)} artifacts): "
                + json.dumps(n))
            del v, written
            shutil.rmtree(os.path.join(tmp, key), ignore_errors=True)
            t0 = time.time()
            entries[key] = largest_call_entries(f"mvs {key} validate", fwd, k4, {})
            # K1 on the largest image (the colour fetch's fused pyramid), if
            # that is not its largest call by output
            if k1_image.numel() > fwd["bilinear_sample_2d"][1][0].numel():
                e = k1_entry(f"mvs {key} validate, largest image", k1_image, k1_co,
                             k1_kw.get("align_corners", True), k1_kw.get("normalized", True))
                e["call_site"] = f"mvs {key} validate, largest image"
                entries[key]["bilinear_sample_2d"].append(e)
                say("kernel", f"bilinear_sample_2d in the mvs {key} validate, largest image: "
                    + json.dumps(e))
            n["kernel_checks_s"] = time.time() - t0
            nums[key] = n
            del fwd, k4, k1_image, k1_co
            if cuda:
                torch.cuda.empty_cache()
        return launches, nums, entries
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 11: multi-device (torch.distributed) on the one card
# ---------------------------------------------------------------------------

DP_RANKS = 2
# the training items of the gloo run: super-batches (0, 1) and (2, 2), the
# second padded with item 2 at weight 0
DP_STEPS = (((0, 1), (1.0, 1.0), 0.0), ((2, 2), (1.0, 0.0), 0.5))
# the gradient tolerance of reference_train_step (kernels against plain
# versions on the card): 1e-3 of the leaf's largest entry, plus 1e-6
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
# phase 12: tiny model, card against CPU
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 6c: the variants beside the main path, and the second order of K1/K2
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


PROTOCOL_KERNELS = FWD_KERNELS + BWD_KERNELS


def leaves_equal(a, b):
    """Two numpy pytrees (bf16 leaves as 2-byte void) equal bit for bit."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            leaves_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(
            leaves_equal(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


CHAIN_KERNELS = ("sparse_trilinear_multi", "sparse_trilinear_multi_bwd", "bilinear_sample_2d",
                 "bilinear_sample_2d_bwd", "trilinear_sample_3d")
FT_CONF = os.path.join(HERE, "confs", "surf_synthetic_finetune.conf")


def chain_leg(ckpt, out, dev="cuda", conf_path=FT_CONF, steps=100, mesh_res=256):
    """scripts/torch_finetune_runs.sh's stages B and D in miniature: the
    demo's checkpoint ``ckpt`` resumed into ``python -m surf_tpu_torch.main
    --mode finetune`` (in this process) on ``conf_path`` derived as the
    script derives stage C's conf (``derive_conf``: ``steps`` steps, a
    validate and a save at the end only, the step -1 validate kept), its
    meshes at ``mesh_res``^3 scored by ``evaluation.synthetic.main``, all
    under ``out``.  The launch counts are zeroed just before and read just
    after the run.  Checks: every step's loss terms finite; the mean loss
    of the last 10 steps below that of the first 10; the step -1 and the
    last mesh non-empty after cleaning with finite Chamfers (printed, not
    held to improve); K3, K3b, K1, K1b and K2 launched.  Returns
    (launches, numbers)."""
    import io
    import math
    import torch
    from surf_tpu_torch import _build, derive_conf, finetune, main as tmain
    from surf_tpu_torch.evaluation import synthetic
    cuda = dev == "cuda"
    conf = os.path.join(out, "chain.conf")
    derive_conf.write(conf_path, conf, {"train.epochs": steps, "train.val_freq": steps,
                                        "train.save_freq": steps})
    terms, step = [], finetune.Finetuner.step

    def recorded(self, batch, i):
        terms.append(step(self, batch, i))
        return terms[-1]
    finetune.Finetuner.step = recorded
    if cuda:
        torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.time()
    try:
        f = tmain.main(["--conf", conf, "--mode", "finetune", "--resume", ckpt,
                        "--mesh_resolution", str(mesh_res), "--device", dev,
                        "--out", os.path.join(out, "chain")])
        if cuda:
            torch.cuda.synchronize()
        launches = dict(_build.launches)
    finally:
        finetune.Finetuner.step = step
    run_s = time.time() - t0
    bad = [(i, k, v) for i, r in enumerate(terms) for k, v in r.items() if not math.isfinite(v)]
    if len(terms) != steps or bad:
        fail(f"protocol chain: {len(terms)} steps of {steps}, non-finite terms {bad[:5]}")
    first, last = (statistics.mean(r["loss"] for r in part) for part in (terms[:10],
                                                                        terms[-10:]))
    say("protocol", "chain loss " + " ".join(f"{r['loss']:.4f}" for r in terms))
    if not last < first:
        fail(f"protocol chain: the mean loss of the last 10 steps {last} is not below "
             f"the first 10's {first}")
    t1 = time.time()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rows = synthetic.main([f.base_exp_dir, "--conf", conf])
    for line in buf.getvalue().splitlines():
        say("protocol", "chain score: " + line)
    nums = {"steps": steps, "run_s": run_s, "score_s": time.time() - t1,
            "loss_first_last": [first, last],
            "chamfer": {r[0]: {"chamfer": r[1], "d2s": r[2], "s2d": r[3], "vertices": r[4]}
                        for r in rows}}
    if [r[0] for r in rows] != [-1, steps - 1] \
            or any(not r[4] or not math.isfinite(r[1]) for r in rows):
        fail(f"protocol chain: the step -1 and step {steps - 1} meshes scored {rows}")
    say("protocol", "chain kernels " + json.dumps(launches))
    missing = [k for k in CHAIN_KERNELS if launches[k] <= 0]
    if missing:
        fail(f"protocol chain: the finetune launched no {missing}")
    return launches, nums


def protocol_phase(dev="cuda", shape=(), steps=60, eval_every=30, mesh_res=256,
                   chain_conf=FT_CONF, chain_steps=100):
    """The training demo (``surf_tpu_torch.train_synthetic``) in this
    process at the r5 protocol's shape (``train_synthetic.R5_ARGS``: 4
    stages 88^3 -> 704^3, 5 views of 480x640, 512 rays, bf16 matching
    volume; ``shape``'s flags override them): ``steps`` steps under the
    warmup-cosine schedule, an evaluation (cascade, ``mesh_res``^3 SDF
    lattice, marching cubes, cleaning, Chamfer against the analytic
    sphere) every ``eval_every`` steps and at the end, the JSONL log and the
    checkpoint, in a directory under exp/ that the phase deletes.  The
    launch counts are zeroed just before and read just after.  Checks:
    every loss term finite at every step; the mean loss of the last 10
    steps below that of the first 10 and the mean PSNR above it; each
    evaluation a non-empty cleaned mesh with a finite Chamfer; the checkpoint read back equal bit for bit to the run's last
    parameters and state; ``summarize_run`` on the log; every forward and
    backward kernel launched.  Before the directory goes, ``chain_leg``
    resumes the checkpoint into ``chain_steps`` finetune steps on
    ``chain_conf`` (whose model must be ``shape``'s), with its own launch
    counts.  Returns (launches, numbers, the leg's launches).  (``dev``
    "cpu" rehearses the phase without a card.)"""
    import io
    import math
    import tempfile
    import torch
    from surf_tpu_torch import _build, summarize_run, train_synthetic
    from surf_tpu_torch.utils import load_checkpoint, to_numpy_tree
    cuda = dev == "cuda"
    out = os.path.join(HERE, "exp", "chip_smoke_protocol")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    log, ckpt = os.path.join(out, "run.jsonl"), os.path.join(out, "run.ckpt.npz")
    argv = list(train_synthetic.R5_ARGS) + list(shape) + [
        "--steps", str(steps), "--eval_every", str(eval_every),
        "--mesh_res", str(mesh_res), "--log_jsonl", log, "--save_ckpt", ckpt,
        "--mesh_out", os.path.join(out, "mesh.ply"), "--device", dev]
    tmp = tempfile.tempdir
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.time()
    try:
        # the evaluations' vertex files go to the phase's directory
        tempfile.tempdir = out
        run = train_synthetic.main(argv)
        if cuda:
            torch.cuda.synchronize()
        launches = dict(_build.launches)
        run_s = time.time() - t0
        rows = run["rows"]
        bad = [(i, k, v) for i, r in enumerate(rows) for k, v in r.items()
               if not math.isfinite(v)]
        if len(rows) != steps or bad:
            fail(f"protocol: {len(rows)} steps of {steps}, non-finite terms {bad[:5]}")
        mean = lambda key, part: statistics.mean(r[key] for r in part)
        first, last = rows[:10], rows[-10:]
        nums = {"steps": steps, "run_s": run_s,
                "loss_first_last": [mean("loss", first), mean("loss", last)],
                "psnr_first_last": [mean("psnr", first), mean("psnr", last)],
                "color_first_last": [mean("color_loss", first), mean("color_loss", last)],
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else 0.0}
        with open(log) as f:
            t_steps = [json.loads(line)["t"] for line in f]
        if len(t_steps) != steps:
            fail(f"protocol: the log holds {len(t_steps)} rows of {steps}")
        nums["cold_step_s"], warm = t_steps[0], sorted(t_steps[1:])
        nums["warm_s_per_step_median_min_max"] = [statistics.median(warm), warm[0], warm[-1]]
        say("protocol", "loss " + " ".join(f"{r['loss']:.4f}" for r in rows))
        say("protocol", "psnr " + " ".join(f"{r['psnr']:.3f}" for r in rows))
        if not nums["loss_first_last"][1] < nums["loss_first_last"][0]:
            fail(f"protocol: the mean loss of the last 10 steps "
                 f"{nums['loss_first_last'][1]} is not below the first 10's "
                 f"{nums['loss_first_last'][0]}")
        if not nums["psnr_first_last"][1] > nums["psnr_first_last"][0]:
            fail(f"protocol: the mean PSNR of the last 10 steps "
                 f"{nums['psnr_first_last'][1]} is not above the first 10's "
                 f"{nums['psnr_first_last'][0]}")
        evals = run["evals"]
        nums["evals"] = [{"step": e[0], "vertices": len(e[1]), "faces": len(e[2]),
                          "chamfer": e[3], "seconds": e[4]} if e[1] is not None
                         else {"step": e[0], "seconds": e[2]} for e in evals]
        if [e[0] for e in evals] != list(range(eval_every, steps, eval_every)) + [steps] \
                or any(e[1] is None or not len(e[1]) or not len(e[2])
                       or not math.isfinite(e[3]) for e in evals):
            fail(f"protocol: evaluations {nums['evals']}")
        saved = load_checkpoint(ckpt)
        if int(saved["epoch"]) != steps \
                or not leaves_equal(saved["model"], to_numpy_tree(run["params"])) \
                or not leaves_equal(saved["state"], to_numpy_tree(run["state"])):
            fail("protocol: the checkpoint does not read back bit for bit")
        nums["checkpoint_gb"] = os.path.getsize(ckpt) / 2 ** 30
        say("protocol", f"checkpoint (epoch {steps}, model and state) read back bit for "
            "bit against the run's last parameters and state")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            summarize_run.main(log)
        text = buf.getvalue()
        if not text.startswith(f"steps: {steps} (step 0..{steps - 1})") \
                or "loss window-means" not in text:
            fail(f"protocol: summarize_run printed {text!r}")
        for line in text.splitlines():
            say("protocol", "summary: " + line)
        del run
        say("protocol", "kernels " + json.dumps(launches))
        missing = [k for k in PROTOCOL_KERNELS if launches[k] <= 0]
        if missing:
            fail(f"protocol: the training demo launched no {missing}")
        if cuda:
            torch.cuda.empty_cache()
        t0 = time.time()
        chain_launches, nums["chain"] = chain_leg(ckpt, out, dev=dev, conf_path=chain_conf,
                                                  steps=chain_steps, mesh_res=mesh_res)
        nums["chain"]["leg_s"] = time.time() - t0
    finally:
        tempfile.tempdir = tmp
        shutil.rmtree(out, ignore_errors=True)
    return launches, nums, chain_launches


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
    swaps += [(gs, attr, getattr(gs, attr + "_plain")) for attr, _, _ in SECOND_ORDER.values()]
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
    say("ragged", f"K1-K5, K1b-K3b and K4w match their plain versions, max abs err "
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
    missing = [k for k in FWD_KERNELS + ("sdf_lattice_mlp", "marching_cubes_lattice")
               if launches[k] <= 0]
    if missing:
        fail(f"the main path launched no {missing}")
    if m["lattice_fused_points"] != m["lattice_points"]:
        fail(f"K5 evaluated {m['lattice_fused_points']} of the lattice's "
             f"{m['lattice_points']} points")
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

    t0 = time.time()
    dtu_mesh = os.path.join(HERE, "exp", "chip_smoke_eval_input", "dtu_validate.ply")
    dtu_launches, dtu_nums, dtu_entries = dtu_phase(keep_mesh=dtu_mesh)
    for r in rows:
        for part, counts in dtu_launches.items():
            r[f"launches_in_dtu_{part}"] = counts.get(r["name"], 0)
            new = dtu_entries[part].get(r["name"], [])
            if new:
                r.setdefault("also_checked", []).extend(new)
    dtu_nums["phase_s"] = time.time() - t0
    say("dtu", json.dumps(dtu_nums))
    torch.cuda.empty_cache()

    t0 = time.time()
    try:
        eval_nums = eval_phase(dtu_mesh)
    finally:
        shutil.rmtree(os.path.dirname(dtu_mesh), ignore_errors=True)
    eval_nums["phase_s"] = time.time() - t0
    say("eval", json.dumps(eval_nums))

    t0 = time.time()
    mvs_launches, mvs_nums, mvs_entries = mvs_phase()
    for r in rows:
        for key, counts in mvs_launches.items():
            r[f"launches_in_mvs_{key}"] = counts.get(r["name"], 0)
            new = mvs_entries[key].get(r["name"], [])
            if new:
                r.setdefault("also_checked", []).extend(new)
    mvs_nums["phase_s"] = time.time() - t0
    say("mvs", json.dumps(mvs_nums))
    torch.cuda.empty_cache()

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
    torch.cuda.empty_cache()

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    proto_launches, proto_nums, chain_launches = protocol_phase()
    proto_nums["phase_s"] = time.time() - t0
    say("protocol", json.dumps(proto_nums))
    chamfers = proto_nums["chain"]["chamfer"]
    say("protocol", "chain Chamfer " + " -> ".join(
        f"{chamfers[k]['chamfer']:.4f} (step {k})" for k in sorted(chamfers)))
    say("protocol", f"phase: {proto_nums['phase_s']:.1f} s, the chain leg "
        f"{proto_nums['chain']['leg_s']:.1f} s of it")
    torch.cuda.empty_cache()

    t0 = time.time()
    err = reference_check()
    say("reference", f"tiny model (validate and one training step) on the card matches "
        f"the CPU plain path, max abs err {err:.3e} ({time.time() - t0:.1f} s)")
    say("total", f"{time.time() - t_start:.1f} s")

    # the variants phase's launches and largest calls, and its kernels' rows
    for r in rows:
        r["launches_in_variants"] = var_launches.get(r["name"], 0)
        if var_entries.get(r["name"]):
            r.setdefault("also_checked", []).extend(var_entries[r["name"]])
    rows += second_rows
    for r in rows:
        r["launches_in_protocol"] = proto_launches.get(r["name"], 0)
        r["launches_in_protocol_finetune"] = chain_launches.get(r["name"], 0)
    print(json.dumps({"kernels": rows}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
