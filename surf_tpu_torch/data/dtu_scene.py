"""A fixture for the tests, not a
loader (no loader imports it): writes the procedural synthetic scene
(``SyntheticDataset``'s textured sphere and ring of cameras) as a DTU scan
on disk, in the layout the DTU loaders read, so that the DTU data path
runs with no download:

    Cameras/pair.txt, Cameras/{vid:08d}_cam.txt
    Rectified_raw/{scan}/rect_{vid+1:03d}_{light}_r5000.png     RGB
    Depths_raw/{scan}/depth_visual_{vid:04d}.png                 L mask
    Depths_raw/{scan}/depth_map_{vid:04d}.pfm                    GT depth
    Pseudo_depths/{scan}/{vid:08d}.pfm                           pseudo depth
    PseudoMVSScore/dtu_exp/{scan}/filtered_avg_depth/{vid:08d}.pfm
    Pseudo_points/mvsnet{n:03d}_l3.ply, PseudoMVSDepth/mvsnet{n:03d}_l3.ply

The images are rendered at ``image_hw`` (DTU's native 1200x1600 by
default; any 3:4 size), the cam files hold the intrinsics at the native
1200x1600 that ``read_cam_file`` rescales from, and the depth range is the
synthetic scene's [d - 1.5 r, d + 1.5 r] over ``num_interval`` planes.
Depths are the analytic ones (pseudo depths and points are the ground
truth), written with the port's own PNG and PFM writers (the PNG rows
filtered as libpng filters them, so that reading the scene takes the
decode path real scans take).

``write_dtu_test_scan`` writes the same scene in the layout of the
official ``DTU_TEST`` mask set that the offline cleaning reads
(``evaluation.clean_mesh``), in the same world frame:

    scan{N}/mask/{vid:03d}.png        RGB, 0 or 255 (the sphere's silhouette)
    scan{N}/cams/{vid:08d}_cam.txt    intrinsics at the masks' size
"""

from __future__ import annotations

import os

import numpy as np

from ..config import ConfigFactory
from ..io.image import write_png
from ..io.pfm import write_pfm
from ..io.ply import write_ply
from .synthetic import SyntheticDataset

NATIVE_HW = (1200, 1600)
SCAN = "scan24"
LIGHT = 3               # the light the validation and finetune confs read
NUM_INTERVAL = 192      # the confs' num_interval: the depth range's planes
N_POINTS = 8192


def ring_neighbours(i, n):
    """The ring's other cameras, nearest to camera ``i`` of ``n`` first."""
    return sorted((j for j in range(n) if j != i),
                  key=lambda j: (min((j - i) % n, (i - j) % n), j))


def write_cam_file(path, w2c, intr, near, interval):
    """A CasMVSNet cam file: the 4x4 extrinsic, the 3x3 intrinsic and the
    depth range's start and interval (line 11), as ``read_cam_file``
    reads them."""
    with open(path, "w") as f:
        f.write("extrinsic\n")
        f.writelines(" ".join(repr(float(x)) for x in row) + "\n" for row in w2c)
        f.write("\nintrinsic\n")
        f.writelines(" ".join(repr(float(x)) for x in row) + "\n" for row in intr[:3, :3])
        f.write(f"\n{near!r} {interval!r}\n")


def _ring(n, image_hw):
    """The procedural scene's ring of ``n`` cameras at ``image_hw``: the
    dataset, its intrinsics and its camera-to-world poses (the poses depend
    on ``n`` alone)."""
    h, w = image_hw
    syn = SyntheticDataset(ConfigFactory.parse_string(
        f"d {{\n img_hw = [{h}, {w}]\n n_views_total = {n}\n}}")["d"], "val")
    intr, poses = syn._cameras(0)
    return syn, intr, poses


def write_dtu_scene(root, view_ids=(0, 1, 2, 3, 4), image_hw=NATIVE_HW):
    """Write scan ``SCAN`` under ``root``: one view per DTU view id in
    ``view_ids`` (the ring's cameras in order), under light ``LIGHT``.
    Returns ``root``."""
    h, w = image_hw
    if h * 4 != w * 3:
        raise ValueError(f"image_hw {image_hw} is not 3:4, as DTU's 1200x1600 is")
    n = len(view_ids)
    scene_seed = 0
    syn, intr, poses = _ring(n, image_hw)
    native = intr.copy()
    native[0] *= NATIVE_HW[1] / w
    native[1] *= NATIVE_HW[0] / h
    near = syn.cam_dist - 1.5 * syn.radius_world
    interval = 3.0 * syn.radius_world / NUM_INTERVAL
    dirs = {k: os.path.join(root, k.format(scan=SCAN)) for k in (
        "Cameras", "Rectified_raw/{scan}", "Depths_raw/{scan}", "Pseudo_depths/{scan}",
        "PseudoMVSScore/dtu_exp/{scan}/filtered_avg_depth", "Pseudo_points",
        "PseudoMVSDepth")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)

    with open(os.path.join(dirs["Cameras"], "pair.txt"), "w") as f:
        f.write(f"{n}\n")
        for i, ref in enumerate(view_ids):
            others = ring_neighbours(i, n)
            f.write(f"{ref}\n{len(others)} " + " ".join(
                f"{view_ids[j]} {1000.0 - k:.1f}" for k, j in enumerate(others)) + "\n")

    for i, vid in enumerate(view_ids):
        write_cam_file(os.path.join(dirs["Cameras"], f"{vid:0>8}_cam.txt"),
                       np.linalg.inv(poses[i]), native, near, interval)
        img, depth, mask = syn._render_view(intr, poses[i], syn.radius_world, scene_seed)
        rgb = np.clip(img * 256.0, 0, 255).astype(np.uint8)
        write_png(os.path.join(dirs["Rectified_raw/{scan}"],
                               f"rect_{vid + 1:0>3}_{LIGHT}_r5000.png"), rgb)
        write_png(os.path.join(dirs["Depths_raw/{scan}"], f"depth_visual_{vid:0>4}.png"),
                  (mask > 0.5).astype(np.uint8) * 255)
        for key, name in (("Depths_raw/{scan}", f"depth_map_{vid:0>4}.pfm"),
                          ("Pseudo_depths/{scan}", f"{vid:0>8}.pfm"),
                          ("PseudoMVSScore/dtu_exp/{scan}/filtered_avg_depth",
                           f"{vid:0>8}.pfm")):
            write_pfm(os.path.join(dirs[key], name), depth)

    rng = np.random.RandomState(0)
    pts = rng.randn(N_POINTS, 3)
    pts = (pts / np.linalg.norm(pts, axis=1, keepdims=True) * syn.radius_world)
    for key in ("Pseudo_points", "PseudoMVSDepth"):
        write_ply(os.path.join(dirs[key], f"mvsnet{int(SCAN[4:]):0>3}_l3.ply"),
                  pts.astype(np.float32))
    return root


def write_dtu_test_scan(root, scan=24, view_ids=(43, 42, 44), n_ring=5, mask_hw=NATIVE_HW):
    """Write ``scan{scan}`` of a ``DTU_TEST``-layout mask set under
    ``root``: ring camera i of ``n_ring`` (the ring ``write_dtu_scene``
    writes for ``n_ring`` views, so the same world frame) labelled
    ``view_ids[i]``, its mask the sphere's silhouette as an RGB 0/255 PNG
    at ``mask_hw`` (DTU's 1200x1600 by default) and its cam file with the
    intrinsics at that size (the offline cleaning reads them unscaled).
    Returns ``root``."""
    if len(view_ids) > n_ring:
        raise ValueError(f"{len(view_ids)} view ids for a ring of {n_ring} cameras")
    syn, intr, poses = _ring(n_ring, mask_hw)
    mask_dir = os.path.join(root, f"scan{scan}", "mask")
    cam_dir = os.path.join(root, f"scan{scan}", "cams")
    os.makedirs(mask_dir, exist_ok=True)
    os.makedirs(cam_dir, exist_ok=True)
    near = syn.cam_dist - 1.5 * syn.radius_world
    interval = 3.0 * syn.radius_world / NUM_INTERVAL
    for i, vid in enumerate(view_ids):
        write_cam_file(os.path.join(cam_dir, f"{vid:08d}_cam.txt"),
                       np.linalg.inv(poses[i]), intr, near, interval)
        _, _, hit = syn._render_view(intr, poses[i], syn.radius_world, 0)
        mask = (hit > 0.5).astype(np.uint8) * 255
        write_png(os.path.join(mask_dir, f"{vid:03d}.png"),
                  np.repeat(mask[..., None], 3, axis=-1))
    return root
