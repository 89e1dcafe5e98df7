"""A fixture for the tests, not a
loader (no loader imports it): writes the procedural synthetic scene
(``SyntheticDataset``'s textured sphere and ring of cameras) in the on-disk
layout of one of ``mvs_generic``'s datasets, so that the BlendedMVS, Tanks
and ETH3D data paths run with no download:

    BMVSDataset:   {scan}/blended_images/{vid:08d}_masked.jpg
                   {scan}/cams/{vid:08d}_cam.txt, {scan}/cams/pair.txt
                   {scan}/rendered_depth_maps/{vid:08d}.pfm
    TanksDataset,  {scan}/images/{vid:08d}.jpg
    ETH3DDataset:  {scan}/cams/{vid:08d}_cam.txt, {scan}/pair.txt

One view per id of ``view_ids``, the ring's cameras in order.  The images
are baseline JPEGs (``io.jpeg.write_jpeg``, 4:2:0) at ``image_hw``, the
dataset's native size by default (576x768, 1080x1920, 4141x6212); with
``progressive_root`` the same scene is written there too, every file the
same but the JPEGs progressive (``write_jpeg(..., progressive=True)`` of
the same pixels: the same coefficients, so ``read_jpeg`` gives the same
pixels from either).  The
cam files hold the intrinsics at the native size that the loader rescales
from and the depth range [d - 1.5 r, d + 1.5 r] over the dataset's conf's
``num_interval`` planes.  ``pair.txt`` lists every id from 0 to the
largest written, in order, as the loader indexes it; an id that was not
written has no source views.  BlendedMVS's depth maps are the analytic
ones.

A view is rendered (numpy, one ray a pixel) at the size ``image_hw``
divided by the least integer that brings it to at most ``MAX_RENDER_PIXELS``
and repeated to ``image_hw`` by the nearest resize: at ETH3D's 4141x6212
that renders 1036x1553 and repeats each pixel about 4x4, so the JPEGs, and
their decode, are at the native size.
"""

from __future__ import annotations

import math
import os

import numpy as np

from ..config import ConfigFactory
from ..io.image import resize_nearest
from ..io.jpeg import write_jpeg
from ..io.pfm import write_pfm
from .dtu_scene import ring_neighbours, write_cam_file
from .mvs_generic import _SPECS
from .synthetic import SyntheticDataset

# the confs' num_interval (confs/surf_bmvs.conf, surf_tanks.conf, surf_eth3d.conf)
NUM_INTERVAL = {"BMVSDataset": 100, "TanksDataset": 150, "ETH3DDataset": 180}
MAX_RENDER_PIXELS = 2_500_000
JPEG_QUALITY = 90


def write_mvs_scene(root, dataset_name, scan, view_ids, image_hw=None,
                    progressive_root=None):
    """Write scan ``scan`` of ``dataset_name``'s layout under ``root`` (and
    with progressive JPEGs under ``progressive_root``). Returns ``root``."""
    spec = _SPECS[dataset_name]
    native_hw = spec["native_hw"]
    h, w = image_hw or native_hw
    step = max(1, math.ceil(math.sqrt(h * w / MAX_RENDER_PIXELS)))
    rh, rw = -(-h // step), -(-w // step)
    n = len(view_ids)
    syn = SyntheticDataset(ConfigFactory.parse_string(
        f"d {{\n img_hw = [{rh}, {rw}]\n n_views_total = {n}\n}}")["d"], "val")
    scene_seed = 0
    intr, poses = syn._cameras(scene_seed)
    native = intr.copy()
    native[0] *= native_hw[1] / rw
    native[1] *= native_hw[0] / rh
    near = syn.cam_dist - 1.5 * syn.radius_world
    interval = 3.0 * syn.radius_world / NUM_INTERVAL[dataset_name]

    roots = [root] + ([progressive_root] if progressive_root else [])

    def path(key, vid=0, base=root):
        p = os.path.join(base, spec[key].format(scan=scan, vid=vid))
        os.makedirs(os.path.dirname(p), exist_ok=True)
        return p

    for base in roots:
        with open(path("pair_pattern", base=base), "w") as f:
            f.write(f"{max(view_ids) + 1}\n")
            for ref in range(max(view_ids) + 1):
                others = ring_neighbours(view_ids.index(ref), n) if ref in view_ids else []
                f.write(f"{ref}\n{len(others)}" + "".join(
                    f" {view_ids[j]} {1000.0 - k:.1f}" for k, j in enumerate(others)) + "\n")
    for i, vid in enumerate(view_ids):
        img, depth, _ = syn._render_view(intr, poses[i], syn.radius_world, scene_seed)
        rgb = resize_nearest(np.clip(img * 256.0, 0, 255).astype(np.uint8), (w, h))
        for j, base in enumerate(roots):
            write_cam_file(path("cam_pattern", vid, base), np.linalg.inv(poses[i]), native,
                           near, interval)
            write_jpeg(path("img_pattern", vid, base), rgb, quality=JPEG_QUALITY,
                       progressive=j == 1)
            if spec["depth_pattern"] is not None:
                write_pfm(path("depth_pattern", vid, base), resize_nearest(depth, (w, h)))
    return root
