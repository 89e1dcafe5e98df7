"""Offline DTU mesh cleaning against the official ``DTU_TEST`` masks: the
port of evaluation/clean_mesh.py.

For each of the 15 test scans: project the mesh's vertices into the
dilated 1200x1600 masks of the capture views (set 0: the view-23 list,
set 1: the view-43 list), keep the faces whose vertices are seen in more
than one mask, keep the faces a ray of some view hits first (the port's
BVH raycaster), drop connected components of fewer than 500 faces, and
write ``final/scan{N}.ply`` for ``dtu_eval``:

    python -m surf_tpu_torch.evaluation.clean_mesh --root_dir <DTU_TEST> \\
        --out_dir <exp>/meshes [--n_view 3] [--set 1] [--mask_kernel_size 11]

Masks are read with the port's PNG reader (``Image.open(p).convert("L")
> 127``, as ``read_png_luma``: any PNG form, 1-bit and palette masks
too), cameras from ``scan{N}/cams/`` or else
``Cameras/``.
"""

from __future__ import annotations

import argparse
import os
from glob import glob

import numpy as np

from ..data.cameras import read_cam_file
from ..geometry.clean_mesh import clean_mesh_outside_frustum, dilate_masks
from ..geometry.mesh import Mesh
from ..io.image import read_png_luma

SCANS = [24, 37, 40, 55, 63, 65, 69, 83, 97, 105, 106, 110, 114, 118, 122]
VIEW_LIST_SET0 = [23, 24, 33, 22, 15, 34, 14, 32, 16, 35, 25]
VIEW_LIST_SET1 = [43, 42, 44, 33, 34, 32, 45, 23, 41, 24, 31]
MASK_HW = (1200, 1600)


def clean_points_by_mask_official(points, masks, projs, minimal_vis=1):
    """Vertex visibility with the official offline indexing: project with
    the full P matrix, index ``round(+1)`` into masks padded with a border
    of ones (so a point within one pixel left of or above the image counts
    as seen), and keep ``seen > minimal_vis`` (two views or more at the
    default).  The runtime pass (``geometry.clean_mesh``) samples the masks
    bilinearly instead."""
    h, w = masks.shape[1:]
    inside = np.zeros(len(points), np.float32)
    for i in range(len(projs)):
        P = projs[i]
        pi = points @ P[:3, :3].T + P[:3, 3]
        pi = pi / pi[:, 2:]
        pim = np.round(pi).astype(np.int64) + 1
        m = masks[i] > 0
        m = np.concatenate([np.ones((1, w), bool), m, np.ones((1, w), bool)], 0)
        m = np.concatenate(
            [np.ones((h + 2, 1), bool), m, np.ones((h + 2, 1), bool)], 1)
        in_img = ((pim[:, 0] >= 0) & (pim[:, 0] <= w)
                  & (pim[:, 1] >= 0) & (pim[:, 1] <= h))
        cur = m[pim[:, 1].clip(0, h + 1), pim[:, 0].clip(0, w + 1)]
        inside += cur.astype(np.float32) * in_img
    return inside > minimal_vis


def clean_mesh_by_mask_official(mesh, masks, intrs, c2ws, minimal_vis=1):
    """Keep the faces whose three vertices pass
    ``clean_points_by_mask_official``; in place, returns ``mesh``."""
    projs = [intrs[i][:3, :3] @ np.linalg.inv(c2ws[i])[:3, :4]
             for i in range(len(intrs))]
    keep = clean_points_by_mask_official(mesh.vertices, masks, projs,
                                         minimal_vis)
    mesh.update_faces(keep[mesh.faces].all(axis=-1))
    mesh.remove_unreferenced_vertices()
    return mesh


def load_views(root_dir, scan, view_ids):
    """(masks (V, H, W) f32 0/1, intrinsics (V, 4, 4), c2ws (V, 4, 4)) of
    ``scan``'s views ``view_ids``, the intrinsics at the masks' 1200x1600."""
    masks, intrs, c2ws = [], [], []
    for vid in view_ids:
        mask_path = os.path.join(root_dir, f"scan{scan}", "mask", f"{vid:03d}.png")
        mask = read_png_luma(mask_path).astype(np.float32) > 127
        cam_path = os.path.join(root_dir, f"scan{scan}", "cams",
                                f"{vid:08d}_cam.txt")
        if not os.path.exists(cam_path):
            cam_path = os.path.join(root_dir, "Cameras", f"{vid:08d}_cam.txt")
        intr, w2c, _ = read_cam_file(cam_path, MASK_HW, 192, native_hw=MASK_HW)
        masks.append(mask.astype(np.float32))
        intrs.append(intr)
        c2ws.append(np.linalg.inv(w2c))
    return np.stack(masks), np.stack(intrs), np.stack(c2ws)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--root_dir", type=str, default="./data/DTU_TEST")
    parser.add_argument("--out_dir", type=str, default="./outputs/mesh")
    parser.add_argument("--n_view", type=int, default=3)
    parser.add_argument("--set", type=int, default=1)
    parser.add_argument("--mask_kernel_size", type=int, default=11)
    args = parser.parse_args(argv)

    view_list = VIEW_LIST_SET0 if args.set == 0 else VIEW_LIST_SET1
    imgs_idx = view_list[: args.n_view]
    os.makedirs(os.path.join(args.out_dir, "final"), exist_ok=True)

    for scan in SCANS:
        print(f"processing scan{scan}")
        candidates = glob(os.path.join(args.out_dir, f"*scan{scan}_epoch0.ply")) or \
            glob(os.path.join(args.out_dir, f"*scan{scan}_*.ply"))
        if not candidates:
            print(f"  no mesh for scan{scan}, skipping")
            continue
        mesh = Mesh.load(candidates[0])
        masks, intrs, c2ws = load_views(args.root_dir, scan, imgs_idx)
        masks = dilate_masks(masks, args.mask_kernel_size // 2)
        mesh = clean_mesh_by_mask_official(mesh, masks, intrs, c2ws,
                                           minimal_vis=1)
        mesh = clean_mesh_outside_frustum(mesh, masks, intrs, c2ws, min_cc=500)
        out = os.path.join(args.out_dir, "final", f"scan{scan}.ply")
        mesh.export(out)
        print(f"  -> {out} ({len(mesh.faces)} faces)")


if __name__ == "__main__":
    main()
