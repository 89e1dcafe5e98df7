"""The procedural scene (``scene.py``) laid out on disk as one DTU scan, in
the layout that a DTU finetune loader reads:

    Cameras/pair.txt, Cameras/{vid:08d}_cam.txt
    Rectified_raw/{scan}/rect_{vid+1:03d}_3_r5000.png              RGB, light 3
    Depths_raw/{scan}/depth_visual_{vid:04d}.png                    L mask
    PseudoMVSScore/dtu_exp/{scan}/filtered_avg_depth/{vid:08d}.pfm  pseudo depth
    PseudoMVSDepth/mvsnet{n:03d}_l3.ply                             pseudo points

Written with this file's own PNG, PFM and PLY writers (not the program's),
so that a fault in the program's readers cannot be cancelled by a writer
of its own.  ``write_scan`` returns the arrays as written (the images'
bytes, the cameras' float32 values, the depths and the points), from
which the plain reference makes what the loader should make of the files.

The scan is the reference view (ring camera 0) and its two pair sources
(ring cameras 1 and ``n_views - 1``, labelled ``ref_view + 1`` and
``ref_view - 1``).  Cam files hold the intrinsics at DTU's native
1200x1600, which the loader rescales to the conf's ``img_hw``, and the
depth range [d - 1.5 r, d + 1.5 r] over ``num_interval`` planes.  Pseudo
depths are the analytic camera-frame depths (0 off the sphere), pseudo
points 8192 points on the sphere drawn from the scene's seed.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

NATIVE_HW = (1200, 1600)
LIGHT = 3
N_POINTS = 8192


def write_png(path, img):
    """An 8-bit greyscale (h, w) or RGB (h, w, 3) PNG, each row unfiltered."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape[:2]
    colour = 2 if img.ndim == 3 else 0
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)], axis=1)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)))
        f.write(chunk(b"IEND", b""))


def write_pfm(path, depth):
    """A one-channel little-endian PFM (rows stored bottom up)."""
    depth = np.asarray(depth, np.float32)
    with open(path, "wb") as f:
        f.write(f"Pf\n{depth.shape[1]} {depth.shape[0]}\n-1.0\n".encode("ascii"))
        f.write(np.flipud(depth).astype("<f4").tobytes())


def write_ply(path, points):
    """A binary little-endian PLY of float32 vertices."""
    points = np.asarray(points, "<f4")
    with open(path, "wb") as f:
        f.write(("ply\nformat binary_little_endian 1.0\n"
                 f"element vertex {len(points)}\n"
                 "property float x\nproperty float y\nproperty float z\nend_header\n")
                .encode("ascii"))
        f.write(points.tobytes())


def write_cam(path, w2c, intr3, near, interval):
    """A CasMVSNet cam file: the extrinsic, the intrinsic and the depth
    range's start and interval, each float32 value written exactly."""
    def line(row):
        return " ".join(repr(float(x)) for x in row) + "\n"
    with open(path, "w") as f:
        f.write("extrinsic\n" + "".join(line(r) for r in w2c))
        f.write("\nintrinsic\n" + "".join(line(r) for r in intr3))
        f.write(f"\n{near!r} {interval!r}\n")


def write_scan(root, scene, scan, ref_view, num_interval, seed):
    """Writes ``scene`` (a ``scene.Scene``) under ``root`` as DTU scan
    ``scan`` (``"scan24"``) around view ``ref_view``; ``seed`` draws the
    pseudo points.  Returns the arrays written: ``view_ids`` (the DTU ids,
    reference first, in pair order), ``images`` (uint8), ``masks`` (uint8),
    ``w2cs`` and ``intrs`` (float32, native size), ``near`` and
    ``interval``, ``depths`` and ``points`` (float32)."""
    h, w = scene.img_hw
    ring = [0, 1, scene.n_views - 1]
    view_ids = [ref_view, ref_view + 1, ref_view - 1]
    near = float(scene.cam_dist - 1.5 * scene.radius)
    interval = float(3.0 * scene.radius / num_interval)
    intr3 = scene.intr[:3, :3].astype(np.float32).copy()
    intr3[0] *= np.float32(NATIVE_HW[1] / w)
    intr3[1] *= np.float32(NATIVE_HW[0] / h)
    scene.render_views(ring, workers=3)
    dirs = {k: os.path.join(root, k.format(scan=scan)) for k in (
        "Cameras", "Rectified_raw/{scan}", "Depths_raw/{scan}",
        "PseudoMVSScore/dtu_exp/{scan}/filtered_avg_depth", "PseudoMVSDepth")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    with open(os.path.join(dirs["Cameras"], "pair.txt"), "w") as f:
        f.write(f"{len(view_ids)}\n")
        for v in view_ids:
            others = [u for u in view_ids if u != v]
            f.write(f"{v}\n{len(others)} "
                    + " ".join(f"{u} {1000.0 - k:.1f}" for k, u in enumerate(others)) + "\n")
    out = {"view_ids": view_ids, "images": [], "masks": [], "w2cs": [], "intrs": [],
           "near": near, "interval": interval, "depths": []}
    for v, r in zip(view_ids, ring):
        img, depth, hit = scene.view(r)
        w2c = np.linalg.inv(scene.poses[r]).astype(np.float32)
        write_cam(os.path.join(dirs["Cameras"], f"{v:0>8}_cam.txt"), w2c, intr3, near, interval)
        rgb = np.clip(img * 256.0, 0, 255).astype(np.uint8)
        mask = (hit > 0.5).astype(np.uint8) * 255
        write_png(os.path.join(dirs["Rectified_raw/{scan}"],
                               f"rect_{v + 1:0>3}_{LIGHT}_r5000.png"), rgb)
        write_png(os.path.join(dirs["Depths_raw/{scan}"], f"depth_visual_{v:0>4}.png"), mask)
        write_pfm(os.path.join(dirs["PseudoMVSScore/dtu_exp/{scan}/filtered_avg_depth"],
                               f"{v:0>8}.pfm"), depth)
        for key, a in (("images", rgb), ("masks", mask), ("w2cs", w2c), ("intrs", intr3),
                       ("depths", depth.astype(np.float32))):
            out[key].append(a)
    pts = np.random.RandomState(seed).randn(N_POINTS, 3)
    pts = (pts / np.linalg.norm(pts, axis=1, keepdims=True) * scene.radius).astype(np.float32)
    write_ply(os.path.join(dirs["PseudoMVSDepth"], f"mvsnet{int(scan[4:]):0>3}_l3.ply"), pts)
    out["points"] = pts
    return out
