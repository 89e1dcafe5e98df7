"""Host-side camera utilities (numpy).

Covers the reference's camera pipeline: CasMVSNet cam-file parsing
(datasets/dtu.py:182-202), projection-matrix decomposition
(load_K_Rt_from_P, dtu.py:14-35 — reimplemented as an RQ decomposition
instead of cv2.decomposeProjectionMatrix), the unit-sphere scale matrix from
frustum corners (get_scale_mat, dtu.py:204-240), and ray generation
(dtu.py:428-433).
"""

from __future__ import annotations

import numpy as np


def rq3(M):
    """RQ decomposition of a 3x3 matrix: M = R @ Q with R upper-triangular
    and Q orthonormal (via QR of the rotated transpose)."""
    P = np.fliplr(np.eye(3))
    q, r = np.linalg.qr((P @ M).T)
    R = P @ r.T @ P
    Q = P @ q.T
    return R, Q


def decompose_projection(P):
    """P (3,4) -> (K (3,3) with K[2,2]=1, R (3,3) world->cam, C (3,) camera
    center).  Sign conventions match cv2.decomposeProjectionMatrix: positive
    diagonal K, det(R) = +1."""
    M = P[:3, :3]
    K, R = rq3(M)
    # force positive diagonal of K (S is its own inverse, so M = (K S)(S R))
    s = np.sign(np.diag(K))
    s[s == 0] = 1
    S = np.diag(s)
    K = K @ S
    R = S @ R
    t = np.linalg.solve(K, P[:3, 3])
    if np.linalg.det(R) < 0:      # P is defined up to scale; flip to det=+1
        R = -R
        t = -t
    C = -R.T @ t
    K = K / K[2, 2]
    return K, R, C


def load_K_Rt_from_P(P):
    """(3,4) projection -> (intr (4,4), c2w pose (4,4)), matching the
    reference's cv2-based helper (dtu.py:14-35)."""
    K, R, C = decompose_projection(np.asarray(P, np.float64))
    intr = np.eye(4, dtype=np.float32)
    intr[:3, :3] = K
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R.T          # cam -> world rotation
    pose[:3, 3] = C
    return intr, pose


def read_cam_file(path, img_hw, num_interval, interval_scale=1.0,
                  native_hw=(1200, 1600)):
    """CasMVSNet `{vid}_cam.txt`: extrinsic 4x4, intrinsic 3x3,
    depth_min/interval; intrinsics rescaled from the native resolution to
    img_hw (dtu.py:182-202)."""
    with open(path) as f:
        lines = [l.rstrip() for l in f.readlines()]
    extr = np.fromstring(" ".join(lines[1:5]), dtype=np.float32, sep=" ").reshape(4, 4)
    intr3 = np.fromstring(" ".join(lines[7:10]), dtype=np.float32, sep=" ").reshape(3, 3)
    depth_min = float(lines[11].split()[0])
    depth_interval = float(lines[11].split()[1]) * interval_scale
    depth_max = depth_min + depth_interval * num_interval
    intr = np.eye(4, dtype=np.float32)
    intr[:3, :3] = intr3
    intr[0] *= img_hw[1] / native_hw[1]
    intr[1] *= img_hw[0] / native_hw[0]
    return intr, extr, [depth_min, depth_max]


def get_scale_mat(img_hw, intrs, w2cs, near_fars, factor=0.8):
    """AABB of all view frusta -> similarity transform scaling the scene into
    the unit sphere (dtu.py:204-240).  Returns (scale_mat (4,4), 1/radius)."""
    bnds = np.zeros((3, 2))
    bnds[:, 0] = np.inf
    bnds[:, 1] = -np.inf
    im_h, im_w = img_hw
    for intr, w2c, near_far in zip(intrs, w2cs, near_fars):
        mind, maxd = near_far
        xs = np.array([0, 0, im_w, im_w, 0, 0, im_w, im_w])
        ys = np.array([0, im_h, 0, im_h, 0, im_h, 0, im_h])
        ds = np.array([mind] * 4 + [maxd] * 4)
        pts = np.stack([
            (xs - intr[0, 2]) * ds / intr[0, 0],
            (ys - intr[1, 2]) * ds / intr[1, 1],
            ds,
        ]).astype(np.float32)
        pts = np.linalg.inv(w2c) @ np.concatenate([pts, np.ones_like(pts[:1])], 0)
        pts = pts[:3]
        bnds[:, 0] = np.minimum(bnds[:, 0], pts.min(axis=1))
        bnds[:, 1] = np.maximum(bnds[:, 1], pts.max(axis=1))
    center = ((bnds[:, 1] + bnds[:, 0]) / 2).astype(np.float32)
    radius = (bnds[:, 1] - bnds[:, 0]).max() / 2 * factor
    scale_mat = np.diag([radius, radius, radius, 1.0]).astype(np.float32)
    scale_mat[:3, 3] = center
    return scale_mat, 1.0 / radius


def normalize_cameras(img_hw, intrs, w2cs, near_fars, factor):
    """Re-centre the world on the first view's camera and scale the views'
    frusta into the unit sphere (dtu.py:337-364).  Returns (intrs, c2ws,
    near_fars) of the normalised views as float32 arrays, ``scale_mat`` (the
    re-centred frame -> unit sphere inverse), the depth ``scale_factor``
    and ``w2c_ref_inv`` (the first view's camera-to-world)."""
    w2c_ref_inv = np.linalg.inv(w2cs[0])
    w2cs = [w2c @ w2c_ref_inv for w2c in w2cs]
    scale_mat, scale_factor = get_scale_mat(img_hw, intrs, w2cs, near_fars, factor=factor)
    new_intrs, c2ws, new_near_fars = [], [], []
    for intr, w2c in zip(intrs, w2cs):
        ni, c2w = load_K_Rt_from_P((intr @ w2c @ scale_mat)[:3, :4])
        new_intrs.append(ni)
        c2ws.append(c2w)
        new_near_fars.append(near_far_from_campos(c2w))
    return (np.stack(new_intrs).astype(np.float32), np.stack(c2ws).astype(np.float32),
            np.stack(new_near_fars).astype(np.float32), scale_mat, scale_factor,
            w2c_ref_inv)


def rays_from_pixels(pixels_x, pixels_y, intr, c2w):
    """dtu.py:428-433: normalized-direction rays through pixel centers."""
    p = np.stack([pixels_x, pixels_y, np.ones_like(pixels_x)], axis=-1).astype(np.float32)
    p = p @ np.linalg.inv(intr[:3, :3]).T
    d = p / np.linalg.norm(p, axis=-1, keepdims=True)
    rays_d = d @ c2w[:3, :3].T
    rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape).copy()
    return rays_o, rays_d


def near_far_from_campos(c2w):
    """Per-view near/far from the camera distance to the unit sphere
    (dtu.py:358-362): [0.95 (d-1), 1.05 (d+1)]."""
    dist = float(np.linalg.norm(c2w[:3, 3]))
    return [0.95 * (dist - 1.0), 1.05 * (dist + 1.0)]
