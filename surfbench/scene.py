"""The benchmark's inputs: a procedural textured sphere seen by a ring of
pinhole cameras, made on the host from a seed.

A frozen copy of surf_tpu_torch/data/synthetic.py and of the camera
helpers of surf_tpu_torch/data/cameras.py (commit 5b1d451), so that a
change to the program cannot change what is measured.  Departures: a
scene is named by a 32-bit seed drawn from the run's seed, of which
``seed % 1000`` shifts the texture (by 0.37 a unit, as the original's
scene index does); every (scene, view) image is rendered once and shared
by the items that use it; the training items' rays come from one
generator per item drawn from the run's seed.  An item has the keys the
DTU loader gives (and the original's items have).
"""

from __future__ import annotations

import numpy as np


def seed_ints(seed, *salt, n=1):
    """``n`` 32-bit ints drawn from ``seed`` (any whole number) and ``salt``."""
    ss = np.random.SeedSequence([int(seed) % 2 ** 64, *[int(s) for s in salt]])
    return [int(x) for x in ss.generate_state(n)]


# ---------------------------------------------------------------------------
# cameras (surf_tpu_torch/data/cameras.py)
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# the scene (surf_tpu_torch/data/synthetic.py)
# ---------------------------------------------------------------------------

def _texture(pts):
    """Procedural RGB texture on the sphere from 3D position."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    r = 0.5 + 0.5 * np.sin(7 * x) * np.cos(5 * y)
    g = 0.5 + 0.5 * np.sin(6 * y + 1.3) * np.cos(4 * z)
    b = 0.5 + 0.5 * np.sin(5 * z + 2.1) * np.cos(6 * x)
    return np.stack([r, g, b], axis=-1).astype(np.float32)


class Scene:
    """One sphere scene: ``n_views`` ring cameras at ``img_hw`` (h, w),
    jittered by ``scene_seed``; ``view(v)`` renders (image, depth, mask)
    once."""

    def __init__(self, scene_seed, img_hw, n_views, radius=1.0, cam_dist=3.0):
        self.scene_seed = int(scene_seed)
        self.img_hw = tuple(img_hw)
        self.n_views = int(n_views)
        self.radius, self.cam_dist = float(radius), float(cam_dist)
        h, w = self.img_hw
        f = 0.9 * w
        K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
        self.intr = np.eye(4, dtype=np.float32)
        self.intr[:3, :3] = K
        rng = np.random.RandomState(self.scene_seed)
        self.poses = []
        for v in range(self.n_views):
            ang = 2 * np.pi * v / self.n_views + rng.uniform(-0.05, 0.05)
            elev = 0.35 + rng.uniform(-0.1, 0.1)
            cpos = self.cam_dist * np.array([
                np.cos(ang) * np.cos(elev), np.sin(ang) * np.cos(elev), np.sin(elev)],
                np.float32)
            fwd = -cpos / np.linalg.norm(cpos)
            up = np.array([0, 0, 1], np.float32)
            right = np.cross(fwd, up)
            right /= np.linalg.norm(right)
            down = np.cross(fwd, right)
            c2w = np.eye(4, dtype=np.float32)
            c2w[:3, :3] = np.stack([right, down, fwd], axis=1)
            c2w[:3, 3] = cpos
            self.poses.append(c2w)
        self._views = {}

    def view(self, v):
        if v not in self._views:
            h, w = self.img_hw
            c2w = self.poses[v]
            # rays_from_pixels, _ray_sphere and the camera-frame depth of
            # every pixel, a column at a time in float32 (the (n, 3) @ (3, 3)
            # products of the original take seconds at 1200x2400)
            ys, xs = np.meshgrid(np.arange(h, dtype=np.float32),
                                 np.arange(w, dtype=np.float32), indexing="ij")
            xs, ys = xs.reshape(-1), ys.reshape(-1)
            kinv = np.linalg.inv(self.intr[:3, :3]).astype(np.float32)
            cam = [xs * kinv[a, 0] + ys * kinv[a, 1] + kinv[a, 2] for a in range(3)]
            inv_n = 1.0 / np.sqrt(cam[0] * cam[0] + cam[1] * cam[1] + cam[2] * cam[2])
            cam = [c * inv_n for c in cam]
            rot = c2w[:3, :3]
            d = [cam[0] * rot[a, 0] + cam[1] * rot[a, 1] + cam[2] * rot[a, 2]
                 for a in range(3)]
            o = c2w[:3, 3]
            b = o[0] * d[0] + o[1] * d[1] + o[2] * d[2]
            disc = b * b - (float(o @ o) - self.radius ** 2)
            t = -b - np.sqrt(np.maximum(disc, 0))
            hit = (disc > 0) & (t > 0)
            t_safe = np.where(hit, t, 0).astype(np.float32)
            shift = (self.scene_seed % 1000) * 0.37
            pts = np.stack([o[a] + d[a] * t_safe + shift for a in range(3)], -1)
            img = np.where(hit[:, None], _texture(pts), np.float32(0.05))
            # the camera-frame z of the unit ray is cam[2]
            depth = np.where(hit, t_safe * cam[2], 0.0)
            self._views[v] = (img.reshape(h, w, 3).astype(np.float32),
                              depth.reshape(h, w).astype(np.float32),
                              hit.reshape(h, w).astype(np.float32))
        return self._views[v]

    def render_views(self, views, workers=4):
        """Render ``views`` on ``workers`` threads (numpy releases the
        interpreter lock in its loops)."""
        from concurrent.futures import ThreadPoolExecutor
        todo = [v for v in views if v not in self._views]
        with ThreadPoolExecutor(max(1, min(workers, len(todo)))) as pool:
            list(pool.map(self.view, todo))

    def item(self, ref_view, num_src_view, *, mode, rng=None, n_rays=512,
             val_res_level=1, name="syn", pseudo_seed=0, light=None):
        """The loader item of reference view ``ref_view`` and the
        ``num_src_view`` views after it on the ring.  ``mode`` "train":
        ``n_rays`` rays (3/4 on the sphere) drawn from ``rng``; "val": every
        ``val_res_level``-th pixel of the reference view.  ``light``, an
        RGB gain, scales every image of the item (the scene under another
        light)."""
        h, w = self.img_hw
        view_ids = [ref_view] + [(ref_view + 1 + i) % self.n_views
                                 for i in range(num_src_view)]
        imgs, depths, masks = zip(*[self.view(v) for v in view_ids])
        imgs = np.stack(imgs)
        if light is not None:
            imgs *= np.asarray(light, np.float32)
        w2cs = [np.linalg.inv(self.poses[v]) for v in view_ids]
        intrs = [self.intr.copy() for _ in view_ids]
        near_fars = [[self.cam_dist - 1.5 * self.radius, self.cam_dist + 1.5 * self.radius]
                     for _ in view_ids]
        new_intrs, c2ws, new_near_fars, scale_mat, scale_factor, w2c_ref_inv = \
            normalize_cameras(self.img_hw, intrs, w2cs, near_fars, 1.0)
        depths = [d * scale_factor for d in depths]
        w2c_ref = np.linalg.inv(w2c_ref_inv)
        rng = rng or np.random.RandomState(0)
        src_idx = rng.randint(1, 1 + num_src_view)
        out = {"imgs": imgs, "intrs": new_intrs, "c2ws": c2ws,
               "scale_mat": (w2c_ref_inv @ scale_mat).astype(np.float32),
               "view_ids": np.asarray(view_ids, np.int64), "near_fars": new_near_fars}
        if mode == "train":
            valid_xy = np.argwhere(masks[0] > 0.5)[:, ::-1]
            n_uni = n_rays // 4
            sel = valid_xy[rng.randint(0, len(valid_xy), size=n_rays - n_uni)]
            uni = np.stack([rng.randint(0, w, n_uni), rng.randint(0, h, n_uni)], -1)
            pix = np.concatenate([sel, uni]).astype(np.float32)
            px, py = pix[:, 0], pix[:, 1]
        else:
            lvl = val_res_level
            tx = np.linspace(0, w - 1, w // lvl, dtype=np.float32)
            ty = np.linspace(0, h - 1, h // lvl, dtype=np.float32)
            gx, gy = np.meshgrid(tx, ty, indexing="xy")
            px, py = gx.reshape(-1), gy.reshape(-1)
            out.update({
                "bound_min": np.array([-1, -1, -1], np.float32),
                "bound_max": np.array([1, 1, 1], np.float32),
                "scene": name, "file_name": f"{name}_view{ref_view}_light0",
                "hw": np.array([h // lvl, w // lvl], np.int32),
                "masks": np.stack(masks)})
        pyi, pxi = py.astype(np.int64), px.astype(np.int64)
        rays_o, rays_d = rays_from_pixels(px, py, new_intrs[0], c2ws[0])
        near = np.array([[new_near_fars[0][0]]], np.float32)
        far = np.array([[new_near_fars[0][1]]], np.float32)
        # pseudo points: exact surface samples in the normalized frame
        sph = np.random.RandomState(pseudo_seed).randn(2048, 3)
        sph = sph / np.linalg.norm(sph, axis=1, keepdims=True) * self.radius
        pw = (w2c_ref @ np.concatenate([sph, np.ones((2048, 1))], 1).T).T[:, :3]
        out.update({
            "pixels_x": px, "pixels_y": py,
            "rays_o": rays_o.astype(np.float32), "rays_d": rays_d.astype(np.float32),
            "near": near, "far": far,
            "color": imgs[0][pyi, pxi], "depth": depths[0][pyi, pxi],
            "pseudo_depth": depths[0][pyi, pxi], "mask": masks[0][pyi, pxi],
            "mask_ref": masks[0], "depth_ref": depths[0],
            "pseudo_pts": ((pw - scale_mat[:3, 3]) / scale_mat[0, 0]).astype(np.float32),
            "pseudo_depth_ref": depths[0], "pseudo_depth_src": depths[src_idx],
            "src_idx": np.int32(src_idx), "mask_src": masks[src_idx],
            "depth_src": depths[src_idx]})
        return out
