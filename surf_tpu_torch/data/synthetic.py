"""Procedural synthetic multi-view scene (host-side numpy).

A textured sphere (plus optional ground-truth-free clutter) rendered
analytically from a ring of pinhole cameras.  Produces batches with exactly
the same dict schema as the DTU loader (datasets/dtu.py:383-467), so the
whole train/val/finetune stack — and the benchmark — runs self-contained
without the DTU download.  Ground-truth depths/masks are analytic, pseudo
depths/points are the ground truth (playing the role of RC-MVSNet output).
"""

from __future__ import annotations

import numpy as np

from .cameras import normalize_cameras, rays_from_pixels


def _texture(pts):
    """Procedural RGB texture on the sphere from 3D position."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    r = 0.5 + 0.5 * np.sin(7 * x) * np.cos(5 * y)
    g = 0.5 + 0.5 * np.sin(6 * y + 1.3) * np.cos(4 * z)
    b = 0.5 + 0.5 * np.sin(5 * z + 2.1) * np.cos(6 * x)
    return np.stack([r, g, b], axis=-1).astype(np.float32)


def _ray_sphere(rays_o, rays_d, center, radius):
    """First intersection t (inf when missed)."""
    oc = rays_o - center
    b = np.sum(oc * rays_d, axis=-1)
    c = np.sum(oc * oc, axis=-1) - radius ** 2
    disc = b * b - c
    hit = disc > 0
    sq = np.sqrt(np.maximum(disc, 0))
    t = -b - sq
    t = np.where(hit & (t > 0), t, np.inf)
    return t


class SyntheticDataset:
    """mode 'train' or 'val'; matches the DTU loader surface used by the
    runner (get_loader contract, datasets/__init__.py:16-43)."""

    def __init__(self, confs, mode):
        self.mode = mode
        self.img_hw = tuple(confs.get_list("img_hw", default=[128, 160]))
        self.num_src_view = confs.get_int("num_src_view", default=2)
        self.n_rays = confs.get_int("n_rays", default=512)
        self.n_views_total = confs.get_int("n_views_total", default=8)
        self.radius_world = confs.get_float("radius_world", default=1.0)
        self.cam_dist = confs.get_float("cam_dist", default=3.0)
        self.n_scenes = confs.get_int("n_scenes", default=4 if mode == "train" else 1)
        self.val_res_level = confs.get_int("val_res_level", default=1)
        self.seed = confs.get_int("seed", default=0)
        self.metas = [(f"syn{i}", 0, v) for i in range(self.n_scenes)
                      for v in (range(self.n_views_total) if mode == "train" else [0])]
        if mode == "val":
            self.metas = [(f"syn{i}", 0, 0) for i in range(self.n_scenes)]

    def __len__(self):
        return len(self.metas)

    # -- scene construction -------------------------------------------------
    def _cameras(self, scene_seed):
        h, w = self.img_hw
        f = 0.9 * w
        K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
        intr = np.eye(4, dtype=np.float32)
        intr[:3, :3] = K
        rng = np.random.RandomState(scene_seed)
        poses = []
        for v in range(self.n_views_total):
            ang = 2 * np.pi * v / self.n_views_total + rng.uniform(-0.05, 0.05)
            elev = 0.35 + rng.uniform(-0.1, 0.1)
            cpos = self.cam_dist * np.array([
                np.cos(ang) * np.cos(elev), np.sin(ang) * np.cos(elev), np.sin(elev)],
                np.float32)
            fwd = -cpos / np.linalg.norm(cpos)
            up = np.array([0, 0, 1], np.float32)
            right = np.cross(fwd, up)
            right /= np.linalg.norm(right)
            down = np.cross(fwd, right)
            R_c2w = np.stack([right, down, fwd], axis=1)  # cam axes as columns
            c2w = np.eye(4, dtype=np.float32)
            c2w[:3, :3] = R_c2w
            c2w[:3, 3] = cpos
            poses.append(c2w)
        return intr, poses

    def _render_view(self, intr, c2w, radius, scene_seed):
        h, w = self.img_hw
        ys, xs = np.meshgrid(np.arange(h, dtype=np.float32),
                             np.arange(w, dtype=np.float32), indexing="ij")
        rays_o, rays_d = rays_from_pixels(xs.reshape(-1), ys.reshape(-1), intr, c2w)
        t = _ray_sphere(rays_o, rays_d, np.zeros(3, np.float32), radius)
        hit = np.isfinite(t)
        t_safe = np.where(hit, t, 0)
        pts = rays_o + rays_d * t_safe[:, None]
        img = np.where(hit[:, None], _texture(pts + scene_seed * 0.37), 0.05)
        cam_d = (np.linalg.inv(c2w[:3, :3]) @ rays_d.T).T
        depth = np.where(hit, t_safe * cam_d[:, 2], 0.0)
        return (img.reshape(h, w, 3).astype(np.float32),
                depth.reshape(h, w).astype(np.float32),
                hit.reshape(h, w).astype(np.float32))

    def _build(self, idx):
        scan, light_idx, ref_view = self.metas[idx]
        scene_seed = self.seed * 1000 + int(scan[3:])
        intr, poses = self._cameras(scene_seed)
        nv = 1 + self.num_src_view
        order = [ref_view] + [(ref_view + 1 + i) % self.n_views_total
                              for i in range(self.num_src_view)]
        view_ids = order

        imgs, depths, masks, w2cs, intrs, near_fars = [], [], [], [], [], []
        for vid in view_ids:
            img, depth, mask = self._render_view(intr, poses[vid], self.radius_world,
                                                 scene_seed)
            imgs.append(img)
            depths.append(depth)
            masks.append(mask)
            w2cs.append(np.linalg.inv(poses[vid]))
            intrs.append(intr.copy())
            near_fars.append([self.cam_dist - 1.5 * self.radius_world,
                              self.cam_dist + 1.5 * self.radius_world])

        new_intrs, c2ws, new_near_fars, scale_mat, scale_factor, w2c_ref_inv = \
            normalize_cameras(self.img_hw, intrs, w2cs, near_fars, 1.0)
        depths = [d * scale_factor for d in depths]
        return {
            "scan": scan, "view_ids": view_ids, "imgs": np.stack(imgs),
            "depths": depths, "masks": np.stack(masks),
            "intrs": new_intrs, "c2ws": c2ws,
            "scale_mat": (w2c_ref_inv @ scale_mat).astype(np.float32),
            "scale_mat_raw": scale_mat.astype(np.float32),
            "near_fars": new_near_fars,
            "w2c_ref": np.linalg.inv(w2c_ref_inv), "scale_factor": scale_factor,
        }

    # -- public API ----------------------------------------------------------
    def __getitem__(self, idx):
        s = self._build(idx)
        h, w = self.img_hw
        rng = np.random.RandomState((self.seed * 7919 + idx) % (2 ** 31))
        src_idx = rng.randint(1, 1 + self.num_src_view)

        out = {
            "imgs": s["imgs"], "intrs": s["intrs"], "c2ws": s["c2ws"],
            "scale_mat": s["scale_mat"],
            "view_ids": np.asarray(s["view_ids"], np.int64),
            "near_fars": s["near_fars"],
        }

        if self.mode == "train":
            mask0 = s["masks"][0]
            valid_xy = np.argwhere(mask0 > 0.5)[:, ::-1]  # (n, 2) x,y
            n_uni = self.n_rays // 4
            n_val = self.n_rays - n_uni
            sel = valid_xy[rng.randint(0, len(valid_xy), size=n_val)]
            uni = np.stack([rng.randint(0, w, n_uni), rng.randint(0, h, n_uni)], -1)
            pix = np.concatenate([sel, uni]).astype(np.float32)
            px, py = pix[:, 0], pix[:, 1]
        else:
            lvl = self.val_res_level
            tx = np.linspace(0, w - 1, w // lvl, dtype=np.float32)
            ty = np.linspace(0, h - 1, h // lvl, dtype=np.float32)
            gx, gy = np.meshgrid(tx, ty, indexing="xy")
            px, py = gx.reshape(-1), gy.reshape(-1)
            out.update({
                "bound_min": np.array([-1, -1, -1], np.float32),
                "bound_max": np.array([1, 1, 1], np.float32),
                "scene": s["scan"],
                "file_name": f"{s['scan']}_view{s['view_ids'][0]}_light0",
                "hw": np.array([h // lvl, w // lvl], np.int32),
                "masks": s["masks"],
            })

        pyi, pxi = py.astype(np.int64), px.astype(np.int64)
        rays_o, rays_d = rays_from_pixels(px, py, s["intrs"][0], s["c2ws"][0])
        near, far = np.array([[s["near_fars"][0][0]]], np.float32), \
            np.array([[s["near_fars"][0][1]]], np.float32)

        # pseudo points: exact surface samples in the normalized frame
        rng2 = np.random.RandomState(idx + 123)
        sph = rng2.randn(2048, 3)
        sph = sph / np.linalg.norm(sph, axis=1, keepdims=True) * self.radius_world
        pw = (s["w2c_ref"] @ np.concatenate([sph, np.ones((2048, 1))], 1).T).T[:, :3]
        sm = s["scale_mat_raw"]
        pseudo_pts = ((pw - sm[:3, 3]) / sm[0, 0]).astype(np.float32)

        out.update({
            "pixels_x": px, "pixels_y": py,
            "rays_o": rays_o.astype(np.float32), "rays_d": rays_d.astype(np.float32),
            "near": near, "far": far,
            "color": s["imgs"][0][pyi, pxi],
            "depth": s["depths"][0][pyi, pxi],
            "pseudo_depth": s["depths"][0][pyi, pxi],
            "mask": s["masks"][0][pyi, pxi],
            "mask_ref": s["masks"][0],
            "depth_ref": s["depths"][0],
            "pseudo_pts": pseudo_pts,
            "pseudo_depth_ref": s["depths"][0],
            "pseudo_depth_src": s["depths"][src_idx],
            "src_idx": np.int32(src_idx),
            "mask_src": s["masks"][src_idx],
            "depth_src": s["depths"][src_idx],
        })
        return out
