"""DTU multi-view dataset (host-side numpy): the port's copy of
surf_tpu/data/dtu.py:28-230, reading its PNGs and PFMs through the port's
own ``io`` package.

Counterpart of the reference's datasets/dtu.py:85-472: CasMVSNet
camera files, pair.txt source-view selection, per-item view loading
(Rectified_raw images r5000/r7000, GT depth PFMs, visibility masks, pseudo
depths), world re-centering to the reference camera, unit-sphere scale
matrix, projection re-decomposition (RQ), per-view near/far from camera
distance, 3/4-masked + 1/4-uniform train ray sampling, strided full-grid
val rays, and pseudo point-cloud sampling.
"""

from __future__ import annotations

import os

import numpy as np

from ..io.image import read_png, resize_nearest
from ..io.pfm import read_pfm
from ..io.ply import read_ply
from .cameras import normalize_cameras, rays_from_pixels, read_cam_file


TOTAL_VIEWS = 49


def read_pairs(data_dir, num_select=10):
    """``Cameras/pair.txt``: for each listed reference view, its first
    ``num_select`` source views (a list indexed by view id, None where a
    view is not listed)."""
    pairs = [None] * TOTAL_VIEWS
    with open(os.path.join(data_dir, "Cameras/pair.txt")) as f:
        num_viewpoint = int(f.readline())
        for _ in range(num_viewpoint):
            ref = int(f.readline().rstrip())
            toks = f.readline().rstrip().split()
            pairs[ref] = [int(x) for x in toks[1::2]][:num_select]
    return pairs


class DTUDataset:
    total_views = TOTAL_VIEWS

    def __init__(self, confs, mode, rng=None):
        self.mode = mode
        # explicit host-side RNG so --seed reproduces ray sampling and the
        # per-item src-view choice (``get_dataset`` passes RandomState(seed))
        self.rng = rng if rng is not None else \
            np.random.RandomState(confs.get_int("seed", default=0))
        self.data_dir = confs["data_dir"]
        self.num_src_view = confs.get_int("num_src_view")
        self.interval_scale = confs.get_float("interval_scale")
        self.num_interval = confs.get_int("num_interval")
        self.img_hw = tuple(confs.get_list("img_hw"))
        self.n_rays = confs.get_int("n_rays", default=0)
        self.factor = confs.get_float("factor")
        self.split = confs.get_string("split", default=None)
        self.scene = confs.get_list("scene", default=None)
        self.light_idx = confs.get_list("light_idx", default=None)
        self.ref_view = confs.get_list("ref_view", default=None)
        self.val_res_level = confs.get_int("val_res_level", default=1) \
            if mode == "val" else 1

        if self.scene is None:
            if self.split is None:
                raise ValueError("There are no scenes!")
            with open(self.split) as f:
                self.scene = [l.rstrip() for l in f.readlines() if l.strip()]

        self.pairs = read_pairs(self.data_dir)
        self.metas = self._build_list()

    # -- metadata -------------------------------------------------------
    def _build_list(self):
        light_idxs = self.light_idx if self.light_idx is not None else list(range(7))
        metas = []
        for scan in self.scene:
            refs = self.ref_view if self.ref_view is not None \
                else list(range(self.total_views))
            for ref in refs:
                for light in light_idxs:
                    metas.append((scan, light, ref))
        print(f"dataset {self.mode} metas: {len(metas)}")
        return metas

    def __len__(self):
        return len(self.metas)

    # -- per-view IO ----------------------------------------------------
    def _img_path(self, scan, vid, light_idx):
        kind = "r7000" if vid > 48 else "r5000"
        return os.path.join(
            self.data_dir,
            f"Rectified_raw/{scan}/rect_{vid + 1:0>3}_{light_idx}_{kind}.png")

    def _read_img(self, path):
        return resize_nearest(read_png(path).astype(np.float32), self.img_hw[::-1])

    def _read_depth(self, path):
        return resize_nearest(read_pfm(path)[0].astype(np.float32), self.img_hw[::-1])

    # -- item -----------------------------------------------------------
    def __getitem__(self, idx):
        scan, light_idx, ref_view = self.metas[idx]
        srcs = self.pairs[ref_view][:self.num_src_view]
        view_ids = [ref_view] + list(srcs)
        rng = self.rng
        src_idx = rng.randint(1, len(view_ids))

        imgs, intrs, w2cs, near_fars, masks = [], [], [], [], []
        ref_depth = src_depth = ref_pseudo = src_pseudo = None
        for i, vid in enumerate(view_ids):
            img = self._read_img(self._img_path(scan, vid, light_idx)) / 256.0
            cam_file = os.path.join(self.data_dir, f"Cameras/{vid:0>8}_cam.txt")
            intr, w2c, near_far = read_cam_file(
                cam_file, self.img_hw, self.num_interval, self.interval_scale)
            mask_file = os.path.join(
                self.data_dir, f"Depths_raw/{scan}/depth_visual_{vid:0>4}.png")
            mask = (self._read_img(mask_file) > 10).astype(np.float32)
            imgs.append(img)
            intrs.append(intr)
            w2cs.append(w2c)
            near_fars.append(near_far)
            masks.append(mask)
            if i == 0 or i == src_idx:
                depth = self._read_depth(os.path.join(
                    self.data_dir, f"Depths_raw/{scan}/depth_map_{vid:0>4}.pfm"))
                pseudo = self._read_depth(os.path.join(
                    self.data_dir, f"Pseudo_depths/{scan}/{vid:0>8}.pfm"))
                if i == 0:
                    ref_depth, ref_pseudo = depth, pseudo
                if i == src_idx:
                    src_depth, src_pseudo = depth, pseudo

        intrs, c2ws, near_fars, scale_mat, scale_factor, w2c_ref_inv = normalize_cameras(
            self.img_hw, intrs, w2cs, near_fars, self.factor)

        ref_depth = ref_depth * scale_factor
        ref_pseudo = ref_pseudo * scale_factor
        src_depth = src_depth * scale_factor
        src_pseudo = src_pseudo * scale_factor

        imgs = np.stack(imgs).astype(np.float32)            # (nv, H, W, 3)
        masks = np.stack(masks).astype(np.float32)

        out = {
            "imgs": imgs,
            "intrs": intrs,
            "c2ws": c2ws,
            "scale_mat": (w2c_ref_inv @ scale_mat).astype(np.float32),
            "view_ids": np.asarray(view_ids, np.int64),
            "near_fars": near_fars,
        }

        h, w = self.img_hw
        if self.mode == "train":
            assert self.n_rays > 0, "No sampling rays!"
            mask0 = masks[0]
            valid_xy = np.argwhere(mask0 > 0.5)[:, ::-1].astype(np.float32)
            n_uni = self.n_rays // 4
            n_val = self.n_rays - n_uni
            sel = valid_xy[rng.randint(0, len(valid_xy), size=n_val)]
            uni = np.stack([rng.randint(0, w, n_uni).astype(np.float32),
                            rng.randint(0, h, n_uni).astype(np.float32)], -1)
            pix = np.concatenate([sel, uni])
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
                "scene": scan,
                "file_name": f"{scan}_view{ref_view}_light{light_idx}",
                "hw": np.array([h // lvl, w // lvl], np.int32),
                "masks": masks,
            })

        pyi, pxi = py.astype(np.int64), px.astype(np.int64)
        rays_o, rays_d = rays_from_pixels(px, py, intrs[0], c2ws[0])

        # pseudo point cloud (dtu.py:435-445)
        ply = read_ply(os.path.join(
            self.data_dir, f"Pseudo_points/mvsnet{int(scan[4:]):0>3}_l3.ply"))
        pxyz = ply["vertices"].astype(np.float32)
        sel = rng.randint(0, len(pxyz), size=2048)
        pw = pxyz[sel]
        pw = (np.linalg.inv(w2c_ref_inv) @ np.concatenate(
            [pw, np.ones_like(pw[:, :1])], 1).T).T[:, :3]
        pseudo_pts = (pw - scale_mat[:3, 3]) / scale_mat[0, 0]

        out.update({
            "pixels_x": px, "pixels_y": py,
            "rays_o": rays_o.astype(np.float32),
            "rays_d": rays_d.astype(np.float32),
            "near": np.array([[near_fars[0][0]]], np.float32),
            "far": np.array([[near_fars[0][1]]], np.float32),
            "color": imgs[0][pyi, pxi],
            "depth": ref_depth[pyi, pxi],
            "pseudo_depth": ref_pseudo[pyi, pxi],
            "mask": masks[0][pyi, pxi],
            "mask_ref": masks[0],
            "depth_ref": ref_depth,
            "pseudo_pts": pseudo_pts.astype(np.float32),
            "pseudo_depth_ref": ref_pseudo,
            "pseudo_depth_src": src_pseudo,
            "src_idx": np.int32(src_idx),
            "mask_src": masks[src_idx],
            "depth_src": src_depth,
        })
        return out
