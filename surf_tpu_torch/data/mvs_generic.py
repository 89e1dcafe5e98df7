"""Generic MVS validation datasets: BlendedMVS, Tanks & Temples, ETH3D
(host-side numpy): the port's copy of surf_tpu/data/mvs_generic.py:20-224,
reading its JPEGs through the port's own decoder (``io.jpeg.read_jpeg``)
and resizing with ``io.image.resize_nearest`` (cv2's ``INTER_NEAREST``).

One parameterized loader covering the reference's three near-identical
dataset classes (datasets/bmvs.py, tanks.py, eth3d.py — same camera/scale
/ray pipeline as DTU with per-dataset path patterns, native resolutions and
a per-scene pair.txt).  Depth maps (when present) provide masks via
``depth >= depth_min``; ``src_idx`` is fixed to 1 (bmvs.py:345).
"""

from __future__ import annotations

import os

import numpy as np

from ..io.image import resize_nearest
from ..io.jpeg import read_jpeg
from ..io.pfm import read_pfm
from .cameras import normalize_cameras, rays_from_pixels, read_cam_file


_SPECS = {
    "BMVSDataset": dict(
        native_hw=(576, 768),
        img_pattern="{scan}/blended_images/{vid:08d}_masked.jpg",
        cam_pattern="{scan}/cams/{vid:08d}_cam.txt",
        depth_pattern="{scan}/rendered_depth_maps/{vid:08d}.pfm",
        pair_pattern="{scan}/cams/pair.txt",
        resize_depth=True,
    ),
    "TanksDataset": dict(
        native_hw=(1080, 1920),
        img_pattern="{scan}/images/{vid:08d}.jpg",
        cam_pattern="{scan}/cams/{vid:08d}_cam.txt",
        depth_pattern=None,
        pair_pattern="{scan}/pair.txt",
        resize_depth=False,
    ),
    "ETH3DDataset": dict(
        native_hw=(4141, 6212),
        img_pattern="{scan}/images/{vid:08d}.jpg",
        cam_pattern="{scan}/cams/{vid:08d}_cam.txt",
        depth_pattern=None,
        pair_pattern="{scan}/pair.txt",
        resize_depth=False,
    ),
}


class GenericMVSDataset:
    def __init__(self, confs, mode, dataset_name, rng=None):
        spec = _SPECS[dataset_name]
        self.spec = spec
        self.mode = mode
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
        self.ref_view = confs.get_list("ref_view", default=None)
        self.src_views = confs.get_list("src_views", default=None)
        self.val_res_level = confs.get_int("val_res_level", default=1) \
            if mode == "val" else 1
        if self.scene is None:
            if self.split is None:
                raise ValueError("There are no scenes!")
            with open(self.split) as f:
                self.scene = [l.rstrip() for l in f.readlines() if l.strip()]
        self.metas = self._build_list()

    def _build_list(self):
        metas = []
        for scan in self.scene:
            pair_file = os.path.join(self.data_dir,
                                     self.spec["pair_pattern"].format(scan=scan))
            with open(pair_file) as f:
                lines = [l.rstrip() for l in f.readlines()]
            num_viewpoint = int(lines[0])
            refs = self.ref_view if self.ref_view is not None \
                else list(range(num_viewpoint))
            for ref in refs:
                if self.src_views is not None:
                    srcs = list(self.src_views)
                else:
                    srcs = [int(x) for x in lines[2 * ref + 2].split()[1::2]]
                metas.append((scan, ref, srcs))
        print(f"dataset {self.mode} metas: {len(metas)}")
        return metas

    def __len__(self):
        return len(self.metas)

    def _read_img(self, path):
        # resized before the float copy (the same values: the nearest resize
        # only gathers), so that a 4141x6212 ETH3D image is never copied whole
        return resize_nearest(read_jpeg(path), self.img_hw[::-1]).astype(np.float32)

    def __getitem__(self, idx):
        scan, ref_view, srcs = self.metas[idx]
        view_ids = [ref_view] + srcs[:self.num_src_view]

        imgs, intrs, w2cs, near_fars, depths, masks = [], [], [], [], [], []
        for vid in view_ids:
            img = self._read_img(os.path.join(
                self.data_dir, self.spec["img_pattern"].format(scan=scan, vid=vid))) / 256.0
            intr, w2c, near_far = read_cam_file(
                os.path.join(self.data_dir, self.spec["cam_pattern"].format(scan=scan, vid=vid)),
                self.img_hw, self.num_interval, self.interval_scale, self.spec["native_hw"])
            imgs.append(img)
            intrs.append(intr)
            w2cs.append(w2c)
            near_fars.append(near_far)
            if self.spec["depth_pattern"] is not None:
                d = read_pfm(os.path.join(
                    self.data_dir,
                    self.spec["depth_pattern"].format(scan=scan, vid=vid)))[0]
                m = (d >= near_far[0]).astype(np.float32)
                if self.spec["resize_depth"]:
                    d = resize_nearest(d, self.img_hw[::-1])
                    m = resize_nearest(m, self.img_hw[::-1])
                depths.append(d)
                masks.append(m)
            else:
                depths.append(np.zeros(self.img_hw, np.float32))
                masks.append(np.ones(self.img_hw, np.float32))

        intrs, c2ws, near_fars, scale_mat, scale_factor, w2c_ref_inv = normalize_cameras(
            self.img_hw, intrs, w2cs, near_fars, self.factor)
        depths = np.stack([d * scale_factor for d in depths]).astype(np.float32)
        masks = np.stack(masks).astype(np.float32)
        imgs = np.stack(imgs).astype(np.float32)

        out = {
            "imgs": imgs, "intrs": intrs, "c2ws": c2ws,
            "scale_mat": (w2c_ref_inv @ scale_mat).astype(np.float32),
            "view_ids": np.asarray(view_ids, np.int64),
            "near_fars": near_fars,
        }

        h, w = self.img_hw
        if self.mode == "train":
            assert self.n_rays > 0
            mask0 = masks[0]
            valid_xy = np.argwhere(mask0 > 0.5)[:, ::-1].astype(np.float32)
            n_uni = self.n_rays // 4
            sel = valid_xy[self.rng.randint(0, len(valid_xy), self.n_rays - n_uni)]
            uni = np.stack([self.rng.randint(0, w, n_uni).astype(np.float32),
                            self.rng.randint(0, h, n_uni).astype(np.float32)], -1)
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
                "file_name": f"{scan}_view{ref_view}",
                "hw": np.array([h // lvl, w // lvl], np.int32),
                "masks": masks,
            })

        pyi, pxi = py.astype(np.int64), px.astype(np.int64)
        rays_o, rays_d = rays_from_pixels(px, py, intrs[0], c2ws[0])
        dref = depths[0] if self.spec["resize_depth"] else \
            resize_nearest(depths[0], self.img_hw[::-1])
        out.update({
            "pixels_x": px, "pixels_y": py,
            "rays_o": rays_o.astype(np.float32), "rays_d": rays_d.astype(np.float32),
            "near": np.array([[near_fars[0][0]]], np.float32),
            "far": np.array([[near_fars[0][1]]], np.float32),
            "color": imgs[0][pyi, pxi],
            "depth": dref[pyi, pxi],
            "mask": masks[0][pyi, pxi] if self.spec["resize_depth"] else np.ones_like(px),
            "depth_ref": dref,
            "src_idx": np.int32(1),
        })
        return out


class BMVSDataset(GenericMVSDataset):
    def __init__(self, confs, mode, rng=None):
        super().__init__(confs, mode, "BMVSDataset", rng=rng)


class TanksDataset(GenericMVSDataset):
    def __init__(self, confs, mode, rng=None):
        super().__init__(confs, mode, "TanksDataset", rng=rng)


class ETH3DDataset(GenericMVSDataset):
    def __init__(self, confs, mode, rng=None):
        super().__init__(confs, mode, "ETH3DDataset", rng=rng)
