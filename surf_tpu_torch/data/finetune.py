"""Per-scene finetuning datasets (host numpy; counterpart of
surf_tpu/data/dtu_finetune.py:28-102, 244-268).

A fixed view set with cameras, images, masks, pseudo depths and pseudo
points cached once: ``get_all_images`` feeds the one-off volume
initialization, ``get_random_rays(vid, rng)`` yields ``n_rays`` uniform
random rays of view ``vid`` with the views rotated so that ``vid`` is
the reference (``view_ids`` says which stored view each slot is) and
2048 random pseudo points, ``get_rays_at(vid)`` a full validation grid.

``SyntheticDatasetFinetune`` exposes that surface over the procedural
synthetic scene, so the finetune path runs with no download.  The DTU
variants wait for their files and for PNG/PFM readers without ``cv2``
and ``PIL`` (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import numpy as np

from .cameras import rays_from_pixels
from .synthetic import SyntheticDataset


class _FinetuneBase:
    """Shared ray/packaging logic over cached per-view arrays.  Subclasses
    set: img_hw, n_rays, num_views, val_res_level, images (nv, h, w, 3),
    masks (nv, h, w), intrs (nv, 4, 4), c2ws (nv, 4, 4), near_fars (nv, 2),
    pseudo_depths (nv, h, w), pseudo_pts (n, 3), scale_mat, scene."""

    def _rays(self, vid, px, py):
        rays_o, rays_d = rays_from_pixels(px, py, self.intrs[vid], self.c2ws[vid])
        near = np.array([[self.near_fars[vid][0]]], np.float32)
        far = np.array([[self.near_fars[vid][1]]], np.float32)
        return rays_o.astype(np.float32), rays_d.astype(np.float32), near, far

    def _view_order(self, vid):
        return [vid] + [v for v in range(self.num_views) if v != vid]

    def get_all_images(self):
        return {
            "imgs": self.images,
            "c2ws": self.c2ws,
            "intrs": self.intrs,
            "near": np.array([[self.near_fars[0][0]]], np.float32),
            "far": np.array([[self.near_fars[0][1]]], np.float32),
            "near_fars": self.near_fars,
        }

    def get_random_rays(self, vid, rng=None):
        vid = int(vid)
        rng = rng or np.random
        h, w = self.img_hw
        px = rng.randint(0, w, self.n_rays).astype(np.float32)
        py = rng.randint(0, h, self.n_rays).astype(np.float32)
        pyi, pxi = py.astype(np.int64), px.astype(np.int64)
        rays_o, rays_d, near, far = self._rays(vid, px, py)
        order = self._view_order(vid)
        sel = rng.randint(0, len(self.pseudo_pts), 2048)
        return {
            "rays_o": rays_o, "rays_d": rays_d, "near": near, "far": far,
            "color": self.images[vid][pyi, pxi],
            "intrs": self.intrs[order], "c2ws": self.c2ws[order],
            "view_ids": np.asarray(order, np.int64),
            "imgs": self.images[order],
            "near_fars": self.near_fars[order],
            "pseudo_pts": self.pseudo_pts[sel].astype(np.float32),
            "pseudo_depth": self.pseudo_depths[vid][pyi, pxi],
            "mask": np.ones(self.n_rays, np.float32),
        }

    def get_rays_at(self, vid):
        vid = int(vid)
        h, w = self.img_hw
        lvl = self.val_res_level
        tx = np.linspace(0, w - 1, w // lvl, dtype=np.float32)
        ty = np.linspace(0, h - 1, h // lvl, dtype=np.float32)
        gx, gy = np.meshgrid(tx, ty, indexing="xy")
        px, py = gx.reshape(-1), gy.reshape(-1)
        pyi, pxi = py.astype(np.int64), px.astype(np.int64)
        rays_o, rays_d, near, far = self._rays(vid, px, py)
        order = self._view_order(vid)
        return {
            "rays_o": rays_o, "rays_d": rays_d, "near": near, "far": far,
            "color": self.images[vid][pyi, pxi],
            "intrs": self.intrs[order], "c2ws": self.c2ws[order],
            "view_ids": np.asarray(order, np.int64),
            "scale_mat": self.scale_mat,
            "scene": self.scene,
            "imgs": self.images[order],
            "masks": self.masks[order],
            "near_fars": self.near_fars[order],
            "bound_min": np.array([-1, -1, -1], np.float32),
            "bound_max": np.array([1, 1, 1], np.float32),
            "hw": np.array([h // lvl, w // lvl], np.int32),
            "file_name": f"{self.scene}_view{vid}",
            "depth_ref": self.pseudo_depths[vid],
        }


class SyntheticDatasetFinetune(_FinetuneBase):
    """Finetune surface over the procedural synthetic scene."""

    def __init__(self, confs, mode="finetune"):
        base = SyntheticDataset(confs, "val")
        s = base._build(0)
        self.img_hw = base.img_hw
        self.n_rays = confs.get_int("n_rays", default=512)
        self.num_views = s["imgs"].shape[0]
        self.val_res_level = confs.get_int("val_res_level", default=1)
        self.scene = s["scan"]
        self.images = s["imgs"]
        self.masks = s["masks"]
        self.intrs = s["intrs"]
        self.c2ws = s["c2ws"]
        self.near_fars = s["near_fars"]
        self.pseudo_depths = np.stack(s["depths"]).astype(np.float32)
        self.scale_mat = s["scale_mat"]
        rng = np.random.RandomState(0)
        sph = rng.randn(8192, 3)
        sph = sph / np.linalg.norm(sph, axis=1, keepdims=True) * base.radius_world
        pw = (s["w2c_ref"] @ np.concatenate([sph, np.ones((8192, 1))], 1).T).T[:, :3]
        sm = s["scale_mat_raw"]
        self.pseudo_pts = ((pw - sm[:3, 3]) / sm[0, 0]).astype(np.float32)


class _NotPorted:
    def __init__(self, confs, mode="finetune"):
        raise NotImplementedError(
            f"{type(self).__name__} is not ported yet: it needs the DTU files and "
            "PNG/PFM readers without cv2 and PIL (ROADMAP.md, queue 1: the DTU "
            "finetune loaders)")


class DTUDatasetFinetune(_NotPorted):
    pass


class DTUDatasetFinetuneNeuS(_NotPorted):
    pass
