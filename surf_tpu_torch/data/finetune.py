"""Per-scene finetuning datasets (host numpy; counterpart of
surf_tpu/data/dtu_finetune.py:28-102, 244-268).

A fixed view set with cameras, images, masks, pseudo depths and pseudo
points cached once: ``get_all_images`` feeds the one-off volume
initialization, ``get_random_rays(vid, rng)`` yields ``n_rays`` uniform
random rays of view ``vid`` with the views rotated so that ``vid`` is
the reference (``view_ids`` says which stored view each slot is) and
2048 random pseudo points, ``get_rays_at(vid)`` a full validation grid.

``SyntheticDatasetFinetune`` exposes that surface over the procedural
synthetic scene, so the finetune path runs with no download.
``DTUDatasetFinetune`` (surf_tpu/data/dtu_finetune.py:105-184) reads a
DTU scene: the reference view and its two best pair sources, CasMVSNet
cameras, light-3 images, masks, the filtered pseudo depths and the pseudo
point cloud; ``DTUDatasetFinetuneNeuS`` (:186-242) the NeuS-preprocessed
layout (``cameras_sphere.npz``, ``image/``, ``mask/``).  Both read PNGs and
PFMs through the port's own ``io`` package.
"""

from __future__ import annotations

import os

import numpy as np

from ..io.image import read_png, resize_nearest
from ..io.pfm import read_pfm
from ..io.ply import read_ply
from .cameras import (read_cam_file, load_K_Rt_from_P, normalize_cameras,
                      rays_from_pixels, near_far_from_campos)
from .dtu import read_pairs
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


class DTUDatasetFinetune(_FinetuneBase):
    def __init__(self, confs, mode="finetune"):
        self.mode = mode
        self.data_dir = confs["data_dir"]
        self.interval_scale = confs.get_float("interval_scale")
        self.num_interval = confs.get_int("num_interval")
        self.img_hw = tuple(confs.get_list("img_hw"))
        self.n_rays = confs.get_int("n_rays")
        self.factor = confs.get_float("factor")
        self.num_views = 3
        self.scene = confs.get_string("scene")
        self.ref_view = int(confs.get_int("ref_view"))
        self.val_res_level = confs.get_int("val_res_level", default=1)

        pairs = read_pairs(self.data_dir)
        self.all_views = [self.ref_view] + list(pairs[self.ref_view])[:self.num_views - 1]
        print("finetune views:", self.all_views)

        intrs, w2cs, near_fars = [], [], []
        for vid in self.all_views:
            intr, w2c, nf = read_cam_file(
                os.path.join(self.data_dir, f"Cameras/{vid:0>8}_cam.txt"),
                self.img_hw, self.num_interval, self.interval_scale)
            intrs.append(intr)
            w2cs.append(w2c)
            near_fars.append(nf)
        w2c_ref = w2cs[0]
        (self.intrs, self.c2ws, self.near_fars, scale_mat, self.scale_factor,
         w2c_ref_inv) = normalize_cameras(self.img_hw, intrs, w2cs, near_fars, self.factor)

        def load_img(path):
            return resize_nearest(read_png(path).astype(np.float32), self.img_hw[::-1])

        self.images = np.stack([
            load_img(os.path.join(
                self.data_dir,
                f"Rectified_raw/{self.scene}/rect_{vid + 1:0>3}_3_r5000.png")) / 256.0
            for vid in self.all_views]).astype(np.float32)
        self.masks = np.stack([
            (load_img(os.path.join(
                self.data_dir,
                f"Depths_raw/{self.scene}/depth_visual_{vid:0>4}.png")) > 10)
            for vid in self.all_views]).astype(np.float32)
        self.pseudo_depths = np.stack([
            resize_nearest(read_pfm(os.path.join(
                self.data_dir,
                f"PseudoMVSScore/dtu_exp/{self.scene}/filtered_avg_depth/{vid:0>8}.pfm"))[0],
                self.img_hw[::-1])
            for vid in self.all_views]).astype(np.float32) * self.scale_factor

        ply = read_ply(os.path.join(
            self.data_dir, f"PseudoMVSDepth/mvsnet{int(self.scene[4:]):0>3}_l3.ply"))
        pw = ply["vertices"].astype(np.float32)
        pw = (w2c_ref @ np.concatenate([pw, np.ones_like(pw[:, :1])], 1).T).T[:, :3]
        self.pseudo_pts = (pw - scale_mat[:3, 3]) / scale_mat[0, 0]
        self.scale_mat = (w2c_ref_inv @ scale_mat).astype(np.float32)


class DTUDatasetFinetuneNeuS(_FinetuneBase):
    """Finetune variant using NeuS-preprocessed DTU (cameras_sphere.npz with
    world_mat_i/scale_mat_i, image/{vid:06d}.png + mask/{vid:03d}.png) —
    reference: datasets/dtu_finetune_neus.py:75-140."""

    def __init__(self, confs, mode="finetune"):
        self.mode = mode
        self.data_dir = confs["data_dir"]
        self.img_hw = tuple(confs.get_list("img_hw"))
        self.n_rays = confs.get_int("n_rays")
        self.num_views = 3
        self.scene = confs.get_string("scene")
        self.ref_view = int(confs.get_int("ref_view"))
        self.val_res_level = confs.get_int("val_res_level", default=1)

        pairs = read_pairs(self.data_dir)
        self.all_views = [self.ref_view] + list(pairs[self.ref_view])[:self.num_views - 1]

        cams = np.load(os.path.join(
            self.data_dir, f"neus_data/data_DTU/dtu_{self.scene}/cameras_sphere.npz"))
        intrs, c2ws, nfs = [], [], []
        for vid in self.all_views:
            P = (cams[f"world_mat_{vid}"] @ cams[f"scale_mat_{vid}"])[:3, :4]
            ni, c2w = load_K_Rt_from_P(P)
            intrs.append(ni)
            c2ws.append(c2w)
            nfs.append(near_far_from_campos(c2w))
        self.intrs = np.stack(intrs).astype(np.float32)
        self.c2ws = np.stack(c2ws).astype(np.float32)
        self.near_fars = np.stack(nfs).astype(np.float32)
        self.scale_mat = cams[f"scale_mat_{self.all_views[0]}"].astype(np.float32)
        self.scale_factor = 1.0 / self.scale_mat[0, 0]

        def load_img(path):
            return resize_nearest(read_png(path).astype(np.float32), self.img_hw[::-1])

        base = os.path.join(self.data_dir, f"neus_data/data_DTU/dtu_{self.scene}")
        self.images = np.stack([
            load_img(os.path.join(base, f"image/{vid:0>6}.png")) / 256.0
            for vid in self.all_views]).astype(np.float32)
        masks = [load_img(os.path.join(base, f"mask/{vid:0>3}.png")) > 10
                 for vid in self.all_views]
        # an RGB mask keeps its first channel, an L mask is (h, w) already
        self.masks = np.stack([m[..., 0] if m.ndim == 3 else m
                               for m in masks]).astype(np.float32)
        self.pseudo_depths = np.stack([
            resize_nearest(read_pfm(os.path.join(
                self.data_dir,
                f"PseudoMVSScore/dtu_exp/{self.scene}/filtered_avg_depth/{vid:0>8}.pfm"))[0],
                self.img_hw[::-1])
            for vid in self.all_views]).astype(np.float32) * self.scale_factor
        ply = read_ply(os.path.join(
            self.data_dir, f"PseudoMVSDepth/mvsnet{int(self.scene[4:]):0>3}_l3.ply"))
        pw = ply["vertices"].astype(np.float32)
        self.pseudo_pts = ((pw - self.scale_mat[:3, 3]) / self.scale_mat[0, 0]).astype(np.float32)
