"""SuRF's per-scene finetune over the plain copies beside this file: the
counterpart of surf_tpu_torch/finetune.py's ``init_volumes``, ``loss``,
``step`` and ``next_batch`` and of data/finetune.py's
``DTUDatasetFinetune``.

Departures from the program, each on purpose:
- the inputs are the arrays the scan was written from
  (``surfbench.dtu_scan.write_scan``), not its files: ``FinetuneData``
  makes of them what the loader should make of the files (the cameras
  normalised by ``scene.normalize_cameras``, the images over 256, the
  pseudo depths and points in the unit sphere), with no nearest resize
  (the scan is written at the conf's size, where the resize is the
  identity);
- every kernel is its plain version (``ops/``, ``nn/``): the storages'
  gradient comes from autograd through the plain sparse lookup, not K3b;
- Adam runs one parameter at a time (``foreach=False``), with the
  program's groups (the implicit surface at ``mlp_lr``, stage i at
  ``vol_lr[i]``) under the same ``LambdaLR`` of the raw step count;
- the random draws are the callers': a step takes the host stream and the
  card's generator in the states the program's step had, and draws from
  them in the program's order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..conf import Conf
from ..scene import normalize_cameras, rays_from_pixels
from .losses.loss import compute_loss, make_loss_config
from .nn import feature_net, implicit_surface, surf
from .nn.core import tree_leaves
from .pipeline import to_device, warmup_cosine

DEFAULT_VOL_LR = (1e-1, 1e-2, 1e-2, 1e-3)
NATIVE_HW = (1200, 1600)


class FinetuneData:
    """What ``DTUDatasetFinetune`` reads from the scan, made from the
    arrays ``write_scan`` returned; ``ft`` is the ``finetune_dataset``
    section (a dict)."""

    def __init__(self, scan, ft):
        ft = Conf(ft)
        self.img_hw = tuple(ft.get_list("img_hw"))
        self.n_rays = ft.get_int("n_rays")
        self.num_views = len(scan["view_ids"])
        h, w = self.img_hw
        intrs, near_fars = [], []
        for intr3 in scan["intrs"]:
            intr = np.eye(4, dtype=np.float32)
            intr[:3, :3] = intr3
            intr[0] *= w / NATIVE_HW[1]
            intr[1] *= h / NATIVE_HW[0]
            intrs.append(intr)
            interval = scan["interval"] * ft.get_float("interval_scale")
            near_fars.append([scan["near"], scan["near"] + interval * ft.get_int("num_interval")])
        w2cs = list(scan["w2cs"])
        (self.intrs, self.c2ws, self.near_fars, scale_mat, scale_factor,
         w2c_ref_inv) = normalize_cameras(self.img_hw, intrs, w2cs, near_fars,
                                          ft.get_float("factor"))
        self.images = np.stack([im.astype(np.float32) / 256.0
                                for im in scan["images"]]).astype(np.float32)
        self.pseudo_depths = np.stack(scan["depths"]).astype(np.float32) * scale_factor
        pw = scan["points"].astype(np.float32)
        pw = (w2cs[0] @ np.concatenate([pw, np.ones_like(pw[:, :1])], 1).T).T[:, :3]
        self.pseudo_pts = (pw - scale_mat[:3, 3]) / scale_mat[0, 0]

    def all_images(self):
        """``get_all_images``: the views for the cascade."""
        return {"imgs": self.images, "c2ws": self.c2ws, "intrs": self.intrs,
                "near": np.array([[self.near_fars[0][0]]], np.float32),
                "far": np.array([[self.near_fars[0][1]]], np.float32),
                "near_fars": self.near_fars}

    def random_rays(self, vid, rng):
        """``get_random_rays``: ``n_rays`` uniform rays of view ``vid`` and
        2048 pseudo points, drawn from ``rng``; the views in the batch's
        order, ``vid`` first."""
        h, w = self.img_hw
        px = rng.randint(0, w, self.n_rays).astype(np.float32)
        py = rng.randint(0, h, self.n_rays).astype(np.float32)
        pyi, pxi = py.astype(np.int64), px.astype(np.int64)
        rays_o, rays_d = rays_from_pixels(px, py, self.intrs[vid], self.c2ws[vid])
        order = [vid] + [v for v in range(self.num_views) if v != vid]
        sel = rng.randint(0, len(self.pseudo_pts), 2048)
        return {"rays_o": rays_o.astype(np.float32), "rays_d": rays_d.astype(np.float32),
                "near": np.array([[self.near_fars[vid][0]]], np.float32),
                "far": np.array([[self.near_fars[vid][1]]], np.float32),
                "color": self.images[vid][pyi, pxi],
                "intrs": self.intrs[order], "c2ws": self.c2ws[order],
                "view_ids": np.asarray(order, np.int64), "imgs": self.images[order],
                "near_fars": self.near_fars[order],
                "pseudo_pts": self.pseudo_pts[sel].astype(np.float32),
                "pseudo_depth": self.pseudo_depths[vid][pyi, pxi],
                "mask": np.ones(self.n_rays, np.float32)}

    def batch(self, step, perm, rng, device):
        """``next_batch``: the batch of step ``step`` on ``device`` and the
        permutation after it (redrawn from ``rng`` at the start of a
        round)."""
        if step % self.num_views == 0:
            perm = rng.permutation(self.num_views)
        vid = int(perm[step % self.num_views])
        return to_device(self.random_rays(vid, rng), device), perm


@torch.no_grad()
def init_volumes(params, state, static, data, device):
    """The one cascade over all the scene's views: {``grids``, ``volumes``
    (the stage storages), ``matching_volume``, ``features``}."""
    ipts = to_device(data.all_images(), device)
    features = feature_net.apply(params["feature_network"], ipts["imgs"])
    _, stages, matching, _ = surf.build_volumes(params, state, static, ipts, features)
    return {"grids": [g for g, _ in stages], "volumes": [s for _, s in stages],
            "matching_volume": matching, "features": list(features)}


class FinetuneStep:
    """``Finetuner.step`` over the volumes ``vol`` (``init_volumes``'
    dict; its storages become the trained leaves) and the implicit
    surface ``isf``; ``train`` is the conf's ``train`` section (a dict)."""

    def __init__(self, isf, static, vol, train):
        train = Conf(train)
        self.isf, self.static, self.vol = isf, static, vol
        self.mlp = tree_leaves(isf)
        for t in self.mlp + vol["volumes"]:
            t.requires_grad_(True)
        self.loss_cfg = make_loss_config(train["loss"])
        self.anneal_end = train.get_float("anneal_end", default=0.0)
        vol_lrs = [float(v) for v in train.get("lr_conf.vol_lr", DEFAULT_VOL_LR)]
        groups = [{"params": self.mlp, "lr": train.get_float("lr_conf.mlp_lr")}]
        groups += [{"params": [v], "lr": vol_lrs[min(i, len(vol_lrs) - 1)]}
                   for i, v in enumerate(vol["volumes"])]
        self.optimizer = torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8, foreach=False)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, warmup_cosine(train.get_int("epochs"), train.get_float("warmup"),
                                          train.get_float("alpha")))

    @property
    def leaves(self):
        """The trained leaves in the optimizer's order: the implicit
        surface's, then each stage's storage."""
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def restore(self, moments, n_steps):
        """Adam's moments (one (exp_avg, exp_avg_sq, step) or None a leaf,
        in ``leaves`` order) and the schedule after ``n_steps`` steps."""
        for t, m in zip(self.leaves, moments):
            if m is not None:
                self.optimizer.state[t] = {
                    "step": torch.tensor(float(m[2])),
                    "exp_avg": m[0].to(t.device, copy=True),
                    "exp_avg_sq": m[1].to(t.device, copy=True)}
        self.scheduler.last_epoch = n_steps
        for g, base, lam in zip(self.optimizer.param_groups, self.scheduler.base_lrs,
                                self.scheduler.lr_lambdas):
            g["lr"] = base * lam(n_steps)

    def loss(self, batch, step, generator):
        st = self.static["implicit_surface"]
        stages_ff = list(zip(self.vol["grids"], self.vol["volumes"]))[::-1]
        feats_ff = [f.index_select(0, batch["view_ids"]) for f in self.vol["features"]][::-1]
        anneal = 1.0 if self.anneal_end == 0.0 else min(1.0, step / self.anneal_end)
        out = implicit_surface.render(
            self.isf, st, batch["rays_o"], batch["rays_d"], batch["near"], batch["far"],
            self.vol["matching_volume"], stages_ff, feats_ff, batch["imgs"], batch["intrs"],
            batch["c2ws"], anneal, generator=generator, match_features=feats_ff,
            step=float(step))
        out["pseudo_sdf"] = implicit_surface.pseudo_sdf(self.isf, st, batch["pseudo_pts"],
                                                        stages_ff)
        res = compute_loss(self.loss_cfg, out, batch, float(step), "finetune")
        res["psnr"] = 20.0 * torch.log10(1.0 / torch.sqrt(torch.mean(
            (out["color_fine"] - batch["color"]) ** 2)))
        return res

    def step(self, batch, step, generator):
        """One step; returns (loss terms as floats, each leaf's gradient as
        Adam got it, in ``leaves`` order)."""
        self.optimizer.zero_grad(set_to_none=True)
        res = self.loss(batch, step, generator)
        res["loss"].backward()
        grads = [None if t.grad is None else t.grad.detach().clone() for t in self.leaves]
        self.optimizer.step()
        self.scheduler.step()
        return ({k: float(v.detach()) if torch.is_tensor(v) else float(v)
                 for k, v in res.items()}, grads)
