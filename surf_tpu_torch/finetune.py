"""Per-scene finetune: the counterpart of ``Runner._init_volumes``,
``_finetune_step_fn``, ``finetune``, ``save_finetune`` and
``validate_finetune`` (surf_tpu/runner.py:706-882).

From a trained model (``--resume``), one no-grad cascade over all views
of the scene builds the stage storages, the voxel grids, the dense
matching volume and the FPN features (``init_volumes``).  From then on
only the implicit surface and the stage storages are trained: the
storages are leaves, and their whole gradient is the kernel K3b.  Each
step (``next_batch``, then ``step``) renders ``n_rays`` random rays of one
view (the views in a seeded permutation, redrawn each round), with the
features of the batch's view order as both the colour features and the
patch features, adds |SDF| at 2048 pseudo points, and takes the
``finetune`` loss (no photometric and matching-field depth terms).  The
optimizer is Adam with one group for the implicit surface at ``mlp_lr``
and one per stage at ``vol_lr[i]``, under a ``LambdaLR`` of
``warmup_cosine`` of the raw step count.

A step runs in the spans ``finetune.rays`` (the host's draw and upload),
``finetune.render``, ``finetune.loss`` and ``finetune.update`` (Adam and
the schedule).  While a profiler runs, each step also counts
``storage_grad_rows``: for each stage, [rows whose gradient is not all
zero, rows of the storage] (None while no profiler runs, so that an
untraced step launches nothing more and does not wait on the card).

Every ``log_freq`` steps the loss terms and PSNR go to TensorBoard as
``finetune/<term>`` at the step under ``<base_exp_dir>/logs``
(``utils.summary``), as the JAX runner writes them; ``train.debug_nans``
checks the terms as the trainer does.

Checkpoints hold the volumes and the implicit surface only
(``model_<step>.ckpt.npz``, the JAX package's layout); ``--load_vol``
resumes from one without rebuilding the cascade.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .data import get_dataset
from .geometry import Mesh
from .losses import compute_loss, make_loss_config
from .nn import surf, feature_net, implicit_surface
from .nn.core import tree_leaves
from .train import anomaly_mode, check_finite
from .utils import (resume_from, save_checkpoint, to_numpy_tree, vol_state_tree,
                    warmup_cosine)
from .utils.spans import recording, span
from .utils.summary import save_scalars, scalar_writer
from .validate import _sync, extract_mesh, render_full_image, to_device

DEFAULT_VOL_LR = (1e-1, 1e-2, 1e-2, 1e-3)


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_detached(v) for v in tree]
    return tree.detach()


class Finetuner:
    def __init__(self, conf, *, device="cuda", seed=0, base_exp_dir=None, scene=None,
                 ref_view=None, resume=None, load_vol=False, mesh_resolution=512,
                 params=None, state=None):
        """``resume``: a model checkpoint (``--resume``), or with
        ``load_vol`` a finetune checkpoint; else ``params`` / ``state``, or
        the seeded init.  The experiment directory is
        ``<base_exp_dir>/<scene>/view<ref_view>``."""
        self.conf = conf
        self.device = torch.device(device)
        ft_conf = conf["finetune_dataset"]
        scene = scene or ft_conf["scene"]
        ref_view = ref_view if ref_view is not None else ft_conf["ref_view"]
        ft_conf["scene"], ft_conf["ref_view"] = scene, ref_view
        self.base_exp_dir = os.path.join(
            base_exp_dir or os.path.join(conf["general.base_exp_dir"], "torch"),
            str(scene), f"view{ref_view}")
        self.writer = scalar_writer(os.path.join(self.base_exp_dir, "logs"))
        self.epochs = conf.get_int("train.epochs")
        self.debug_nans = conf.get_bool("train.debug_nans", default=False)
        self.log_freq = conf.get_float("train.log_freq", default=1.0)
        self.save_freq = conf.get_float("train.save_freq")
        self.val_freq = conf.get_float("train.val_freq")
        self.anneal_end = conf.get_float("train.anneal_end", default=0.0)
        self.val_before = conf.get_bool("train.val_before_finetune", default=False)
        self.val_chunk = conf.get_int("train.val_ray_chunk", default=4096)
        self.mesh_resolution = mesh_resolution
        self.dataset = get_dataset(ft_conf, "finetune")
        self.params, self.state, self.static = surf.init(
            conf["model"], seed=seed, device=self.device)
        if params is not None:
            self.params, self.state = params, state
        self.vol_state = None
        if resume is not None:
            self.params, self.state, self.vol_state = resume_from(
                resume, self.params, self.state, load_vol=load_vol, device=self.device)
        self.loss_cfg = make_loss_config(conf["train.loss"])
        self.lr_scale = warmup_cosine(self.epochs, conf.get_float("train.warmup"),
                                      conf.get_float("train.alpha"))
        # one host stream draws the view permutation and the rays, as the
        # JAX runner's host_rng does; the render's z jitter is the card's
        self.host_rng = np.random.RandomState(seed)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed + 1)
        self.perm = None                # the views' order this round
        self.storage_grad_rows = None
        self.init_volumes()

    def cos_anneal_ratio(self, step):
        return 1.0 if self.anneal_end == 0.0 else min(1.0, step / self.anneal_end)

    def init_volumes(self):
        """One no-grad cascade over all views -> the trainable stage
        storages (skipped when ``--load_vol`` restored them), then the
        optimizer over the implicit surface and the storages."""
        if self.vol_state is None:
            ipts = to_device(self.dataset.get_all_images(), self.device)
            with torch.no_grad():
                features = feature_net.apply(self.params["feature_network"], ipts["imgs"])
                _, stages, matching, _ = surf.build_volumes(
                    self.params, self.state, self.static, ipts, features)
            self.vol_state = {"volumes": [s for _, s in stages],
                              "grids": [g for g, _ in stages],
                              "matching_volume": matching, "features": list(features)}
        vs = self.vol_state
        vs["volumes"] = [v.detach().requires_grad_(True) for v in vs["volumes"]]
        vs["matching_volume"] = vs["matching_volume"].detach()
        vs["features"] = [f.detach() for f in vs["features"]]
        mlp = tree_leaves(self.params["implicit_surface"])
        for t in mlp:
            t.requires_grad_(True)
        lr = self.conf["train.lr_conf"]
        vol_lrs = [float(v) for v in lr.get("vol_lr", DEFAULT_VOL_LR)]
        groups = [{"params": mlp, "lr": float(lr["mlp_lr"]), "name": "mlp"}]
        groups += [{"params": [v], "lr": vol_lrs[min(i, len(vol_lrs) - 1)], "name": f"vol{i}"}
                   for i, v in enumerate(vs["volumes"])]
        self.optimizer = torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8)
        # the raw step count, read before its increment (optax's count)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(self.optimizer, self.lr_scale)

    def stages_ff(self):
        """[(VoxelGrid, storage)] fine-to-coarse, the storages the leaves."""
        vs = self.vol_state
        return list(zip(vs["grids"], vs["volumes"]))[::-1]

    def loss(self, batch, step, *, pts_random=None):
        """Render, pseudo-point SDF and the ``finetune`` loss terms of one
        batch (tensors on the device), with PSNR."""
        isf, st = self.params["implicit_surface"], self.static["implicit_surface"]
        stages_ff = self.stages_ff()
        feats_ff = [f.index_select(0, batch["view_ids"])
                    for f in self.vol_state["features"]][::-1]
        with span("finetune.render"):
            out = implicit_surface.render(
                isf, st, batch["rays_o"], batch["rays_d"], batch["near"], batch["far"],
                self.vol_state["matching_volume"], stages_ff, feats_ff, batch["imgs"],
                batch["intrs"], batch["c2ws"], self.cos_anneal_ratio(step),
                generator=self.generator, match_features=feats_ff, step=float(step),
                pts_random=pts_random)
            if "pseudo_pts" in batch:
                out["pseudo_sdf"] = implicit_surface.pseudo_sdf(isf, st, batch["pseudo_pts"],
                                                                stages_ff)
        with span("finetune.loss"):
            res = compute_loss(self.loss_cfg, out, batch, float(step), "finetune")
            res["psnr"] = 20.0 * torch.log10(1.0 / torch.sqrt(torch.mean(
                (out["color_fine"] - batch["color"]) ** 2)))
        if self.debug_nans:
            check_finite(res, f"finetune step {step}")
        return res

    def update(self):
        """One Adam step of every group at the scheduled LRs, then the
        schedule moves on."""
        with span("finetune.update"):
            self.optimizer.step()
            self.scheduler.step()

    def next_batch(self, step):
        """The batch of step ``step`` on the device: ``n_rays`` random rays
        of the permutation's view for the step and 2048 pseudo points, drawn
        from the host stream; the permutation is redrawn at the start of
        each round of the views.  Steps are drawn in order from 0."""
        with span("finetune.rays"):
            n = self.dataset.num_views
            if step % n == 0:
                self.perm = self.host_rng.permutation(n)
            vid = int(self.perm[step % n])
            return to_device(self.dataset.get_random_rays(vid, rng=self.host_rng), self.device)

    def _grad_rows(self):
        """[[rows whose gradient is not all zero, rows], ...] of each stage's
        storage, coarse to fine."""
        vols = self.vol_state["volumes"]
        touched = torch.stack([v.grad.ne(0).any(dim=1).sum() for v in vols]).tolist()
        return [[t, v.shape[0]] for t, v in zip(touched, vols)]

    def step(self, batch, step):
        """One finetune step; returns the loss terms as floats."""
        self.optimizer.zero_grad(set_to_none=True)
        res = self.loss(batch, step)
        res["loss"].backward()
        self.storage_grad_rows = self._grad_rows() if recording() else None
        self.update()
        return {k: float(v.detach()) if torch.is_tensor(v) else float(v)
                for k, v in res.items()}

    def finetune(self):
        with anomaly_mode(self.debug_nans):
            self._finetune()

    def _finetune(self):
        if self.val_before:
            self.validate_finetune(-1)
        t0 = time.time()
        for step in range(self.epochs):
            res = self.step(self.next_batch(step), step)
            if (step + 1) % max(int(self.log_freq), 1) == 0:
                save_scalars(self.writer, "finetune", res, step)
                print(f"[ft {step}] loss {res['loss']:.4f} psnr {res['psnr']:.2f} "
                      f"({(time.time() - t0) / (step + 1):.2f}s/it)", flush=True)
            if (step + 1) % self.save_freq == 0 or step + 1 >= self.epochs:
                self.save_finetune(step)
            if (step + 1) % self.val_freq == 0 or step + 1 >= self.epochs:
                self.validate_finetune(step)

    def save_finetune(self, step):
        """The volume-only checkpoint ``checkpoints/model_<step>.ckpt.npz``;
        returns its path."""
        path = os.path.join(self.base_exp_dir, "checkpoints", f"model_{step:0>3}.ckpt.npz")
        save_checkpoint(path, {"epoch": step, "model": {
            "vol_state": vol_state_tree(self.vol_state),
            "implicit_surface": to_numpy_tree(self.params["implicit_surface"])}})
        return path

    @torch.no_grad()
    def validate_finetune(self, step):
        """Mesh (``meshes/<scene>_step<step>.ply``, in the scene's frame) and
        full render of view 0 with the finetuned surface and volumes;
        returns PSNR, the timings and the mesh size."""
        raw = self.dataset.get_rays_at(0)
        ipts = to_device(raw, self.device)
        isf = _detached(self.params["implicit_surface"])
        st = self.static["implicit_surface"]
        stages_ff = [(g, v.detach()) for g, v in self.stages_ff()]
        feats_ff = [f.index_select(0, ipts["view_ids"])
                    for f in self.vol_state["features"]][::-1]
        _sync(self.device)
        with span("mesh") as mesh_span:
            verts, tris, _ = extract_mesh(isf, st, stages_ff, self.mesh_resolution)
        mesh_s = mesh_span.seconds
        mesh = Mesh(verts, tris).apply_transform(np.asarray(raw["scale_mat"]))
        os.makedirs(os.path.join(self.base_exp_dir, "meshes"), exist_ok=True)
        mesh.export(os.path.join(self.base_exp_dir, "meshes", f"{raw['scene']}_step{step}.ply"))
        _sync(self.device)
        with span("render") as render:
            color, normal, sdf_depth, render_depth = render_full_image(
                isf, st, ipts, stages_ff, self.vol_state["matching_volume"], feats_ff,
                self.val_chunk, self.generator)
        mse = float(((color.reshape(-1, 3) - raw["color"]) ** 2).mean())
        m = {"psnr": 20.0 * np.log10(1.0 / max(np.sqrt(mse), 1e-10)), "mesh_s": mesh_s,
             "render_rays_per_s": len(raw["rays_o"]) / max(render.seconds, 1e-9),
             "mesh_vertices": int(len(verts)), "mesh_faces": int(len(tris)),
             "finite": bool(all(np.isfinite(a).all()
                                for a in (color, normal, sdf_depth, render_depth)))}
        print(f"[ft-val step {step}] psnr {m['psnr']:.3f} mesh_s {mesh_s:.3f} "
              f"render_rays_per_s {m['render_rays_per_s']:.1f}", flush=True)
        return m
