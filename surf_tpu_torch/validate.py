"""Validation: the counterpart of ``Runner.validate``,
``render_full_image`` and ``extract_geometry`` (surf_tpu/runner.py:482-701).

Per scene: FPN features -> 4-stage cascade -> block-skipped SDF lattice
and host marching cubes -> chunked NeuS render of the validation rays.
Writes the mesh (``meshes/<scene>_epoch<e>.ply``, in the scene's frame),
``val_render_depth`` / ``val_sdf_depth`` / ``val_auxi_depth`` / ``val_img``
/ ``val_normal`` as ``.npy``, and returns PSNR, colour L1, masked depth
L1 and the timings ``build_s``, ``mesh_s`` and ``render_rays_per_s``.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
from torch.profiler import record_function

from .data import get_dataset
from .geometry import Mesh, extract_geometry
from .nn import surf, feature_net, implicit_surface, sdf_net
from .nn.core import materialize_weight_norm
from .ops.feature_lookup import fuse_pyramid


def to_device(inputs, device):
    """numpy batch -> tensors on ``device`` (strings dropped; f64 -> f32)."""
    out = {}
    for k, v in inputs.items():
        if isinstance(v, str):
            continue
        a = np.asarray(v)
        t = torch.as_tensor(a.astype(np.float32) if a.dtype == np.float64 else a)
        out[k] = t.to(device)
    return out


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Validator:
    def __init__(self, conf, *, device="cuda", mesh_resolution=512, seed=0,
                 base_exp_dir=None, params=None, state=None):
        self.conf = conf
        self.device = torch.device(device)
        self.mesh_resolution = mesh_resolution
        self.val_chunk = conf.get_int("train.val_ray_chunk", default=4096)
        self.base_exp_dir = base_exp_dir or os.path.join(
            conf["general.base_exp_dir"], "torch")
        self.dataset = get_dataset(conf["val_dataset"], "val")
        self.params, self.state, self.static = surf.init(
            conf["model"], seed=seed, device=self.device)
        if params is not None:
            self.params, self.state = params, state
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed + 1)
        self.last_scene = None

    # -- the three phases ---------------------------------------------------
    @torch.no_grad()
    def build(self, ipts):
        features = feature_net.apply(self.params["feature_network"], ipts["imgs"])
        outputs, stages, matching, _ = surf.build_volumes(
            self.params, self.state, self.static, ipts, features)
        return outputs, stages, matching, features

    def sdf_lattice_fn(self, stages_ff):
        """pts -> SDF, pinned to +100 outside the active set (one K3
        launch gives both)."""
        p = materialize_weight_norm(self.params["implicit_surface"])["sdf_network"]
        st = self.static["implicit_surface"]["sdf"]

        def fn(pts):
            out, occ = sdf_net.apply_occ(p, st, pts, stages_ff)
            return torch.where(occ, out[:, 0], torch.full_like(out[:, 0], 100.0))
        return fn

    @torch.no_grad()
    def extract_geometry(self, stages_ff, resolution, block=64):
        return extract_geometry(self.sdf_lattice_fn(stages_ff), stages_ff,
                                resolution, block=block)

    def render_full_image(self, ipts, stages_ff, matching, feats_ff):
        params = materialize_weight_norm(self.params["implicit_surface"])
        isf = self.static["implicit_surface"]
        fused = fuse_pyramid(ipts["imgs"], feats_ff) if isf.get("fused_pyramid") else None
        rays_o, rays_d = ipts["rays_o"], ipts["rays_d"]
        n = rays_o.shape[0]
        near = ipts["near"].reshape(1, 1)
        far = ipts["far"].reshape(1, 1)
        outs = {"color": [], "normal": [], "sdf_depth": [], "render_depth": []}
        for s in range(0, n, self.val_chunk):
            sl = slice(s, s + self.val_chunk)
            r = implicit_surface.render(
                params, isf, rays_o[sl], rays_d[sl], near, far, matching,
                stages_ff, feats_ff, ipts["imgs"], ipts["intrs"], ipts["c2ws"],
                1.0, fused_colors=fused, generator=self.generator)
            outs["color"].append(r["color_fine"])
            outs["normal"].append((r["gradients"] * r["weights"][..., None]
                                   * r["inside_sphere"][..., None]).sum(1))
            outs["sdf_depth"].append(r["sdf_depth"])
            outs["render_depth"].append(r["render_depth"])
        h, w = [int(x) for x in ipts["hw"].reshape(-1)]
        cat = {k: torch.cat(v).cpu().numpy() for k, v in outs.items()}
        rot = np.linalg.inv(ipts["c2ws"][0, :3, :3].cpu().numpy())
        normal = (rot @ cat["normal"].T).T.reshape(h, w, 3)
        return (cat["color"].reshape(h, w, 3), normal,
                cat["sdf_depth"].reshape(h, w), cat["render_depth"].reshape(h, w))

    # -- the whole pass -----------------------------------------------------
    def validate(self, epoch=0):
        """Run every validation scene; returns the per-scene metric dicts."""
        results = []
        for idx in range(len(self.dataset)):
            inputs = self.dataset[idx]
            ipts = to_device(inputs, self.device)
            _sync(self.device)
            t0 = time.time()
            with record_function("build"):
                mf_outputs, stages, matching, features = self.build(ipts)
                _sync(self.device)
            build_s = time.time() - t0
            stages_ff = stages[::-1]
            feats_ff = features[::-1]

            t0 = time.time()
            with record_function("mesh"):
                verts, tris, _ = self.extract_geometry(stages_ff, self.mesh_resolution)
            mesh_s = time.time() - t0
            mesh = Mesh(verts, tris).apply_transform(np.asarray(inputs["scale_mat"]))
            scene, file_name = inputs["scene"], inputs["file_name"]
            d = self.base_exp_dir
            for sub in ("meshes", "val_img", "val_normal", "val_sdf_depth",
                        "val_render_depth", "val_auxi_depth"):
                os.makedirs(os.path.join(d, sub), exist_ok=True)
            mesh.export(os.path.join(d, "meshes", f"{scene}_epoch{epoch}.ply"))

            _sync(self.device)
            t0 = time.time()
            with record_function("render"):
                color, normal, sdf_depth, render_depth = self.render_full_image(
                    ipts, stages_ff, matching, feats_ff)
            render_s = time.time() - t0
            n_rays = int(ipts["rays_o"].shape[0])

            tag = f"{file_name}_epoch{epoch}.npy"
            np.save(os.path.join(d, "val_img", tag), color)
            np.save(os.path.join(d, "val_normal", tag), normal)
            np.save(os.path.join(d, "val_render_depth", tag), render_depth)
            np.save(os.path.join(d, "val_sdf_depth", tag), sdf_depth)
            np.save(os.path.join(d, "val_auxi_depth", tag),
                    mf_outputs["depth_stage0"].cpu().numpy())

            gt = np.asarray(inputs["color"])
            mse = float(((color.reshape(-1, 3) - gt) ** 2).mean())
            m = {"scene": scene,
                 "psnr": 20.0 * np.log10(1.0 / max(np.sqrt(mse), 1e-10)),
                 "color_loss": float(np.abs(color.reshape(-1, 3) - gt).mean())}
            if "depth_ref" in inputs:
                depth_ref = np.asarray(inputs["depth_ref"])
                skip = max(depth_ref.shape[0] // render_depth.shape[0], 1)
                depth_ref = depth_ref[::skip, ::skip][:render_depth.shape[0],
                                                      :render_depth.shape[1]]
                mk = depth_ref > 0
                m["render_depth_loss"] = float(
                    (np.abs(render_depth - depth_ref) * mk).sum() / (mk.sum() + 1e-8))
                msdf = mk * (sdf_depth > 0)
                m["sdf_depth_loss"] = float(
                    (np.abs(sdf_depth - depth_ref) * msdf).sum() / (msdf.sum() + 1e-8))
            m.update({
                "build_s": build_s, "mesh_s": mesh_s,
                "render_rays_per_s": n_rays / max(render_s, 1e-9),
                "active_voxels": [int(g.cvalid.sum()) for g, _ in stages],
                "mesh_vertices": int(len(verts)), "mesh_faces": int(len(tris)),
                "finite": bool(np.isfinite(color).all() and np.isfinite(normal).all()
                               and np.isfinite(sdf_depth).all()
                               and np.isfinite(render_depth).all()),
            })
            results.append(m)
            # the last scene's device state, for inspection and kernel checks
            self.last_scene = {"ipts": ipts, "stages": stages,
                               "matching": matching, "features": features}
            print(f"[val {scene}] " + " ".join(
                f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in m.items() if k != "scene"), flush=True)
        return results
