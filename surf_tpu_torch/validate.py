"""Validation: the counterpart of ``Runner.validate``,
``render_full_image`` and ``extract_geometry`` (surf_tpu/runner.py:482-701).

Per scene: FPN features -> 4-stage cascade -> block-skipped SDF lattice
and host marching cubes -> chunked NeuS render of the validation rays.
With ``clean_mesh`` (``--clean_mesh``) and an item that has ``masks``,
the mesh is cleaned against the dilated masks and the views' frusta
(``geometry.clean_mesh``) before it is moved to the scene's frame.
Writes the mesh (``meshes/<scene>_epoch<e>.ply``) and the artifacts
``Runner.validate`` writes (surf_tpu/runner.py:653-676), under the same
names: ``val_img`` and ``val_normal`` as 8-bit PNGs, ``val_render_depth``,
``val_sdf_depth`` and ``val_auxi_depth`` as magma PNGs plus ``.npy``.
Returns PSNR, colour L1, masked depth L1, the lattice's counts and the
timings ``TIMINGS``, each read from a span (``utils.spans``); the first
rank writes the scenes' mean PSNR, colour and depth L1, ``mesh_s`` and
``render_rays_per_s`` as the JAX runner's ``val_img_avg`` scalars (as
``mesh_seconds`` and ``rays_per_sec``) under ``<base_exp_dir>/logs``.  Under
``torch.distributed`` the render chunks and the mesh lattice are shared
by the ranks of a node (``parallel.ray_shard``; surf_tpu/runner.py:429-522,
557-566).
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from .data import get_dataset
from .geometry import Mesh, clean_mesh, extract_geometry
from .io.colormap import save_depth_png
from .io.image import write_png
from .nn import surf, feature_net, implicit_surface, sdf_net
from .nn.core import materialize_weight_norm
from .nn.implicit_surface import draw_jitter, draw_probe
from .ops.feature_lookup import fuse_pyramid
from .ops.sparse import stage_features
from .parallel.distribute import node_index_and_count, process_count, process_index
from .parallel.ray_shard import (broadcast_object, is_root, padded_chunk, ray_group,
                                  shard_rows, to_host)
from .utils.spans import span
from .utils.summary import mean_scalars, save_scalars, scalar_writer

# the JAX runner's val_img_avg tags (surf_tpu/runner.py:680-700) and the
# metric each is read from
VAL_SCALARS = (("psnr", "psnr"), ("color_loss", "color_loss"),
               ("render_depth_loss", "render_depth_loss"),
               ("sdf_depth_loss", "sdf_depth_loss"), ("mesh_seconds", "mesh_s"),
               ("rays_per_sec", "render_rays_per_s"))

# a validate's timings, each from the span of its name: ``upload`` (the
# item to the card), ``build`` (``build.fpn`` and ``build.cascade``),
# ``mesh`` (``mesh.lattice``, ``mesh.fill``, ``mesh.cubes``), ``render``
# (as rays a second) and ``write`` (the mesh, its ``clean``ing, the
# artifacts and the host metrics)
TIMINGS = ("upload_s", "build_s", "mesh_s", "mesh_lattice_s", "mesh_fill_s", "mesh_cubes_s",
           "render_rays_per_s", "write_s", "clean_mesh_s")


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


class LatticeSDF:
    """pts -> SDF of the implicit surface ``isf_params``, pinned to +100
    outside the active set: one K3 launch gives the features and the
    occupancy, ``sdf_net.sdf_lattice`` the SDF (K5 on the card, its weight
    layout built at the first call).  (An object, not a function that keeps
    the layout on itself: such a function is a reference cycle, which
    would keep the stages on the card until the garbage collector ran.)"""

    def __init__(self, isf_params, isf_static, stages_ff):
        self.params = materialize_weight_norm(isf_params)["sdf_network"]
        self.static = isf_static["sdf"]
        self.stages = stages_ff
        self.layout = None

    def __call__(self, pts):
        feats, occ = stage_features(self.stages, pts)
        if pts.device.type == "cpu":
            return sdf_net.sdf_lattice(self.params, self.static, pts, feats, occ)
        if self.layout is None:
            self.layout = sdf_net.lattice_layout(self.params, self.static)
        return sdf_net.sdf_lattice(self.params, self.static, pts, feats, occ,
                                   layout=self.layout)


@torch.no_grad()
def extract_mesh(isf_params, isf_static, stages_ff, resolution, block=64, group=None,
                 stats=None):
    """Block-skipped SDF lattice and marching cubes: (verts in
    [-1, 1], tris, lattice); with a ray ``group`` the lattice's blocks are
    split across its ranks and its first rank gets the result (None on the
    others).  ``stats``: as ``extract_geometry``'s."""
    dev = stages_ff[0][1].device
    return extract_geometry(LatticeSDF(isf_params, isf_static, stages_ff), stages_ff,
                            resolution, block=block,
                            map_rows=functools.partial(shard_rows, group=group, device=dev),
                            mesh=is_root(group), stats=stats)


def render_full_image(isf_params, isf_static, ipts, stages_ff, matching, feats_ff, chunk,
                      generator, group=None):
    """The validation rays of ``ipts`` rendered in chunks of ``chunk``:
    (colour, normal in the reference camera's frame, sdf depth, render
    depth) as (h, w, ...) numpy arrays.  With a ray ``group`` the chunk is
    rounded up to a multiple of its ranks, each renders its rows of every
    chunk, and its first rank gets the image (None on the others)."""
    params = materialize_weight_norm(isf_params)
    fused = fuse_pyramid(ipts["imgs"], feats_ff) if isf_static.get("fused_pyramid") else None
    rays_o, rays_d = ipts["rays_o"], ipts["rays_d"]
    n, dev = rays_o.shape[0], rays_o.device
    near = ipts["near"].reshape(1, 1)
    far = ipts["far"].reshape(1, 1)
    chunk = padded_chunk(chunk, group)
    outs = []
    for s in range(0, n, chunk):
        m = min(chunk, n - s)
        # the chunk's random numbers, drawn whole as the one-process render
        # draws them; each rank keeps its rows
        jitter = None if generator is None else draw_jitter(isf_static, m, generator, dev)
        probe = draw_probe(generator, dev)

        def chunk_rows(rows):
            r = implicit_surface.render(
                params, isf_static, rays_o[s + rows], rays_d[s + rows], near, far,
                matching, stages_ff, feats_ff, ipts["imgs"], ipts["intrs"], ipts["c2ws"],
                1.0, fused_colors=fused, pts_random=probe,
                z_jitter=None if jitter is None else [j[rows] for j in jitter])
            normal = (r["gradients"] * r["weights"][..., None]
                      * r["inside_sphere"][..., None]).sum(1)
            return torch.cat([r["color_fine"], normal, r["sdf_depth"].reshape(-1, 1),
                              r["render_depth"].reshape(-1, 1)], dim=1)
        rows = shard_rows(chunk_rows, m, group, device=dev)
        if rows is not None:
            outs.append(to_host(rows))
    if not is_root(group):
        return None
    h, w = [int(x) for x in ipts["hw"].reshape(-1)]
    cat = torch.cat(outs).numpy()
    rot = np.linalg.inv(ipts["c2ws"][0, :3, :3].cpu().numpy())
    normal = (rot @ cat[:, 3:6].T).T.reshape(h, w, 3)
    return (cat[:, :3].reshape(h, w, 3), normal, cat[:, 6].reshape(h, w),
            cat[:, 7].reshape(h, w))


def write_artifacts(d, file_name, epoch, color, normal, sdf_depth, render_depth,
                    auxi_depth=None):
    """The validate's image artifacts under ``d`` as ``Runner.validate``
    writes them: colour and normal as 8-bit PNGs, each depth as a magma PNG
    and its ``.npy`` (``auxi_depth``, the matching field's stage-0 depth,
    where the cascade gave one)."""
    tag = f"{file_name}_epoch{epoch}"
    write_png(os.path.join(d, "val_img", tag + ".png"),
              (color * 256).clip(0, 255).astype(np.uint8))
    write_png(os.path.join(d, "val_normal", tag + ".png"),
              (normal * 128 + 128).clip(0, 255).astype(np.uint8))
    depths = {"val_render_depth": render_depth, "val_sdf_depth": sdf_depth}
    if auxi_depth is not None:
        depths["val_auxi_depth"] = auxi_depth
    for sub, depth in depths.items():
        save_depth_png(depth, os.path.join(d, sub, tag + ".png"))
        np.save(os.path.join(d, sub, tag + ".npy"), depth)


class Validator:
    def __init__(self, conf, *, device="cuda", mesh_resolution=512, seed=0,
                 base_exp_dir=None, params=None, state=None, vol_state=None,
                 clean_mesh=False, writer=None):
        """``writer``: the scalar writer (a trainer's own), else one into
        ``<base_exp_dir>/logs``."""
        self.conf = conf
        self.device = torch.device(device)
        self.mesh_resolution = mesh_resolution
        self.clean_mesh = clean_mesh
        self.val_chunk = conf.get_int("train.val_ray_chunk", default=4096)
        self.base_exp_dir = base_exp_dir or os.path.join(
            conf["general.base_exp_dir"], "torch")
        self.writer = writer or scalar_writer(os.path.join(self.base_exp_dir, "logs"))
        self.dataset = get_dataset(conf["val_dataset"], "val", seed=seed)
        self.params, self.state, self.static = surf.init(
            conf["model"], seed=seed, device=self.device)
        if params is not None:
            self.params, self.state = params, state
        # a finetune checkpoint's volumes (--load_vol): validated as they
        # are, no cascade is built
        self.vol_state = vol_state
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed + 1)
        self.last_scene = None
        # the node's ranks, which share each scene's render and lattice
        self.group = ray_group(conf)

    # -- the three phases ---------------------------------------------------
    @torch.no_grad()
    def build(self, ipts):
        with span("build.fpn"):
            features = feature_net.apply(self.params["feature_network"], ipts["imgs"])
        with span("build.cascade"):
            outputs, stages, matching, _ = surf.build_volumes(
                self.params, self.state, self.static, ipts, features)
        return outputs, stages, matching, features

    def extract_geometry(self, stages_ff, resolution, block=64, stats=None):
        return extract_mesh(self.params["implicit_surface"], self.static["implicit_surface"],
                            stages_ff, resolution, block=block, group=self.group,
                            stats=stats)

    def render_full_image(self, ipts, stages_ff, matching, feats_ff):
        return render_full_image(self.params["implicit_surface"],
                                 self.static["implicit_surface"], ipts, stages_ff, matching,
                                 feats_ff, self.val_chunk, self.generator, self.group)

    # -- the whole pass -----------------------------------------------------
    def validate(self, epoch=0):
        """Run every validation scene; returns the per-scene metric dicts.
        Under ``torch.distributed`` the scenes are split across nodes
        (scene i on node i mod nodes) and each scene's render and lattice
        across the node's ranks; the node's first rank runs marching cubes
        and the mesh cleaning and writes the artifacts, and every rank
        returns the node's metrics.  Without ray sharding
        (``train.val_ray_shard = false``) each rank takes its own
        scenes."""
        results = []
        if self.group is None:
            unit, n_units = process_index(), process_count()
        else:
            unit, n_units = node_index_and_count()
        root = is_root(self.group)
        for idx in range(len(self.dataset)):
            if idx % n_units != unit:
                continue
            inputs = self.dataset[idx]
            with span("upload") as upload:
                ipts = to_device(inputs, self.device)
                _sync(self.device)
            with span("build") as build:
                if self.vol_state is None:
                    mf_outputs, stages, matching, features = self.build(ipts)
                else:
                    vs = self.vol_state
                    mf_outputs, matching, features = {}, vs["matching_volume"], vs["features"]
                    stages = list(zip(vs["grids"], vs["volumes"]))
                _sync(self.device)
            stages_ff = stages[::-1]
            feats_ff = features[::-1]

            lattice_stats = {}
            with span("mesh") as mesh_span:
                lattice = self.extract_geometry(stages_ff, self.mesh_resolution,
                                                stats=lattice_stats)

            _sync(self.device)
            with span("render") as render:
                image = self.render_full_image(ipts, stages_ff, matching, feats_ff)
            # the last scene's device state, for inspection and kernel checks
            self.last_scene = {"ipts": ipts, "stages": stages,
                               "matching": matching, "features": features}
            if not root:
                continue
            color, normal, sdf_depth, render_depth = image
            n_rays = int(ipts["rays_o"].shape[0])
            scene, file_name, d = inputs["scene"], inputs["file_name"], self.base_exp_dir

            with span("write") as write:
                mesh, clean = self.write_mesh(inputs, *lattice[:2], epoch)
                auxi = mf_outputs["depth_stage0"].cpu().numpy() \
                    if "depth_stage0" in mf_outputs else None
                write_artifacts(d, file_name, epoch, color, normal, sdf_depth, render_depth,
                                auxi)

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
                    "active_voxels": [int(g.cvalid.sum()) for g, _ in stages],
                    "mesh_vertices": int(len(mesh.vertices)),
                    "mesh_faces": int(len(mesh.faces)),
                    "finite": bool(np.isfinite(color).all() and np.isfinite(normal).all()
                                   and np.isfinite(sdf_depth).all()
                                   and np.isfinite(render_depth).all()),
                    **lattice_stats, **clean})
            m.update({"upload_s": upload.seconds, "build_s": build.seconds,
                      "mesh_s": mesh_span.seconds,
                      "render_rays_per_s": n_rays / max(render.seconds, 1e-9),
                      "write_s": write.seconds})
            results.append(m)
            print(f"[val {scene}] " + " ".join(
                f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in m.items() if k != "scene"), flush=True)
        results = broadcast_object(results, self.group)
        save_scalars(self.writer, "val_img_avg", mean_scalars(
            [{tag: m[key] for tag, key in VAL_SCALARS if key in m} for m in results]), epoch)
        return results

    def write_mesh(self, inputs, verts, tris, epoch):
        """The scene's mesh, cleaned with ``clean_mesh`` where the item has
        masks, in the scene's frame, written as
        ``meshes/<scene>_epoch<e>.ply``.  Returns (mesh, the cleaning's
        numbers)."""
        mesh = Mesh(verts, tris)
        clean = {}
        if self.clean_mesh and "masks" in inputs:
            with span("clean") as cleaning:
                mesh = clean_mesh(mesh, np.asarray(inputs["masks"]),
                                  np.asarray(inputs["intrs"]), np.asarray(inputs["c2ws"]))
            clean = {"clean_mesh_s": cleaning.seconds,
                     "mesh_faces_before_clean": int(len(tris))}
        mesh.apply_transform(np.asarray(inputs["scale_mat"]))
        d = self.base_exp_dir
        for sub in ("meshes", "val_img", "val_normal", "val_sdf_depth",
                    "val_render_depth", "val_auxi_depth"):
            os.makedirs(os.path.join(d, sub), exist_ok=True)
        mesh.export(os.path.join(d, "meshes", f"{inputs['scene']}_epoch{epoch}.ply"))
        return mesh, clean
