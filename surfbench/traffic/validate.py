"""Traffic ``validate``: whole validates, back to back, by one caller
(a closed loop), each of an item no other validate of the run sees.

Set-up makes ``n_scenes`` scenes, each seen by its ring of ``n_views``
cameras, and from them a pool of items: each (scene, reference view)
pair once, each under its own light (an RGB gain on every image drawn
from the seed), so that no two items share an image.  Two more items,
under lights of their own, warm the program up.  The window takes the
pool in an order drawn from the seed; it would start over only after
``n_scenes * n_views`` validates, several times what a window holds.

Each validate is the program's ``Validator.validate`` on one scene: FPN
features, the 4-stage cascade, the block-skipped SDF lattice and host
marching cubes, the chunked render of the reference view at
``val_res_level``, and the mesh and image artifacts written under the
run's temporary directory (each scene overwrites its own files).

The check compares the window's last validate with the reference run on
the same item, weights and random draws: each cascade stage's active
voxels and storage, the matching volume (both downstream of the FPN
features), the lattice, the mesh's vertices against the reference
lattice's crossings, and the rendered colour, normal and depths.  Noted
beside them, not compared: the FPN features' gap and the mesh against the
program's own lattice (vertex and triangle counts), which no control
separates.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from .. import compare, harness, trace
from ..conf import to_hocon
from ..reference import mesh as ref_mesh
from ..reference import pipeline as ref
from ..scene import Scene, seed_ints

RANGES = ("surfbench.validate", "build", "mesh", "render")


def inputs(ctx):
    """The configuration's ``validate`` inputs with the workload's values
    over them."""
    return {**ctx.config["inputs"]["validate"], **ctx.workload.get("inputs", {})}


class _OneScene:
    """The validator's dataset: the one item ``item`` set before each
    validate."""

    def __init__(self):
        self.item = None

    def __len__(self):
        return 1

    def __getitem__(self, i):
        return self.item


N_WARM = 2


def make_items(ctx, inp):
    """The pool (every (scene, reference view) pair) and then the
    ``N_WARM`` warm-up items, each under its own light."""
    nv = int(inp["n_views"])
    scenes = [Scene(seed_ints(ctx.seed, 1, k)[0], inp["img_hw"], nv)
              for k in range(int(inp["n_scenes"]))]
    for sc in scenes:
        sc.render_views(range(nv), workers=4)
    pairs = [(k, r) for k in range(len(scenes)) for r in range(nv)]
    pairs += pairs[:N_WARM]
    items = []
    for i, (k, r) in enumerate(pairs):
        light = np.random.RandomState(seed_ints(ctx.seed, 7, i)[0]).uniform(0.7, 1.0, 3)
        items.append(scenes[k].item(r, inp["num_src_view"], mode="val",
                                    val_res_level=inp["val_res_level"], name=f"scene{k}",
                                    pseudo_seed=seed_ints(ctx.seed, 2, i)[0], light=light))
    return items


def program_conf(ctx, inp):
    from surf_tpu_torch.config import ConfigFactory
    return ConfigFactory.parse_string(to_hocon({
        "general": {"base_exp_dir": ctx.out_dir},
        # a stand-in the validator builds and the run replaces (_OneScene)
        "val_dataset": {"dataset_name": "SyntheticDataset", "img_hw": [16, 16],
                        "n_scenes": 1},
        "train": {**ctx.config["train"], "val_ray_chunk": int(inp["val_ray_chunk"])},
        "model": ctx.config["model"]}))


def prepare(ctx):
    """The inputs and the weights, made from the seed; returns the weights
    on the card."""
    ctx.inp = inputs(ctx)
    ctx.items = make_items(ctx, ctx.inp)
    params, state, _ = ref.init(ctx.config["model"], seed_ints(ctx.seed, 3)[0], ctx.device)
    ctx.weights = (ref.tree_to(params, "cpu"), ref.tree_to(state, "cpu"))
    return params, state


def setup(ctx):
    from surf_tpu_torch.card import set_numerics
    from surf_tpu_torch.validate import Validator
    set_numerics()
    params, state = prepare(ctx)
    inp = ctx.inp
    v = Validator(program_conf(ctx, inp), device=ctx.device,
                  mesh_resolution=int(inp["mesh_resolution"]), seed=seed_ints(ctx.seed, 4)[0],
                  base_exp_dir=ctx.out_dir, params=params, state=state)
    v.dataset = _OneScene()
    ctx.v = v
    ctx.last = {}
    lattice_fn, render_fn = v.extract_geometry, v.render_full_image

    def kept_lattice(*a, **k):
        out = lattice_fn(*a, **k)
        ctx.last["lattice"] = out
        return out

    def kept_render(*a, **k):
        ctx.last["generator"] = v.generator.get_state()
        out = render_fn(*a, **k)
        ctx.last["image"] = out
        return out
    v.extract_geometry, v.render_full_image = kept_lattice, kept_render
    ctx.results = []
    for k in range(len(ctx.items) - N_WARM, len(ctx.items)):      # warm up
        validate(ctx, k)
    ctx.results = []
    pool = len(ctx.items) - N_WARM
    ctx.order = np.random.RandomState(seed_ints(ctx.seed, 5)[0]).permutation(pool)


def validate(ctx, k):
    ctx.v.dataset.item = ctx.items[k]
    with trace.host_range("surfbench.validate"):
        res = ctx.v.validate()
    ctx.last["scene"] = k
    ctx.results += res
    return res


def next_item(ctx, i):
    return int(ctx.order[i % len(ctx.order)])


def window(ctx, seconds):
    t0 = time.time()
    while time.time() - t0 < seconds:
        validate(ctx, next_item(ctx, ctx.units))
        ctx.units += 1
    ctx.elapsed = time.time() - t0
    ctx.info["val_results"] = list(ctx.results)
    ctx.info["val_rays"] = int(np.prod(ctx.items[0]["hw"]))


def end_to_end(ctx):
    return {"val_s_per_scene": ctx.elapsed / ctx.units}


def bound_pass(ctx):
    """One validate more, of the pool's next item."""
    # the check reads the window's last validate
    last, scene = dict(ctx.last), ctx.v.last_scene
    harness.kernel_pass(ctx, lambda: validate(ctx, next_item(ctx, ctx.units)))
    ctx.last, ctx.v.last_scene = last, scene


def release(ctx):
    """The last validate's outputs, off the card; the program freed."""
    sc = ctx.v.last_scene
    ctx.got = {
        "scene": ctx.last["scene"],
        "features": [f.cpu() for f in sc["features"]],
        "stages": [(tuple(t.cpu() for t in g), s.cpu()) for g, s in sc["stages"]],
        "matching": sc["matching"].cpu(),
        "lattice": ctx.last["lattice"], "image": ctx.last["image"],
        "generator": ctx.last["generator"]}
    del ctx.v, sc
    ctx.last = {}


def _grid(t, device):
    from ..reference.ops.sparse import VoxelGrid
    return VoxelGrid(*(x.to(device) for x in t))


def check(ctx, flops=False):
    """The numbers compared, [(name, value, limit)], and with ``flops`` the
    reference validate's model FLOPs."""
    dev, got = ctx.device, ctx.got
    limits = ctx.workload.get("limits", {})
    params, state = (ref.tree_to(t, dev) for t in ctx.weights)
    static = ref.init(ctx.config["model"], 0, "cpu")[2]
    item = ctx.items[got["scene"]]
    ipts = ref.to_device(item, dev)
    counter = harness.model_flops() if flops else contextlib.nullcontext({})
    with counter as fl:
        features, stages, matching = ref.build(params, state, static, ipts)
        stages_ff, feats_ff = stages[::-1], features[::-1]
        u_ref = ref.lattice(params, static, stages_ff, int(ctx.inp["mesh_resolution"]))
        gen = torch.Generator(device=dev)
        gen.set_state(got["generator"])
        image = ref.render(params, static, ipts, stages_ff, matching, feats_ff,
                           int(ctx.inp["val_ray_chunk"]), gen)
    out = {}
    # noted, not compared: no control moves it (TF32 leaves cuDNN's FPN
    # convolutions at these channel counts as they are)
    ctx.info["features_gap"] = max(compare.rel_gap(g.to(dev), r)
                                   for g, r in zip(got["features"], features))
    gaps = [compare.stage_gaps((_grid(g, dev), s.to(dev)), r)
            for (g, s), r in zip(got["stages"], stages)]
    out["active_voxels_gap"] = max(a for a, _ in gaps)
    out["storage_gap"] = max(b for _, b in gaps)
    out["matching_gap"] = compare.rel_gap(got["matching"].to(dev), matching)
    del features, stages, matching, stages_ff, feats_ff

    verts, tris, u = got["lattice"]
    both = (u < 100.0) & (u_ref < 100.0)
    out["lattice_gap"] = float(np.abs(u[both] - u_ref[both]).max()) if both.any() else 0.0
    out["lattice_occupancy_gap"] = float(((u < 100.0) != (u_ref < 100.0)).mean())
    R = u.shape[0]
    q = (verts + 1.0) * 0.5 * (R - 1.0)
    out["mesh_vertex_gap"], out["mesh_vertex_shift"] = ref_mesh.match(
        q, *ref_mesh.crossings(u_ref), R)
    k_own, p_own = ref_mesh.crossings(u)
    own_gap, _ = ref_mesh.match(q, k_own, p_own, R)
    # noted, not compared: it holds marching cubes to the case table of
    # csrc/marching_cubes.cpp, which another valid meshing need not share,
    # and no control moves it
    ctx.info["mesh_own_lattice_gap"] = float(
        abs(len(verts) - len(k_own)) + abs(len(tris) - ref_mesh.n_triangles(u))
        + own_gap * len(k_own))
    del u_ref

    color, normal, sdf_depth, render_depth = got["image"]
    r_color, r_normal, r_sdf, r_render = image
    out["color_gap"] = compare.abs_gap(color, r_color)
    out["normal_gap"] = compare.abs_gap(normal, r_normal)
    out["depth_gap"] = max(compare.abs_gap(sdf_depth, r_sdf),
                           compare.abs_gap(render_depth, r_render))
    if not compare.finite(color, normal, sdf_depth, render_depth):
        out["color_gap"] = float("inf")
    compared = [(k, float(v), float(limits.get(k, float("nan")))) for k, v in out.items()]
    return compared, (fl["total"] if flops else None)


def control(ctx):
    """The control's outputs in the program's place: the reference, on the
    inputs and weights ``prepare`` made, with TF32 on (the precision below
    the configuration's full f32), scene 0, the render's draws from a
    generator seeded from the seed."""
    dev = ctx.device
    params, state = (ref.tree_to(t, dev) for t in ctx.weights)
    static = ref.init(ctx.config["model"], 0, "cpu")[2]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed_ints(ctx.seed, 4)[0])
    state0 = gen.get_state()
    ipts = ref.to_device(ctx.items[0], dev)
    with tf32():
        features, stages, matching = ref.build(params, state, static, ipts)
        stages_ff, feats_ff = stages[::-1], features[::-1]
        u = ref.lattice(params, static, stages_ff, int(ctx.inp["mesh_resolution"]))
        image = ref.render(params, static, ipts, stages_ff, matching, feats_ff,
                           int(ctx.inp["val_ray_chunk"]), gen)
    R = u.shape[0]
    _, pts = ref_mesh.crossings(u)
    ctx.got = {"scene": 0, "features": [f.cpu() for f in features],
               "stages": [(tuple(t.cpu() for t in g), s.cpu()) for g, s in stages],
               "matching": matching.cpu(),
               "lattice": (pts / (R - 1.0) * 2.0 - 1.0,
                           np.zeros((ref_mesh.n_triangles(u), 3), np.int64), u),
               "image": image, "generator": state0}


class tf32:
    """TF32 on for matmuls and cuDNN inside the block."""

    def __enter__(self):
        self.old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True

    def __exit__(self, *a):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.old
        return False
