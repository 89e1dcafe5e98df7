"""SuRF composite model: FPN features -> sparse volume cascade -> NeuS
render (torch counterpart of surf_tpu/nn/surf.py).

``build_volumes`` runs the cascade: per stage it (1) upsamples and
depth-filters the voxel set (stage 0 is the dense base grid), (2)
back-projects the multi-scale features with view attention, (3)
regularizes with the sparse U-Net, (4) scatters channel 0 into the dense
matching volume (seeded by the upsampled previous one, in
``volume.matching_dtype``) and keeps channels 1: as the stage's feature
storage, (5) renders per-view matching-field depths that drive the next
stage's sparsification.  Steps (2)-(5) are the differentiable body of a
stage (``_stage_compute``); (1) is integer geometry and runs outside the
graph.  ``forward(..., "train")`` adds the render over the batch's rays
and the pseudo-point SDF, as the training loss reads them.

The frozen ``match_feature_network`` copy in the state feeds the NCC
patch features from step 2 on; ``refresh_match_features`` snapshots the
live feature network into it (the trainer does so on even epochs).
"""

from __future__ import annotations

import torch

from . import feature_net, reg_net, matching_field, implicit_surface
from . import volume as volume_mod
from ..ops import sparse as sp
from ..utils.spans import span


def init(conf, *, seed=0, device=None):
    """Seeded init reproducing the JAX package's distributions.  Returns
    (params, state, static) in the JAX pytree layout."""
    gen = torch.Generator(device=device or "cpu")
    gen.manual_seed(seed)
    range_ratios = conf.get_list("range_ratios")
    num_stage = len(range_ratios)
    fn_params = feature_net.init(gen, conf["feature_network"], device)
    vol_params = volume_mod.init(gen, conf["volume"], device)
    reg_params, reg_state = reg_net.init_list(gen, conf["reg_network"], device)
    is_params, is_static = implicit_surface.init(gen, conf["implicit_surface"], device)
    params = {"feature_network": fn_params, "volume": vol_params,
              "reg_network": reg_params, "implicit_surface": is_params}
    state = {"reg_network": reg_state,
             "match_feature_network": _copy_tree(fn_params)}

    base_dim = conf.get_list("volume.base_volume_dim")[0]
    parent_caps = conf.get_list("volume.stage_parent_capacity", default=None)
    if parent_caps is None:
        child_caps = conf.get_list("volume.stage_capacity", default=None)
        parent_caps = [c // 8 for c in child_caps] if child_caps \
            else [(base_dim // 2) ** 3] * num_stage
    parent_caps = list(parent_caps)
    parent_caps[0] = (base_dim // 2) ** 3
    static = {
        "range_ratios": range_ratios,
        "num_stage": num_stage,
        "base_dim": base_dim,
        "parent_caps": parent_caps,
        "dense_unet_max_res": conf.get_int("dense_unet_max_res", default=176),
        "matching_dtype": conf.get_string("volume.matching_dtype", default="float32"),
        "matching_field": {
            "n_samples_depths": conf.get_list("matching_field.n_samples_depths"),
            "depth_res_levels": conf.get_list("matching_field.depth_res_levels"),
        },
        "implicit_surface": is_static,
    }
    return params, state, static


def _copy_tree(tree):
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_copy_tree(v) for v in tree]
    return tree.detach().clone()


def _stage_compute(params, reg_state_s, static, ipts, features, grid, sel,
                   mid_prev, depths_prev, matching_prev, *, s, training,
                   perturb, generator):
    """The differentiable body of cascade stage ``s`` given its voxel
    geometry: frustum masking, feature back-projection, the sparse U-Net,
    the dense matching volume and the matching-field depths.  Returns
    (grid, mid, depths, matching volume, stage outputs, new reg state)."""
    intrs, c2ws = ipts["intrs"], ipts["c2ws"]
    world = sp.voxel_centers_world(grid.child_coords(), grid.res)
    bp_feats, frustum = volume_mod.back_project(
        params["volume"], features, world, intrs, c2ws, s)
    del world
    cvalid = grid.cvalid & frustum
    grid = grid._replace(cvalid=cvalid)
    feats = bp_feats * cvalid[:, None].float()
    if sel is not None:
        feats = torch.cat([feats, volume_mod.upsample_feats(mid_prev, sel, cvalid)], -1)
    del bp_feats
    out, mid, reg_s = reg_net.apply(params["reg_network"][s], reg_state_s, grid, feats,
                                    training=training,
                                    dense_max_res=static["dense_unet_max_res"])
    del feats
    mdtype = getattr(torch, static["matching_dtype"])
    matching = volume_mod.matching_and_mask_volume(grid, out[:, :1].to(mdtype),
                                                   matching_prev)
    depths, occ_regs = matching_field.apply(
        static["matching_field"], ipts, matching, s, static["range_ratios"],
        None if s == 0 else depths_prev,
        grad_views_only=(s == static["num_stage"] - 1), perturb=perturb,
        generator=generator)
    src_idx = int(ipts.get("src_idx", 0))
    stage_out = {"storage": out[:, 1:].contiguous(), "depth": depths[0],
                 "depth_src": depths[src_idx], "occ_reg": occ_regs}
    return grid, mid, depths, matching, stage_out, reg_s


def build_volumes(params, state, static, ipts, features, *, training=False,
                  perturb=False, generator=None):
    """Run the cascade.  Returns (outputs, stages, matching_volume,
    new_state): ``stages`` is [(VoxelGrid, storage (P*8, C))]
    coarse-to-fine; outputs hold the per-stage depth maps; new_state the
    reg-nets' batch-norm state (updated in training).  Differentiable
    with respect to the parameters and the features when grad is on."""
    intrs, c2ws = ipts["intrs"], ipts["c2ws"]
    dev = intrs.device
    base_range = ipts["far"].reshape(-1)[0] - ipts["near"].reshape(-1)[0]
    outputs, stages, new_reg = {}, [], []
    grid = mid = depths = matching = None
    for s in range(static["num_stage"]):
        with torch.no_grad():
            if s == 0:
                grid, sel = sp.dense_base_grid(static["base_dim"], device=dev), None
            else:
                grid, sel = volume_mod.upsample_filter_geometry(
                    grid, depths.detach(), intrs, c2ws,
                    base_range * static["range_ratios"][s], static["parent_caps"][s])
        grid, mid, depths, matching, st_out, reg_s = _stage_compute(
            params, state["reg_network"][s], static, ipts, features, grid, sel,
            mid, depths, matching, s=s, training=training, perturb=perturb,
            generator=generator)
        stages.append((grid, st_out["storage"]))
        new_reg.append(reg_s)
        outputs[f"depth_stage{s}"] = st_out["depth"]
        outputs[f"depth_src_stage{s}"] = st_out["depth_src"]
        outputs[f"occ_reg_stage{s}"] = st_out["occ_reg"]
    return outputs, stages, matching, {"reg_network": new_reg}


def forward(params, state, static, ipts, *, cos_anneal_ratio=1.0, step=None,
            perturb=True, generator=None, pts_random=None):
    """Training forward over the batch's rays (the JAX package's
    ``forward(..., "train")``).  ``perturb`` jitters the matching-field
    samples, ``render.perturb`` > 0 the render's z-vals; ``generator``
    draws those numbers and the 1024 random SDF probe points, unless
    ``pts_random`` gives them.  Returns (outputs, new_state).  Its parts run
    in the spans ``train.fpn`` (both feature passes), ``train.cascade`` and
    ``train.render`` (the render and the pseudo points)."""
    with span("train.fpn"):
        features = feature_net.apply(params["feature_network"], ipts["imgs"])
    with span("train.cascade"):
        outputs, stages, matching, new_state = build_volumes(
            params, state, static, ipts, features, training=True,
            perturb=perturb, generator=generator)
    with span("train.fpn"), torch.no_grad():
        match_features = feature_net.apply(state["match_feature_network"], ipts["imgs"])
    isf = static["implicit_surface"]
    stages_ff = stages[::-1]
    with span("train.render"):
        render_out = implicit_surface.render(
            params["implicit_surface"], isf, ipts["rays_o"], ipts["rays_d"],
            ipts["near"], ipts["far"], matching, stages_ff, features[::-1],
            ipts["imgs"], ipts["intrs"], ipts["c2ws"], cos_anneal_ratio,
            generator=generator, match_features=match_features[::-1], step=step,
            pts_random=pts_random)
        outputs.update(render_out)
        if "pseudo_pts" in ipts:
            outputs["pseudo_sdf"] = implicit_surface.pseudo_sdf(
                params["implicit_surface"], isf, ipts["pseudo_pts"], stages_ff)
    outputs["active_voxels"] = torch.stack([g.cvalid.sum() for g, _ in stages])
    new_state["match_feature_network"] = state["match_feature_network"]
    return outputs, new_state


def refresh_match_features(params, state):
    """Snapshot the live feature network into the frozen copy (the
    reference's even-step refresh, surf.py:141-148)."""
    return dict(state, match_feature_network=_copy_tree(params["feature_network"]))
