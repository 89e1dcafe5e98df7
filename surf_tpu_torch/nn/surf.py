"""SuRF composite model: FPN features -> sparse volume cascade (torch
counterpart of surf_tpu/nn/surf.py, inference).

``build_volumes`` runs the cascade: per stage it (1) upsamples and
depth-filters the voxel set (stage 0 is the dense base grid), (2)
back-projects the multi-scale features with view attention, (3)
regularizes with the sparse U-Net, (4) scatters channel 0 into the dense
matching volume (seeded by the upsampled previous one, in
``volume.matching_dtype``) and keeps channels 1: as the stage's feature
storage, (5) renders per-view matching-field depths that drive the next
stage's sparsification.
"""

from __future__ import annotations

import torch

from . import feature_net, reg_net, matching_field, implicit_surface
from . import volume as volume_mod
from ..ops import sparse as sp


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
    state = {"reg_network": reg_state}

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


@torch.no_grad()
def build_volumes(params, state, static, ipts, features):
    """Run the cascade (no perturbation).  Returns (outputs, stages,
    matching_volume): ``stages`` is [(VoxelGrid, storage (P*8, C))]
    coarse-to-fine; outputs hold the per-stage depth maps."""
    intrs, c2ws = ipts["intrs"], ipts["c2ws"]
    dev = intrs.device
    base_range = ipts["far"].reshape(-1)[0] - ipts["near"].reshape(-1)[0]
    mdtype = getattr(torch, static["matching_dtype"])
    outputs, stages = {}, []
    grid = mid = depths = matching = None
    num_stage = static["num_stage"]
    for s in range(num_stage):
        if s == 0:
            grid = sp.dense_base_grid(static["base_dim"], device=dev)
            sel = None
        else:
            stage_range = base_range * static["range_ratios"][s]
            grid, sel = volume_mod.upsample_filter_geometry(
                grid, depths, intrs, c2ws, stage_range, static["parent_caps"][s])
        world = sp.voxel_centers_world(grid.child_coords(), grid.res)
        bp_feats, frustum = volume_mod.back_project(
            params["volume"], features, world, intrs, c2ws, s)
        del world
        cvalid = grid.cvalid & frustum
        grid = grid._replace(cvalid=cvalid)
        feats = bp_feats * cvalid[:, None].float()
        if sel is not None:
            feats = torch.cat([feats, volume_mod.upsample_feats(mid, sel, cvalid)], -1)
        del bp_feats
        out, mid = reg_net.apply(params["reg_network"][s], state["reg_network"][s],
                                 grid, feats, dense_max_res=static["dense_unet_max_res"])
        del feats
        matching = volume_mod.matching_and_mask_volume(
            grid, out[:, :1].to(mdtype), matching)
        depths, occ_regs = matching_field.apply(
            static["matching_field"], ipts, matching, s, static["range_ratios"],
            None if s == 0 else depths, grad_views_only=(s == num_stage - 1))
        stages.append((grid, out[:, 1:].contiguous()))
        src_idx = int(ipts.get("src_idx", 0))
        outputs[f"depth_stage{s}"] = depths[0]
        outputs[f"depth_src_stage{s}"] = depths[src_idx]
        outputs[f"occ_reg_stage{s}"] = occ_regs
    return outputs, stages, matching
