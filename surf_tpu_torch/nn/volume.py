"""Sparse volume construction (torch counterpart of surf_tpu/nn/volume.py):
multi-scale feature back-projection with view attention, and the
upsample -> depth-filter -> compact step of the cascade.  Every image
fetch is K1 (align_corners=True here, as in the reference)."""

from __future__ import annotations

import torch

from .core import linear_init, linear_apply, elu
from ..ops.grid_sample import bilinear_sample_2d, upsample_trilinear_x2
from ..ops.projection import (project_points_all, pixel_to_normalized,
                              in_frustum_mask)
from ..ops import sparse as sp


def init(gen, conf, device=None):
    return {"agg_mlp": [linear_init(gen, 4, 8, device=device),
                        linear_init(gen, 8, 1, device=device)]}


def back_project(params, features, world_pts, intrs, c2ws, stage_idx):
    """features: [(nv, h_s, w_s, c)] low-res -> high-res; world_pts (N, 3).
    Returns (feat (N, 2c) = [attention mean, reference variance form],
    frustum (N,) bool: seen by more than one view)."""
    h, w = features[-1].shape[1:3]
    xy, depth = project_points_all(world_pts, intrs, c2ws)    # (nv, N, ...)
    # normalization uses the finest feature resolution (volume.py:62,73-74)
    grid = pixel_to_normalized(xy, (h, w))
    mask = in_frustum_mask(xy, depth, (h, w), inclusive=True)
    warp = None
    for f in features[stage_idx:]:
        s = bilinear_sample_2d(f, grid, align_corners=True)     # (nv, N, c)
        warp = s if warp is None else warp + s
    x = linear_apply(params["agg_mlp"][1],
                     elu(linear_apply(params["agg_mlp"][0], warp)))
    x = torch.where(mask[..., None], x, torch.full_like(x, -1e9))
    wgt = torch.softmax(x, dim=0)
    fw = warp * wgt
    mean = fw.sum(0)
    # the reference's variance form sum((f w)^2) - (sum f w)^2 (volume.py:93)
    var = (fw ** 2).sum(0) - mean ** 2
    return torch.cat([mean, var], dim=-1), mask.sum(0) > 1


def depth_consistency(world_pts, cand_valid, depths, intrs, c2ws, stage_range):
    """Per-voxel count of views whose rendered depth (sampled with K1)
    matches the voxel's projected depth within ``stage_range``.
    depths (nv, H, W).  Returns (count (N,), keep = count > 1 & valid)."""
    nv, H, W = depths.shape
    xy, depth = project_points_all(world_pts, intrs, c2ws)
    grid = pixel_to_normalized(xy, (H, W))
    mask = in_frustum_mask(xy, depth, (H, W), inclusive=True)
    warp = bilinear_sample_2d(depths[..., None], grid, align_corners=True)[..., 0]
    ok = ((warp - depth).abs() < stage_range) & mask
    counts = ok.sum(0)
    return counts, (counts > 1) & cand_valid


def upsample_filter_geometry(prev_grid: sp.VoxelGrid, depths, intrs, c2ws,
                             stage_range, parent_cap: int):
    """2x subdivision of the previous stage + depth filter + compaction into
    ``parent_cap`` parents.  Returns (new_grid, sel (parent_cap,))."""
    res_new = prev_grid.res * 2
    cand_parents = prev_grid.child_coords()
    cand_pvalid = prev_grid.cvalid
    off = sp.child_offsets(cand_parents.device)
    children = (cand_parents[:, None, :] * 2 + off[None]).reshape(-1, 3)
    world = sp.voxel_centers_world(children, res_new)
    cand_cvalid = cand_pvalid.repeat_interleave(8)
    _, keep = depth_consistency(world, cand_cvalid, depths, intrs, c2ws,
                                stage_range)
    keep8 = keep.reshape(-1, 8)
    score = keep8.sum(1).float()
    pvalid = (score > 0) & cand_pvalid
    sel, sel_valid = sp.compact_parents(score, pvalid, parent_cap)
    cvalid = keep8[sel] & sel_valid[:, None]
    return sp.make_grid(cand_parents[sel], sel_valid, cvalid, res_new), sel


def upsample_feats(prev_mid, sel, cvalid):
    """The selected parents' mid-features broadcast to their 8 children."""
    up = prev_mid[sel].repeat_interleave(8, dim=0)
    return up * cvalid[:, None].to(up.dtype)


def matching_and_mask_volume(grid: sp.VoxelGrid, density, prev_matching=None):
    """Dense matching volume (R, R, R, 1): 2x trilinear upsampling of the
    previous stage's volume as background, active voxels overwritten."""
    bg = upsample_trilinear_x2(prev_matching) if prev_matching is not None else None
    return sp.scatter_to_dense(grid, density, background=bg)
