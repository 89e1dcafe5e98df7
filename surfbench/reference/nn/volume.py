"""Sparse volume construction (torch counterpart of surf_tpu/nn/volume.py):
multi-scale feature back-projection with view attention, the upsample ->
depth-filter -> compact step of the cascade, and the reference's unused
geometric-consistency variant of the filter.  Every image fetch is K1
(align_corners=True here, as in the reference)."""

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


def geocheck_depths(depths, intrs, c2ws):
    """Cross-view geometric-consistency masking of the rendered depth maps
    (the reference's unused ``depth_filtering_geocheck`` pre-filter,
    volume.py:170-208): each view's depth is reprojected into every view,
    sampled there with K1 and projected back; a pixel keeps its depth where
    the round trip agrees in relative depth (< 0.3) and in image distance
    (< 5 px) with more than one view, and is zeroed otherwise, but only
    when that keeps more than 1 % of the pixels.  depths (nv, H, W) ->
    (nv, H, W)."""
    nv, H, W = depths.shape
    dev = depths.device
    y, x = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    xy1 = torch.stack([x.reshape(-1), y.reshape(-1),
                       torch.ones(H * W, dtype=torch.float32, device=dev)])   # (3, hw)
    K = intrs[:, :3, :3]
    K_inv = torch.linalg.inv(K)
    w2c = torch.linalg.inv(c2ws)

    # each reference view's depth unprojected to the world
    cam = torch.einsum("vij,jn->vin", K_inv, xy1) * depths.reshape(nv, 1, -1)
    world = torch.einsum("vij,vjn->vin", c2ws, torch.cat([cam, torch.ones_like(cam[:, :1])], 1))
    # into every source view s: (s, v, ...)
    src_cam = torch.einsum("sij,vjn->svin", w2c, world)[:, :, :3]
    src_xyz = torch.einsum("sij,svjn->svin", K, src_cam)
    src_xy = src_xyz[:, :, :2] / (src_xyz[:, :, 2:] + 1e-8)           # (s, v, 2, hw)
    grid = torch.stack([src_xy[:, :, 0] / ((W - 1) / 2) - 1,
                        src_xy[:, :, 1] / ((H - 1) / 2) - 1], -1)     # (s, v, hw, 2)
    warp = bilinear_sample_2d(depths[..., None], grid.reshape(nv, nv * H * W, 2),
                              align_corners=True)[..., 0].reshape(nv, nv, H * W)

    # the source samples lifted back to the world and into the reference camera
    xyz_src = torch.cat([src_xy, torch.ones_like(src_xy[:, :, :1])], 2) * warp[:, :, None]
    back_cam = torch.einsum("sij,svjn->svin", K_inv, xyz_src)
    back_w = torch.einsum("sij,svjn->svin", c2ws,
                          torch.cat([back_cam, torch.ones_like(back_cam[:, :, :1])], 2))
    ref_cam = torch.einsum("vij,svjn->vsin", w2c, back_w)[:, :, :3]  # (v, s, 3, hw)
    depth_proj = ref_cam[:, :, 2].reshape(nv, nv, H, W)
    proj_xyz = torch.einsum("vij,vsjn->vsin", K, ref_cam)
    proj_xy = proj_xyz[:, :, :2] / (proj_xyz[:, :, 2:] + 1e-8)

    d = depths[:, None]
    depth_ok = (d - depth_proj).abs() / d.clamp(min=1e-8) < 0.3
    coord_ok = torch.sqrt(((xy1[None, None, :2] - proj_xy) ** 2).sum(2)
                          ).reshape(nv, nv, H, W) < 5.0
    geomask = (depth_ok & coord_ok).sum(1) > 1
    use = geomask.float().mean() > 0.01
    return torch.where(use, depths * geomask.to(depths.dtype), depths)


def depth_consistency_geocheck(world_pts, cand_valid, depths, intrs, c2ws, stage_range):
    """``depth_consistency`` against the ``geocheck_depths``-masked depth
    maps (the reference's unused ``depth_filtering_geocheck``,
    volume.py:170-238): a zeroed pixel cannot validate a voxel (its
    ``warp_depths > 0`` term).  Returns (count (N,), keep = count > 1 &
    valid)."""
    masked = geocheck_depths(depths.detach(), intrs, c2ws)
    nv, H, W = depths.shape
    xy, depth = project_points_all(world_pts, intrs, c2ws)
    grid = pixel_to_normalized(xy, (H, W))
    mask = in_frustum_mask(xy, depth, (H, W), inclusive=True)
    warp = bilinear_sample_2d(masked[..., None], grid, align_corners=True)[..., 0]
    ok = ((warp - depth).abs() < stage_range) & mask & (warp > 0)
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


def upsample_and_filter(prev_grid: sp.VoxelGrid, prev_mid, depths, intrs, c2ws,
                        stage_range, parent_cap: int):
    """The previous stage's voxels subdivided 2x, the children consistent
    with the rendered depths kept, the surviving parents compacted into
    ``parent_cap``, and ``prev_mid`` (P_prev*8, c) broadcast to their
    children.  Returns (new_grid, up_feats (parent_cap*8, c))."""
    grid, sel = upsample_filter_geometry(prev_grid, depths, intrs, c2ws, stage_range,
                                         parent_cap)
    return grid, upsample_feats(prev_mid, sel, grid.cvalid)


def matching_and_mask_volume(grid: sp.VoxelGrid, density, prev_matching=None):
    """Dense matching volume (R, R, R, 1): 2x trilinear upsampling of the
    previous stage's volume as background, active voxels overwritten."""
    bg = upsample_trilinear_x2(prev_matching) if prev_matching is not None else None
    return sp.scatter_to_dense(grid, density, background=bg)
