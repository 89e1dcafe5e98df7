"""Project sample points into the source views and fetch RGB + FPN
features for the blending network (torch counterpart of
surf_tpu/ops/feature_lookup.py).  Every bilinear fetch is K1."""

from __future__ import annotations

import torch

from .grid_sample import bilinear_sample_2d, resize_bilinear_2d
from .projection import project_points_all, pixel_to_normalized, compute_ray_diff


def lookup_feature(pts, imgs, intrs, c2ws, features):
    """Per-level sampling.  pts (n, 3); imgs (nv, H, W, 3); features
    finest-first [(nv, h_i, w_i, c)].  Returns (rgb_feat (n, nsrc, 3 +
    c*L), ray_diff (n, nsrc, 4), mask (n, nsrc))."""
    src_intrs, src_c2ws = intrs[1:], c2ws[1:]
    ray_diff = compute_ray_diff(pts, c2ws[0], src_c2ws)
    warped_levels, masks, warped_rgb = [], [], None
    for i, feat in enumerate(features):
        h, w = feat.shape[1:3]
        intrs_i = src_intrs.clone()
        intrs_i[:, :2] = intrs_i[:, :2] * (0.5 ** i)
        xy, depth = project_points_all(pts, intrs_i, src_c2ws)
        m = (depth > 0) & (xy[..., 0] >= 0) & (xy[..., 0] < w) & \
            (xy[..., 1] >= 0) & (xy[..., 1] < h)
        grid = pixel_to_normalized(xy, (h, w))
        warped = bilinear_sample_2d(feat[1:], grid, align_corners=False)
        warped_levels.append(warped.transpose(0, 1))
        masks.append(m.transpose(0, 1))
        if i == 0:
            rgb = bilinear_sample_2d(imgs[1:], grid, align_corners=False)
            warped_rgb = rgb.transpose(0, 1)
    mask = torch.stack(masks, dim=-1).all(dim=-1)
    rgb_feat = torch.cat([warped_rgb] + warped_levels, dim=-1)
    return rgb_feat, ray_diff, mask


def fuse_pyramid(imgs, features):
    """RGB + every pyramid level bilinearly upsampled to the finest
    resolution, once per scene: (nv, H, W, 3 + c*L)."""
    hw = features[0].shape[1:3]
    ups = [imgs, features[0]] + [resize_bilinear_2d(f, hw) for f in features[1:]]
    return torch.cat(ups, dim=-1)


def lookup_feature_fused(pts, fused, intrs, c2ws, hw_levels):
    """``lookup_feature`` over a ``fuse_pyramid`` image: one K1 fetch per
    source view; per-level visibility from the scaled pixel coordinates."""
    src_intrs, src_c2ws = intrs[1:], c2ws[1:]
    h, w = fused.shape[1:3]
    ray_diff = compute_ray_diff(pts, c2ws[0], src_c2ws)
    xy, depth = project_points_all(pts, src_intrs, src_c2ws)
    grid = pixel_to_normalized(xy, (h, w))
    rgb_feat = bilinear_sample_2d(fused[1:], grid,
                                  align_corners=False).transpose(0, 1)
    mask = depth > 0
    for i, (hi, wi) in enumerate(hw_levels):
        sc = 0.5 ** i
        xi, yi = xy[..., 0] * sc, xy[..., 1] * sc
        mask = mask & (xi >= 0) & (xi < wi) & (yi >= 0) & (yi < hi)
    return rgb_feat, ray_diff, mask.transpose(0, 1)
