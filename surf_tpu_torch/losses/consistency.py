"""Cross-view depth / coordinate reprojection consistency loss (torch
counterpart of surf_tpu/losses/consistency.py; the reference's
consistency_loss.py:5-58, whose call site is commented out at loss.py:63):
the reference depth map reprojected into the source view, the source depth
fetched there with K1, projected back; a relative depth difference (gated
at 1 %) plus the reprojection's pixel drift (gated at 1 px, weight 0.1).
Differentiable in both depth maps (K1b: d_image and d_coords)."""

from __future__ import annotations

import torch

from ..ops.grid_sample import bilinear_sample_2d
from ..ops.projection import invert_intrinsics, pixel_to_normalized


def compute_consistency_loss(ref_depth, src_depth, intrs, c2ws, src_idx, mask_ref,
                             mask_src):
    ref_intr, src_intr = intrs[0], intrs[src_idx]
    ref_c2w, src_c2w = c2ws[0], c2ws[src_idx]
    H, W = ref_depth.shape
    dev = ref_depth.device
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)], -1).reshape(-1, 3)
    ref_xy = pix[:, :2]

    cam = (pix * ref_depth.reshape(-1, 1)) @ invert_intrinsics(ref_intr).T
    world = cam @ ref_c2w[:3, :3].T + ref_c2w[:3, 3]
    src_cam = (world - src_c2w[:3, 3]) @ src_c2w[:3, :3]
    src_proj = src_cam @ src_intr[:3, :3].T
    src_xy = src_proj[:, :2] / (src_proj[:, 2:] + 1e-8)

    grid = pixel_to_normalized(src_xy, (H, W))
    warp_depth = bilinear_sample_2d(src_depth[..., None], grid, align_corners=True)[..., 0]

    src_pix = torch.cat([src_xy, torch.ones_like(src_xy[:, :1])], -1)
    back_cam = (src_pix * warp_depth[:, None]) @ invert_intrinsics(src_intr).T
    back_world = back_cam @ src_c2w[:3, :3].T + src_c2w[:3, 3]
    back_ref_cam = (back_world - ref_c2w[:3, 3]) @ ref_c2w[:3, :3]
    depth_proj = back_ref_cam[:, 2].reshape(H, W)
    back_proj = back_ref_cam @ ref_intr[:3, :3].T
    back_xy = back_proj[:, :2] / (back_proj[:, 2:] + 1e-8)

    depth_diff = (ref_depth - depth_proj).abs() / (ref_depth + 1e-8)
    depth_mask = (depth_diff < 0.01).float().detach() * mask_ref
    depth_loss = (depth_diff * depth_mask).sum() / (depth_mask.sum() + 1e-8)

    coord_diff = (ref_xy - back_xy).abs().mean(-1)
    coord_mask = (coord_diff < 1.0).float().detach() * mask_ref.reshape(-1)
    coord_loss = (coord_diff * coord_mask).sum() / (coord_mask.sum() + 1e-8)
    return depth_loss + coord_loss * 0.1
