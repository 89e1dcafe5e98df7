"""Homography patch warping at surface points (torch counterpart of
surf_tpu/ops/homography.py): at each surface point, with its unit normal
in the reference camera frame, the plane-induced homographies

    H_i = K_i (R_i^T R_0 + (R_i^T (C_0 - C_i)) n^T / (n . x_ref)) K_0^{-1}

map a ``patch_size`` x ``patch_size`` pixel patch around the point's
reference projection into every source view.  Both patches are fetched
with K1 (align_corners=True); the source fetch is differentiable in the
point (K1b's coordinate gradient), the reference one is held fixed.
"""

from __future__ import annotations

import torch

from .grid_sample import bilinear_sample_2d
from .projection import invert_intrinsics


def surface_patch_warp(pts, normals_ref, images, intrs, c2ws, patch_size=11):
    """pts (n, 3) world points; normals_ref (n, 3) unit normals in the
    reference camera frame; images (nv, H, W, C) feature images (view 0
    the reference); intrs, c2ws (nv, 4, 4).  Returns (ref_patches
    (n, p*p, C), src_patches (nsrc, n, p*p, C))."""
    H_img, W_img = images.shape[1:3]
    K_ref = intrs[0, :3, :3]
    K_ref_inv = invert_intrinsics(intrs[0])
    K_src = intrs[1:, :3, :3]
    R0, C0 = c2ws[0, :3, :3], c2ws[0, :3, 3]
    R_src_T = c2ws[1:, :3, :3].transpose(1, 2)
    C_src = c2ws[1:, :3, 3]

    pts_ref = (pts - C0) @ R0                          # R0^T (x - C0)
    proj = pts_ref @ K_ref.T
    px = proj[:, 0] / (proj[:, 2] + 1e-8)
    py = proj[:, 1] / (proj[:, 2] + 1e-8)
    disp = (normals_ref * pts_ref).sum(-1)

    R_rel = torch.einsum("sij,jk->sik", R_src_T, R0)
    t_rel = torch.einsum("sij,sj->si", R_src_T, C0[None] - C_src)
    outer = t_rel[None, :, :, None] * normals_ref[:, None, None, :]
    M = R_rel[None] + outer / (disp[:, None, None, None] + 1e-10)
    Hom = torch.einsum("sij,nsjk,kl->nsil", K_src, M, K_ref_inv)

    hp = patch_size // 2
    offs = torch.arange(-hp, hp + 1, dtype=pts.dtype, device=pts.device)
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")
    offsets = torch.stack([ox.reshape(-1), oy.reshape(-1)], -1)   # (p*p, 2) x, y
    patch_xy = torch.stack([px, py], -1)[:, None, :] + offsets[None]
    homo = torch.cat([patch_xy, torch.ones_like(patch_xy[..., :1])], -1)
    warped = torch.einsum("nsij,npj->nspi", Hom, homo)
    grid = warped[..., :2] / (warped[..., 2:] + 1e-8)

    def norm_grid(g):
        return torch.stack([2.0 * g[..., 0] / (W_img - 1) - 1.0,
                            2.0 * g[..., 1] / (H_img - 1) - 1.0], -1)

    src_patches = bilinear_sample_2d(images[1:], norm_grid(grid).transpose(0, 1),
                                     align_corners=True)
    ref_patches = bilinear_sample_2d(images[0].detach(), norm_grid(patch_xy).detach(),
                                     align_corners=True)
    return ref_patches, src_patches
